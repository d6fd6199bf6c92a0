"""Rank groups: ``torch.distributed`` formation, collectives and readiness —
port of ``seldon_tpu/parallel/distributed.py``.

The JAX module forms a multi-host slice (``jax.distributed``) from the
env the reconciler injects; the port keeps that env contract
(:func:`slice_config_from_env`, :func:`pod_ordinal`) and forms a
``torch.distributed`` process group instead (:func:`ensure_initialized`,
``tcp://{coordinator}``). One process runs per rank.

:class:`RankGroup` is one process's handle on a group: its rank, every
rank's device, and the collectives the exact-TP scheme and ring
attention need. Its route is picked from the device list, never from an
exception:
 * every rank on the CPU: gloo on the tensors themselves;
 * every rank on its own card: NCCL;
 * ranks that share a card: gloo, each transfer staged explicitly
   through host buffers (NCCL refuses two ranks on one device, and gloo
   takes CPU tensors only for most of its collectives).
Every collective moves bytes only (tensors travel as ``uint8`` views),
so a gather is exact in every dtype; a sum (:meth:`RankGroup.all_reduce`,
:meth:`RankGroup.reduce_scatter`) is an exact gather followed by an f32
sum in rank order, rounded once to the tensor's dtype, so every rank of
the group gets the same bits on every route. The group is created with a
timeout: a rank that died or hung surfaces as an error on the others
within it.

Training (``models/train.py``) runs on a mesh of ranks: :class:`MeshRanks`
holds one :class:`RankGroup` per mesh axis (and per set of axes the
training route reduces over) at this rank's coordinate, and the
autograd functions at the end of this module (:func:`copy_to`,
:func:`reduce_from`, :func:`all_reduce_sum`, :func:`gather_along`,
:func:`gather_replicated`, :func:`ring_pass`) are the collectives the
route differentiates through, each with its transpose as backward.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
import re
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.parallel.mesh import AXES

logger = logging.getLogger(__name__)

ENV_HOSTNAMES_SVC = "TPU_WORKER_HOSTNAMES_SVC"
ENV_WORKER_COUNT = "TPU_WORKER_COUNT"
ENV_COORDINATOR_PORT = "TPU_COORDINATOR_PORT"
DEFAULT_COORDINATOR_PORT = 8476

# Seconds a collective may wait for a peer before it raises.
DEFAULT_TIMEOUT_S = 120.0


@dataclasses.dataclass(frozen=True)
class SliceConfig:
    coordinator: str
    num_processes: int
    process_id: int


def pod_ordinal(hostname: Optional[str] = None) -> Optional[int]:
    """StatefulSet pods are named <set>-<ordinal>."""
    hostname = hostname if hostname is not None else os.environ.get(
        "HOSTNAME", ""
    )
    m = re.match(r"^(.*)-(\d+)$", hostname)
    return int(m.group(2)) if m else None


def slice_config_from_env(environ=None) -> Optional[SliceConfig]:
    """None on single-host (env absent or worker count 1)."""
    env = environ if environ is not None else os.environ
    svc = env.get(ENV_HOSTNAMES_SVC, "")
    count = int(env.get(ENV_WORKER_COUNT, "1"))
    if not svc or count <= 1:
        return None
    hostname = env.get("HOSTNAME", "")
    ordinal = pod_ordinal(hostname)
    if ordinal is None:
        raise RuntimeError(
            f"{ENV_HOSTNAMES_SVC} set but HOSTNAME {hostname!r} carries no "
            "StatefulSet ordinal"
        )
    m = re.match(r"^(.*)-(\d+)$", hostname)
    setname = m.group(1)
    port = int(env.get(ENV_COORDINATOR_PORT, DEFAULT_COORDINATOR_PORT))
    # Pod 0's stable DNS identity under the headless service.
    coordinator = f"{setname}-0.{svc}:{port}"
    return SliceConfig(
        coordinator=coordinator, num_processes=count, process_id=ordinal
    )


def route_for(devices: Sequence[DeviceLike]) -> str:
    """The transport of a group whose rank r runs on ``devices[r]``:
    ``"gloo"`` (all CPU), ``"nccl"`` (one card per rank) or ``"staged"``
    (ranks sharing a card: gloo through host buffers)."""
    devs = [torch.device(d) for d in devices]
    types = {d.type for d in devs}
    if types == {"cpu"}:
        return "gloo"
    if types != {"cuda"}:
        raise ValueError(
            f"a rank group runs on CPUs only or on cards only, got "
            f"{[str(d) for d in devs]}")
    idx = [d.index for d in devs]
    if None in idx:
        raise ValueError(
            f"name each rank's card with its index (cuda:N), got "
            f"{[str(d) for d in devs]}")
    return "nccl" if len(set(idx)) == len(idx) else "staged"


def _backend(route: str) -> str:
    return "nccl" if route == "nccl" else "gloo"


def init_group(rank: int, devices: Sequence[DeviceLike], init_method: str,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> "RankGroup":
    """Join the process group of ``len(devices)`` ranks as ``rank``, on
    the backend the device list picks, and return this rank's handle."""
    devs = [torch.device(d) for d in devices]
    route = route_for(devs)
    dev = devs[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {}
    if route == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(
        _backend(route), init_method=init_method, world_size=len(devs),
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return RankGroup(rank, devs, timeout_s)


def ensure_initialized(cfg: Optional[SliceConfig] = None,
                       device: DeviceLike = None,
                       timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Join the slice if configured; True when running multi-host.
    Idempotent: subsequent calls are no-ops. The backend follows this
    rank's device: NCCL on a card, gloo on the CPU. ``device=None`` is
    the current card, and raises when there is none; pass ``"cpu"`` to
    join on the CPU."""
    if dist.is_available() and dist.is_initialized():
        return True
    if cfg is None:
        cfg = slice_config_from_env()
    if cfg is None:
        return False
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ensure_initialized: no CUDA device is available; pass "
                "device='cpu' to join the slice on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    logger.info(
        "joining slice: coordinator=%s process %d/%d on %s",
        cfg.coordinator, cfg.process_id, cfg.num_processes, dev,
    )
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{cfg.coordinator}",
        world_size=cfg.num_processes, rank=cfg.process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    return True


class SliceReadiness:
    """Slice-as-one-replica readiness: ready only once every host has
    joined (the group's world size == expected) and this rank has its
    device."""

    def __init__(self, expected_hosts: Optional[int] = None,
                 device: DeviceLike = None):
        if expected_hosts is None:
            expected_hosts = int(os.environ.get(ENV_WORKER_COUNT, "1"))
        self.expected_hosts = expected_hosts
        self.device = torch.device(device) if device is not None else None

    def check(self) -> None:
        """Raises RuntimeError when not ready (wrapper health_status
        contract: exceptions -> 503)."""
        if self.expected_hosts > 1:
            have = (dist.get_world_size()
                    if dist.is_available() and dist.is_initialized() else 0)
            if have < self.expected_hosts:
                raise RuntimeError(
                    f"slice forming: {have}/{self.expected_hosts} hosts"
                )
        dev = self.device
        if dev is None or dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no local accelerator devices")


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous uint8 tensor (the last dim times the element
    size): what the transports move."""
    return x.contiguous().view(torch.uint8)


class RankGroup:
    """This process's handle on a group of ``world`` ranks (rank r runs
    on ``devices[r]``), created by :func:`init_group` (the whole world)
    or by :class:`MeshRanks` (one axis of a mesh: ``pg`` is its process
    group and ``members`` the world ranks of its ranks, in group order).
    A group of one rank makes no call at all: every collective returns
    its input.

    Collectives count their calls and the host seconds they take
    (``gathers``, ``gather_s``); on the staged route ``wait_s`` is the
    time spent waiting for the card's queued work before a transfer
    (the staging needs the values on the host), kept apart from the
    transfer itself."""

    def __init__(self, rank: int, devices: Sequence[torch.device],
                 timeout_s: float, pg=None,
                 members: Optional[Sequence[int]] = None,
                 route: Optional[str] = None):
        self.rank = int(rank)
        self.devices: List[torch.device] = list(devices)
        self.world = len(self.devices)
        self.device = self.devices[self.rank]
        self.route = route or route_for(self.devices)
        self.timeout_s = float(timeout_s)
        self.pg = pg
        self.members = (list(members) if members is not None
                        else list(range(self.world)))
        self.gathers = 0
        self.gather_s = 0.0
        self.wait_s = 0.0

    @classmethod
    def solo(cls, device: DeviceLike = None) -> "RankGroup":
        """A group of one rank on ``device`` (``cuda`` unless named): no
        process group, every collective the identity."""
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return cls(0, [dev], DEFAULT_TIMEOUT_S)

    def describe(self) -> dict:
        return {"rank": self.rank, "world": self.world,
                "route": self.route, "backend": _backend(self.route),
                "devices": [str(d) for d in self.devices]}

    def reset_counters(self) -> None:
        self.gathers = 0
        self.gather_s = 0.0
        self.wait_s = 0.0

    def _to_host(self, x: torch.Tensor, pinned: bool = True) -> torch.Tensor:
        """Staged route: wait for the card's queued work (counted in
        ``wait_s``), then copy ``x``'s bytes into a host buffer (pinned
        for the per-layer gathers, whose sizes repeat; pageable for the
        one-off weight transfers)."""
        t0 = time.perf_counter()
        torch.cuda.current_stream(x.device).synchronize()
        self.wait_s += time.perf_counter() - t0
        host = torch.empty(x.numel() * x.element_size(), dtype=torch.uint8,
                           pin_memory=pinned)
        host.copy_(_bytes(x).reshape(-1))
        return host

    def _parts(self, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (one shape and dtype on every rank), in rank
        order, on ``x``'s device: the exact gather every collective but
        the point-to-point ones is built on (one call counted)."""
        shape, dtype = x.shape, x.dtype
        x = x.reshape(-1)  # a 0-d tensor has no byte view
        t0 = time.perf_counter()
        if self.route == "nccl":
            raw = _bytes(x)
            out = torch.empty((self.world, raw.numel()), dtype=torch.uint8,
                              device=x.device)
            dist.all_gather_into_tensor(out, raw, group=self.pg)
            raws = list(out.unbind(0))
        elif self.route == "staged":
            host = self._to_host(x)
            t0 = time.perf_counter()
            bufs = [torch.empty_like(host) for _ in range(self.world)]
            dist.all_gather(bufs, host, group=self.pg)
            raws = [b.to(x.device, non_blocking=True) for b in bufs]
        else:
            raw = _bytes(x)
            raws = [torch.empty_like(raw) for _ in range(self.world)]
            dist.all_gather(raws, raw, group=self.pg)
        self.gathers += 1
        self.gather_s += time.perf_counter() - t0
        return [r.view(dtype).reshape(shape) for r in raws]

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on the last axis in rank order
        (the exact all-gather in front of a replicated contraction)."""
        if self.world == 1:
            return x
        return torch.cat(self._parts(x), dim=-1)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim`` in rank order."""
        if dim in (-1, x.dim() - 1):
            return self.all_gather_last(x)
        return self.all_gather_last(x.movedim(dim, -1)).movedim(-1, dim)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``: the exact gather, then an f32 sum
        in rank order rounded once to ``x``'s dtype (the same bits on
        every rank and every route)."""
        if self.world == 1:
            return x
        parts = self._parts(x)
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        return acc.to(x.dtype)

    def reduce_scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous part (``x.shape[dim] / world`` wide, in
        rank order) of the sum of every rank's ``x``, summed as
        :meth:`all_reduce` sums."""
        if self.world == 1:
            return x
        n = x.shape[dim]
        if n % self.world:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{self.world} ways")
        w = n // self.world
        parts = [p.narrow(dim, self.rank * w, w) for p in self._parts(x)]
        acc = parts[0].float()
        for p in parts[1:]:
            acc = acc + p.float()
        return acc.to(x.dtype)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank (the others pass a tensor of
        its shape and dtype), on this rank's device."""
        if self.world == 1:
            return x
        peer = self.members[src]
        shape = x.shape
        x = x.reshape(-1)  # a 0-d tensor has no byte view
        if self.route == "nccl":
            buf = _bytes(x).clone()
            dist.broadcast(buf, peer, group=self.pg)
        elif self.route == "staged":
            buf = self._to_host(x, pinned=False)
            dist.broadcast(buf, peer, group=self.pg)
            buf = buf.to(self.device)
        else:
            buf = _bytes(x).clone()
            dist.broadcast(buf, peer, group=self.pg)
        self.gathers += 1
        return buf.view(x.dtype).reshape(shape)

    def exchange(self, x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """Send ``x`` to rank ``to`` and receive a tensor of its shape and
        dtype from rank ``frm`` (one hop of a ring)."""
        t0 = time.perf_counter()
        to, frm = self.members[to], self.members[frm]
        if self.route == "nccl":
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x.contiguous(), to, self.pg),
                   dist.P2POp(dist.irecv, out, frm, self.pg)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        else:
            src = (self._to_host(x) if self.route == "staged"
                   else _bytes(x).reshape(-1))
            t0 = time.perf_counter()
            buf = torch.empty_like(src)
            works = [dist.isend(src, to, group=self.pg),
                     dist.irecv(buf, frm, group=self.pg)]
            for w in works:
                w.wait()
            out = buf.view(x.dtype).reshape(x.shape)
            if self.route == "staged":
                out = out.to(x.device, non_blocking=True)
        self.gathers += 1
        self.gather_s += time.perf_counter() - t0
        return out

    def send(self, x: torch.Tensor, dst: int) -> None:
        """Point-to-point send of ``x``'s bytes to rank ``dst``."""
        dst = self.members[dst]
        if self.route == "nccl":
            dist.send(_bytes(x), dst, group=self.pg)
        elif self.route == "staged":
            dist.send(self._to_host(x, pinned=False), dst, group=self.pg)
        else:
            dist.send(_bytes(x).reshape(-1), dst, group=self.pg)

    def recv(self, shape, dtype: torch.dtype, src: int) -> torch.Tensor:
        """Receive a ``shape``/``dtype`` tensor sent by rank ``src`` with
        :meth:`send`, on this rank's device."""
        src = self.members[src]
        n = int(torch.Size(shape).numel()) * torch.empty(
            (), dtype=dtype).element_size()
        if self.route == "nccl":
            buf = torch.empty(n, dtype=torch.uint8, device=self.device)
            dist.recv(buf, src, group=self.pg)
        else:
            buf = torch.empty(n, dtype=torch.uint8)
            dist.recv(buf, src, group=self.pg)
        out = buf.view(dtype).reshape(shape)
        return out.to(self.device) if self.route == "staged" else out

    def close(self) -> None:
        """Leave the group (every rank calls it)."""
        if dist.is_initialized():
            dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Meshes of ranks (training)
# ---------------------------------------------------------------------------

# The sets of axes a rank holds a group for: every axis, and the sets the
# training route reduces over (the loss and the gradients over dp x sp,
# with pp for leaves replicated over the stages; the MoE experts' input
# over ep x tp).
AXIS_SETS = (("dp",), ("pp",), ("sp",), ("ep",), ("tp",), ("dp", "sp"),
             ("dp", "pp", "sp"), ("ep", "tp"))
# The sets a serving group holds (``servers/mesh_engine.py``): the dp
# replicas, the ring over sp and the exact-TP gathers over tp.
SERVING_SETS = (("dp",), ("sp",), ("tp",))


class MeshRanks:
    """One rank's place on a mesh: its coordinate on every axis
    (``coord``) and one :class:`RankGroup` per set of axes in
    :data:`AXIS_SETS` (:meth:`group`), made of the ranks that share its
    coordinate on every other axis.

    Rank r of the world is the device at flat index r of JAX's
    ``make_mesh`` grid (``devices.reshape(dp, pp, sp, ep, tp)``, tp
    innermost), so a group's ranks are the devices JAX's mesh puts on
    that axis, in its order (for a set of axes, the first axis major).
    Every rank of the world must build its ``MeshRanks`` together, over
    the same ``sets`` (a subset of :data:`AXIS_SETS`):
    ``dist.new_group`` is called for every group of every set, in one
    order, on every rank. A group of one rank gets no process group, and
    a group of the whole world is ``world`` itself (its process group
    and its counters), so a caller that holds the world runs the same
    collectives as the ranks that hold the axis."""

    def __init__(self, mesh, world: RankGroup,
                 sets: Sequence[Tuple[str, ...]] = AXIS_SETS):
        names = tuple(mesh.axis_names)
        if names != AXES:
            raise ValueError(f"mesh axes {names}, expected {AXES}")
        sizes = [int(mesh.shape[a]) for a in AXES]
        if math.prod(sizes) != world.world:
            raise ValueError(f"a mesh of {math.prod(sizes)} ranks needs a "
                             f"world of as many, got {world.world}")
        self.mesh = mesh
        self.world = world
        self.sizes: Dict[str, int] = dict(zip(AXES, sizes))
        grid = np.arange(world.world).reshape(sizes)
        self.coord: Dict[str, int] = {
            a: int(c) for a, c in zip(
                AXES, np.unravel_index(world.rank, sizes))}
        timeout = datetime.timedelta(seconds=world.timeout_s)
        self._groups: Dict[Tuple[str, ...], RankGroup] = {}
        for axes in sets:
            if axes not in AXIS_SETS:
                raise ValueError(f"no axis set {axes}; the sets are "
                                 f"{AXIS_SETS}")
            dims = [AXES.index(a) for a in axes]
            rest = [d for d in range(len(AXES)) if d not in dims]
            width = math.prod(sizes[d] for d in dims)
            rows = grid.transpose(rest + dims).reshape(-1, width)
            for row in rows.tolist():
                if row == list(range(world.world)):
                    self._groups[axes] = world
                    continue
                pg = (dist.new_group(row, timeout=timeout)
                      if width > 1 else None)
                if world.rank in row:
                    self._groups[axes] = RankGroup(
                        row.index(world.rank),
                        [world.devices[r] for r in row], world.timeout_s,
                        pg=pg, members=row, route=world.route)

    @classmethod
    def single(cls, mesh, device: DeviceLike = None) -> "MeshRanks":
        """The one rank of a one-device mesh, on ``device``."""
        return cls(mesh, RankGroup.solo(device))

    @property
    def device(self) -> torch.device:
        return self.world.device

    def group(self, *axes: str) -> RankGroup:
        """The group over ``axes`` (in any order) at this coordinate."""
        key = tuple(a for a in AXES if a in axes)
        if key not in self._groups:
            raise KeyError(f"no group over {axes}; this rank holds "
                           f"{tuple(self._groups)}")
        return self._groups[key]

    def size(self, axis: str) -> int:
        return self.sizes[axis]


# ---------------------------------------------------------------------------
# Differentiable collectives (training)
# ---------------------------------------------------------------------------
#
# Two conventions meet on the training route. Over dp, sp and pp every
# rank's loss is a PART of the global loss (its rows, its block of the
# sequence, its stage), so a collective's backward is its transpose in
# the sum-of-parts sense (a gather's is a reduce-scatter, a sum's is a
# sum). Over tp and ep every rank holds the SAME loss, and Megatron's
# pair applies: f is the identity forward and a sum backward, g a sum
# forward and the identity backward.


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous()), None


class _GatherAlong(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.reduce_scatter(g.contiguous(), ctx.dim), None, None


class _GatherReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return group.all_gather(x.contiguous(), dim)

    @staticmethod
    def backward(ctx, g):
        w = g.shape[ctx.dim] // ctx.group.world
        return (g.narrow(ctx.dim, ctx.group.rank * w, w).contiguous(), None,
                None)


def copy_to(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Megatron's f over ``group`` (tp, ep): the identity forward, the sum
    of every rank's gradient backward. Put it in front of a
    column-parallel product whose input every rank holds whole."""
    return x if group.world == 1 else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """Megatron's g over ``group`` (tp, ep): the sum of every rank's
    partial result forward, the identity backward. Put it after a
    row-parallel product."""
    return x if group.world == 1 else _ReduceFrom.apply(x, group)


def all_reduce_sum(x: torch.Tensor, group: RankGroup) -> torch.Tensor:
    """The sum over ``group`` whose ranks hold parts of the loss (dp, sp,
    pp): a sum forward and a sum of the gradients backward."""
    return x if group.world == 1 else _AllReduce.apply(x, group)


def gather_along(x: torch.Tensor, group: RankGroup,
                 dim: int) -> torch.Tensor:
    """All-gather on ``dim`` over ``group`` whose ranks hold parts of the
    loss (the sp ranks' K/V blocks): the backward reduce-scatters the
    gradient, so each rank gets the sum of every rank's use of its
    block."""
    return x if group.world == 1 else _GatherAlong.apply(x, group, dim)


def gather_replicated(x: torch.Tensor, group: RankGroup,
                      dim: int) -> torch.Tensor:
    """All-gather on ``dim`` over ``group`` whose ranks hold the same loss
    (the tp ranks' vocabulary shards of the logits; Megatron's gather
    from the model-parallel region): the backward keeps this rank's part
    of the gradient."""
    return x if group.world == 1 else _GatherReplicated.apply(x, group, dim)


class _RingPass(torch.autograd.Function):
    """Every hop of a ring of n ranks for K and V: n - 1 exchanges each
    (rank r receives from r - 1), the blocks rank r holds at each step
    returned in step order. One autograd node, so the backward hops are
    made in one order on every rank, whichever blocks a rank used."""

    @staticmethod
    def forward(ctx, k, v, group):
        ctx.group = group
        n, r = group.world, group.rank
        ks, vs = [k.view_as(k)], [v.view_as(v)]
        for _ in range(n - 1):
            ks.append(group.exchange(ks[-1], to=(r + 1) % n,
                                     frm=(r - 1) % n))
            vs.append(group.exchange(vs[-1], to=(r + 1) % n,
                                     frm=(r - 1) % n))
        return tuple(ks + vs)

    @staticmethod
    def backward(ctx, *grads):
        group = ctx.group
        n, r = group.world, group.rank
        out = []
        for gs in (grads[:n], grads[n:]):
            # Block j came over j hops; its gradient goes back over as
            # many, summed at every rank it passed with that rank's own.
            acc = gs[n - 1]
            for j in range(n - 2, -1, -1):
                back = group.exchange(acc.contiguous(), to=(r - 1) % n,
                                      frm=(r + 1) % n)
                acc = gs[j] + back
            out.append(acc)
        return out[0], out[1], None


def ring_pass(k: torch.Tensor, v: torch.Tensor,
              group: RankGroup) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The (K, V) blocks rank r holds at each step of a ring over
    ``group`` (step j: the blocks of rank r - j), with n - 1 exchanges
    each; the gradients travel the reverse way round the ring."""
    n = group.world
    blocks = _RingPass.apply(k, v, group)
    return list(zip(blocks[:n], blocks[n:]))
