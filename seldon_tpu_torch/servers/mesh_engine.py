"""The serving engine on a rank group and the group itself — port of
``seldon_tpu/servers/mesh_engine.py``.

This module is the serving-side face of the exact-TP scheme in
``models/tp_sharding.py`` and of the JAX server's serving plans
(``TorchServer._serving_mesh``): a group stands up on any plan of
``dp x sp x tp`` ranks (pp = ep = 1)::

    mesh = mesh_engine.build_tp_mesh(2)          # the first two cards
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(...), tp=2)
    mesh = make_mesh(MeshPlan(dp=2, tp=2), ["cuda:0"] * 4)
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(...), mesh=mesh)

Rank r is the device at flat index r of JAX's grid (tp innermost). Every
rank holds a ``MeshRanks`` over the one world with its 'dp', 'sp' and
'tp' groups: the exact-TP gathers run inside the tp group, the ring over
the sp group (the ranks of one tp coordinate, each passing its own KV
heads), and each dp replica (the ranks of one dp coordinate) serves its
block of the slots (``servers/dp_replicas.py``).

JAX drives every device of a mesh from one process and partitions inside
each jitted dispatch. The port runs ONE PROCESS PER RANK and keeps the
same split: the wave is the SPMD unit and rank 0 drives.
 * Rank 0 is the engine: this process, holding every piece of host
   state (scheduler, block allocator and tables, prefix index, lattice,
   ledgers, supervisor, chaos) and its own shard of the weights and of
   the KV cache.
 * Ranks 1..tp-1 are workers, started with ``spawn`` (:func:`spawn_group`)
   and driven through a command pipe each (:class:`MeshGroup`). A worker
   holds its shards and runs one command at a time: at every device
   family the engine dispatches (``InferenceEngine._run``) rank 0 sends
   the family's name and its host-made arguments (token ids, lengths,
   positions, tables, sampling scalars), and every rank runs the same
   family on its own shards; the collectives inside (the all-gathers in
   front of the replicated ``wo`` / ``w_down``) pair them up. Only rank
   0's outputs reach the host. State-only families (deactivate,
   copy-on-write) and the supervisor's rebuild go through the group too,
   so no worker's pool drifts from rank 0's. Under dp each family runs
   on the replicas that own live slots of it, each on its cut, and each
   replica's leader (its first rank) sends its slots' fields and
   outputs back to rank 0, which puts them in slot order.
So the lattice keys, ``/debug/compile`` and the sched ledger stay
plan-invariant, as in JAX, and only rank 0 allocates blocks.

The group's transport is picked from its device list
(``parallel/distributed.route_for``): gloo for CPU ranks, NCCL when every
rank has its own card, gloo staged through host buffers when ranks share
a card. :func:`build_tp_mesh` takes the first ``tp`` distinct cards and
raises when there are too few; an explicit device list may name one card
twice — the JAX docstring's "callers packing several groups onto one
host" — and then both ranks run on it. A worker that dies or hangs
surfaces as an error on rank 0 within the group's timeout.

Device budget: ``build_tp_mesh`` claims cards from
``torch.cuda.device_count()``, capped by the ``MESH_DEVICES`` env (an
operator guard for sharing a host between engines).

Each rank builds the shard of its tp coordinate (:func:`build_shards`):
from the seed, replaying the whole model's draws and keeping its part
(``tp_sharding.init_shard``), or from an HF or an orbax checkpoint,
reading its columns only (``hf_loader.load_hf_shard``,
``checkpoint.load_checkpoint_shard``), so no rank ever holds the whole
model; ranks that differ only in dp or sp hold equal shards, held
equal by digest (:func:`shard_digest`). ``MeshEngine(..., sharded=True)``
takes rank 0's shard as given. :func:`send_weights` cuts a whole model
held on rank 0 instead.

Every rank runs cuBLAS under ``device.configure_gemms`` (a worker before
it joins the group); each worker reports its settings at spawn, and
``MeshEngine`` raises when a worker's differ from rank 0's. The dense
prefix cache's trie stays on rank 0; each worker keeps a
``prefix_cache.KVStore`` of its own heads' spans by node id, fed by the
``store`` command (under dp each span broadcast from the replica that
computed it), and ``check_replicas`` holds it to the trie. The paged
prefix cache moves a pool block to a replica that reads it without
holding it (the ``kvmove`` command, ``dp_replicas.move_blocks``). Every
process counts what it moved (:class:`Transfers`; rank 0's on the group,
the workers' through :meth:`MeshGroup.transfers`).

A group with an 'sp' axis serves ring attention: a context-parallel
score or admission sends its tokens to the workers, which run their
block of the sequence (the score's ``transformer.forward_hidden``, the
admission family's ``prefill``, with ``ring=`` their sp group and
``tp=`` their hints beside it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import logging
import multiprocessing
import os
import socket
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.multiprocessing  # noqa: F401  (CUDA tensors pickle as IPC)

from seldon_tpu_torch.device import DeviceLike, configure_gemms
from seldon_tpu_torch.models import tp_sharding, transformer
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.tp_sharding import TP_AXIS, validate
from seldon_tpu_torch.parallel.distributed import (DEFAULT_TIMEOUT_S,
                                                   SERVING_SETS, MeshRanks,
                                                   RankGroup, init_group)
from seldon_tpu_torch.parallel.mesh import (Mesh, MeshPlan, cuda_devices,
                                            make_mesh)
from seldon_tpu_torch.servers import dp_replicas
from seldon_tpu_torch.servers.engine import (EngineConfig, InferenceEngine,
                                             check_tp_attention, run_family,
                                             state_of)
from seldon_tpu_torch.servers.prefix_cache import KVStore, StoreGather

logger = logging.getLogger(__name__)


def device_budget() -> int:
    """Cards a group may claim: ``torch.cuda.device_count()`` capped by
    the MESH_DEVICES env (0 / unset = no cap)."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    try:
        cap = int(os.environ.get("MESH_DEVICES", "0") or 0)
    except ValueError:
        logger.warning("MESH_DEVICES=%r is not an int; ignoring",
                       os.environ.get("MESH_DEVICES"))
        cap = 0
    return min(n, cap) if cap > 0 else n


def build_tp_mesh(tp: int,
                  devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """Mesh with a ``tp``-wide 'tp' axis over the first ``tp`` cards
    (every other axis of the vocabulary sized 1). An explicit ``devices``
    list overrides: it may be CPU ranks, or name one card twice to put
    two ranks on it."""
    tp = int(tp)
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if devices is None:
        budget = device_budget()
        if tp > budget:
            raise ValueError(
                f"tp={tp} needs {tp} devices but only {budget} are "
                f"available (torch.cuda.device_count() capped by "
                f"MESH_DEVICES)")
        devices = cuda_devices()[:tp]
    if len(devices) < tp:
        raise ValueError(
            f"tp={tp} needs {tp} devices, got {len(devices)}")
    return make_mesh(MeshPlan(tp=tp), list(devices)[:tp])


# ---------------------------------------------------------------------------
# The live group: rank 0's handle, the workers' loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Transfers:
    """What one process moved between dp replicas for the prefix caches:
    paged block moves it took part in (``moves``, ``blocks``), dense
    spans it put (``spans``), and the bytes it received."""

    moves: int = 0
    blocks: int = 0
    spans: int = 0
    bytes_in: int = 0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class MeshGroup:
    """Rank 0's handle on a live rank group: the ``mesh`` it runs (its
    plan's axes), this process's collectives (``ranks``, the world's
    ``RankGroup``; ``axes``, the ``MeshRanks`` of its dp, sp and tp
    groups), and the worker processes (ranks 1..n-1) with their command
    pipes. Built by :func:`spawn_group`; :meth:`close` stops the
    workers.

    The command protocol lives here alone. Every command that makes the
    workers run collectives is sent together with rank 0's own part
    (``local``, a callable) under the group's lock, held from the send
    until that part returns: two threads of rank 0 (the engine's
    scheduler and a server's request thread) never interleave their
    commands on a pipe or pair their collectives with the wrong ones."""

    def __init__(self, mesh: Mesh, ranks: RankGroup, axes: MeshRanks,
                 procs, conns, gemms: Sequence[Dict[str, Any]] = ()):
        self.mesh = mesh
        self.ranks = ranks
        self.axes = axes
        self._procs = list(procs)
        self._conns = list(conns)
        self._lock = threading.RLock()
        self.closed = False
        self.failed: Optional[str] = None
        # Each worker's GEMM settings as it reported them at spawn.
        self.gemms = list(gemms)
        self.moved = Transfers()

    @property
    def world(self) -> int:
        return self.ranks.world

    @property
    def device(self) -> torch.device:
        """This rank's device."""
        return self.ranks.device

    @property
    def dp(self) -> int:
        return self.axes.size("dp")

    @property
    def sp(self) -> int:
        return self.axes.size("sp")

    @property
    def tp(self) -> int:
        return self.axes.size(TP_AXIS)

    @property
    def tp_ranks(self) -> RankGroup:
        """The collectives of this rank's tp group (the exact-TP
        gathers)."""
        return self.axes.group(TP_AXIS)

    @property
    def sp_ranks(self) -> Optional[RankGroup]:
        """The collectives of a ring (an 'sp' axis wider than 1), else
        None."""
        return self.axes.group("sp") if self.sp > 1 else None

    def replica_ranks(self, replica: int) -> List[int]:
        """The world ranks of dp replica ``replica``, leader first."""
        sizes = [self.axes.size(a) for a in self.mesh.axis_names]
        return np.arange(self.world).reshape(sizes)[replica].reshape(
            -1).tolist()

    def coord(self, rank: int) -> Dict[str, int]:
        """World rank ``rank``'s coordinate on every axis."""
        sizes = [self.axes.size(a) for a in self.mesh.axis_names]
        return {a: int(c) for a, c in zip(
            self.mesh.axis_names, np.unravel_index(rank, sizes))}

    def hints(self, tp: int):
        """This rank's exact-TP hints over its tp group
        (``tp_sharding``)."""
        return tp_sharding.hints(self.tp_ranks, tp)

    def describe(self) -> Dict[str, Any]:
        return dict(self.ranks.describe(), axes=self.mesh.shape)

    def _collectives(self) -> List[RankGroup]:
        """This rank's distinct groups (the world and its axes')."""
        out = [self.ranks]
        for axis in SERVING_SETS:
            g = self.axes.group(*axis)
            if all(g is not h for h in out):
                out.append(g)
        return out

    def counters(self) -> Dict[str, float]:
        """This rank's collectives over every one of its groups: calls
        (``gathers``), their host seconds, and the staged route's wait
        for the card."""
        gs = self._collectives()
        return {"gathers": sum(g.gathers for g in gs),
                "gather_s": sum(g.gather_s for g in gs),
                "wait_s": sum(g.wait_s for g in gs)}

    def reset_counters(self) -> None:
        for g in self._collectives():
            g.reset_counters()

    def lost(self) -> Optional[str]:
        """Why the group cannot serve (a worker's error report or exit),
        or None while every worker is up. Remembered once seen."""
        with self._lock:
            if self.failed is None:
                self.failed = self._first_loss()
            return self.failed

    def _first_loss(self) -> Optional[str]:
        for r, (p, c) in enumerate(zip(self._procs, self._conns), start=1):
            msg = None
            if c.poll():
                with contextlib.suppress(EOFError):
                    msg = c.recv()
            if msg is not None and msg[0] == "error":
                return f"rank {r} of the group failed:\n{msg[1]}"
            if msg is not None:
                return f"rank {r} sent an unexpected reply {msg[0]!r}"
            if p.exitcode is not None:
                return (f"rank {r} of the group exited with code "
                        f"{p.exitcode}")
        return None

    def check(self) -> None:
        """Raise if a worker reported an error or exited."""
        why = self.lost()
        if why is not None:
            raise RuntimeError(why)

    def _send(self, msg: tuple) -> None:
        """One command to every worker (after :meth:`check`); the caller
        holds the lock."""
        if self.closed:
            raise RuntimeError("the rank group is closed")
        self.check()
        for c in self._conns:
            c.send(msg)

    def _lockstep(self, msg: tuple, local: Callable[[], Any]) -> Any:
        """Send ``msg`` and run rank 0's part ``local`` under the lock;
        returns what ``local`` returns."""
        with self._lock:
            self._send(msg)
            return local()

    # --- the commands ------------------------------------------------------

    def family(self, name: str, args: Sequence, kw: Dict[str, Any],
               local: Callable[[], Any]) -> Any:
        """Every worker runs device family ``name`` on its shards with the
        host arguments ``args`` / ``kw`` (a ``ring`` keyword: its own sp
        group), while rank 0 runs ``local``."""
        return self._lockstep(("call", name, tuple(args), _wire(kw)),
                              local)

    def family_dp(self, name: str, cuts: Dict[int, "dp_replicas.Cut"],
                  local: Callable[[Any], Any]) -> Tuple[Any, Dict[int, Any]]:
        """Each dp replica in ``cuts`` runs family ``name`` on its cut
        (``servers/dp_replicas.py``): its workers get it, rank 0 runs
        ``local(cuts[0])`` when replica 0 is among them. Returns (rank
        0's result or None, {replica: its leader's (per-slot fields,
        outputs) as numpy}); a replica not in ``cuts`` runs nothing."""
        with self._lock:
            if self.closed:
                raise RuntimeError("the rank group is closed")
            self.check()
            leaders = {}
            for d, c in cuts.items():
                msg = ("dpcall", name, tuple(c.args), _wire(c.kw), c.lo,
                       c.hi, c.items)
                ranks = self.replica_ranks(d)
                leaders[d] = ranks[0]
                for r in ranks:
                    if r:
                        self._conns[r - 1].send(msg + (r == ranks[0],))
            mine = local(cuts[0]) if 0 in cuts else None
            theirs = {d: self._replies([r])[0]
                      for d, r in sorted(leaders.items()) if d}
            return mine, theirs

    def new_state(self, geometry: tuple, local: Callable[[], Any]) -> Any:
        """Every worker builds a fresh state of ``geometry``
        (``engine.state_of``: its shard, its replica's cache) while rank
        0 runs ``local``. A group that lost a rank runs ``local`` alone:
        the next command raises the loss."""
        with self._lock:
            if self.lost() is None:
                self._send(("state", geometry))
            return local()

    def score(self, ids: np.ndarray, local: Callable[[], Any],
              ring: bool = True) -> Any:
        """A score of token ids [B, S] over the group (the tp shards, and
        with ``ring`` the sp ranks' ring; every dp replica scores the
        whole batch): every worker runs the layers
        (``transformer.forward_hidden``) while rank 0 runs ``local``.
        A ring on a plan without an 'sp' axis raises."""
        if ring and self.sp <= 1:
            raise ValueError(f"a ring score on a plan without an 'sp' axis "
                             f"({self.mesh.shape})")
        return self._lockstep(("score", ids, ring), local)

    def release(self) -> None:
        """Every worker drops its weights, state and prefix store."""
        with self._lock:
            self._send(("release",))

    def replan(self, plan: MeshPlan) -> None:
        """Lay the live ranks out on another serving ``plan`` of their
        devices (every rank builds the plan's dp, sp and tp groups, in
        one order); every worker drops its weights and state first. A
        process is rank 0 of one group at a time, so plans that share the
        devices share the ranks instead of spawning more."""
        if plan.n_devices != self.world:
            raise ValueError(f"a plan of {plan.n_devices} ranks on a group "
                             f"of {self.world}")
        mesh = make_mesh(plan, self.mesh.flat_devices())
        with self._lock:
            self._send(("replan", mesh))
            self.axes = MeshRanks(mesh, self.ranks, SERVING_SETS)
            self.mesh = mesh

    def build(self, cfg: ModelConfig, tp: int, source: tuple,
              local: Callable[[], Any]) -> Tuple[Any, List[Any]]:
        """Every worker builds the exact-TP shard of its tp coordinate of
        ``source`` (:func:`build_rank_shard`) while rank 0 runs ``local``;
        returns (``local``'s result, each worker's :func:`shard_digest`,
        in full when the plan has replicas)."""
        with self._lock:
            self._send(("build", cfg, tp, source))
            mine = local()
            return mine, self._replies()

    def digests(self, cfg: ModelConfig) -> List[List[tuple]]:
        """Each worker's full :func:`shard_digest` of its weights."""
        return self._request(("digest", cfg))

    def store(self, ops: Sequence[tuple],
              local: Optional[Callable[[], int]] = None) -> None:
        """Every worker applies rank 0's prefix-store operations
        (``prefix_cache.KVStore.apply``) in order, while rank 0 runs
        ``local`` (its part of their spans' broadcasts under dp; the
        bytes it received)."""
        with self._lock:
            self._send(("store", list(ops)))
            if local is not None:
                self.moved.spans += sum(op[0] == "put" for op in ops)
                self.moved.bytes_in += local()

    def move_blocks(self, src: int, dst: int, bids: Sequence[int],
                    local: Callable[[], int]) -> None:
        """Pool blocks ``bids`` move from dp replica ``src`` to ``dst``
        (``dp_replicas.move_blocks``): the ranks of both replicas take
        part, rank 0 through ``local`` (the bytes it received)."""
        msg = ("kvmove", src, dst, list(bids))
        with self._lock:
            if self.closed:
                raise RuntimeError("the rank group is closed")
            self.check()
            for d in (src, dst):
                for r in self.replica_ranks(d):
                    if r:
                        self._conns[r - 1].send(msg)
            self.moved.moves += 1
            self.moved.blocks += len(bids)
            self.moved.bytes_in += local()

    def transfers(self, reset: bool = False) -> List[Transfers]:
        """Every rank's :class:`Transfers`, in rank order (then zeroed
        with ``reset``)."""
        out = [self.moved] + self.run(f"{__name__}:worker_transfers", reset)
        if reset:
            self.moved = Transfers()
        return out

    def store_spans(self) -> List[Dict[int, Dict[str, Tuple[int, ...]]]]:
        """Each worker's prefix store: node id -> {key: span shape}."""
        return self._request(("store_spans",))

    def gemm_settings(self) -> List[Dict[str, Any]]:
        """Each worker's GEMM settings now (``device.configure_gemms``)."""
        return self._request(("gemms",))

    def check_gemms(self, mine: Dict[str, Any]) -> None:
        """Raise unless every worker runs GEMMs under ``mine``, rank 0's
        settings: otherwise a rank's shard of a projection may be
        reduced in another order than the same columns at tp = 1."""
        for r, theirs in enumerate(self.gemm_settings(), start=1):
            if theirs != mine:
                raise RuntimeError(
                    f"rank {r} runs GEMMs under {theirs}, rank 0 under "
                    f"{mine}: the group would not compute tp = 1's bits")

    def replicas(self) -> List[Dict[str, np.ndarray]]:
        """Each worker's per-slot state (everything but the cache), in
        rank order."""
        return self._request(("replica",))

    def run(self, target: str, *args, **kw) -> List[Any]:
        """Call ``module:function`` on every worker as
        ``function(worker, *args, **kw)`` and return the results (a
        diagnostic surface: launch counters, kernel taps)."""
        return self._request(("run", target, args, kw))

    def spmd(self, target: str, *args, **kw) -> List[Any]:
        """Call ``module:function`` on EVERY rank, this one included, as
        ``function(rank_ctx, *args, **kw)`` (``rank_ctx.ranks`` is the
        rank's ``RankGroup``), so collectives inside pair up; returns the
        results in rank order."""
        mod, _, fn = target.partition(":")
        local = getattr(importlib.import_module(mod), fn)
        with self._lock:
            self._send(("run", target, args, kw))
            mine = local(self, *args, **kw)
            return [mine] + self._replies()

    def _request(self, msg: tuple) -> List[Any]:
        """Send ``msg`` and return each worker's reply, in rank order."""
        with self._lock:
            self._send(msg)
            return self._replies()

    def _replies(self, ranks: Optional[Sequence[int]] = None) -> List[Any]:
        """The reply of each worker of ``ranks`` (every worker when None),
        waiting at most the group's timeout for each (the caller holds
        the lock)."""
        out = []
        for r in (ranks if ranks is not None else range(1, self.world)):
            c = self._conns[r - 1]
            if not c.poll(self.ranks.timeout_s):
                raise RuntimeError(f"rank {r} did not answer within "
                                   f"{self.ranks.timeout_s} s")
            reply = c.recv()
            if reply[0] == "error":
                raise RuntimeError(f"rank {r} of the group failed:\n"
                                   f"{reply[1]}")
            out.append(reply[1])
        return out

    def kill(self, rank: int) -> None:
        """Terminate worker ``rank`` (fault injection in tests)."""
        p = self._procs[rank - 1]
        p.kill()
        p.join(timeout=30)

    def close(self) -> None:
        """Stop every worker and leave the group."""
        with self._lock:
            if self.closed:
                return
            self.closed = True
            for p, c in zip(self._procs, self._conns):
                if p.exitcode is None:
                    with contextlib.suppress(OSError):
                        c.send(("exit",))
            for p, c in zip(self._procs, self._conns):
                p.join(timeout=60)
                if p.exitcode is None:
                    p.kill()
                    p.join(timeout=30)
                c.close()
            self.ranks.close()


def _wire(kw: Dict[str, Any]) -> Dict[str, Any]:
    """A family's keywords for the pipe: a ``ring`` group becomes True
    (each worker runs its own sp group)."""
    if kw.get("ring") is None:
        return kw
    return dict(kw, ring=True)


def spawn_group(mesh: Mesh, timeout_s: float = DEFAULT_TIMEOUT_S
                ) -> MeshGroup:
    """Start ranks 1..n-1 of ``mesh`` (``spawn``, never ``fork``: CUDA may
    be live here), join the group as rank 0 and return its handle. Every
    rank builds its dp, sp and tp groups (``MeshRanks``) in one order.
    A plan with a pp or ep axis raises: serving plans are dp x sp x tp."""
    extra = {a: n for a, n in mesh.shape.items()
             if a in ("pp", "ep") and n > 1}
    if extra:
        raise ValueError(f"a serving group's plan is dp x sp x tp; this "
                         f"mesh has {extra}")
    devices = mesh.flat_devices()
    init_method = f"tcp://127.0.0.1:{_free_port()}"
    ctx = multiprocessing.get_context("spawn")
    procs, conns = [], []
    for rank in range(1, len(devices)):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_worker_main,
                        args=(rank, mesh, init_method, timeout_s, child),
                        daemon=True, name=f"seldon-rank-{rank}")
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    ranks = init_group(0, devices, init_method, timeout_s)
    axes = MeshRanks(mesh, ranks, SERVING_SETS)
    gemms = []
    for r, c in enumerate(conns, start=1):
        if not c.poll(timeout_s):
            raise RuntimeError(f"rank {r} did not report its GEMM settings "
                               f"within {timeout_s} s")
        msg = c.recv()
        if msg[0] != "gemms":
            raise RuntimeError(f"rank {r} failed at spawn:\n{msg[1]}")
        gemms.append(msg[1])
    group = MeshGroup(mesh, ranks, axes, procs, conns, gemms)
    logger.info("rank group up: %s", group.describe())
    return group


def _storage_view(t: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(tensor in its storage order, column-major?): a column-major 2-D
    leaf (the int8 projections) travels as its transpose, so it arrives
    column-major too."""
    colmajor = (t.dim() == 2 and t.shape[0] > 1 and t.shape[1] > 1
                and t.stride(0) == 1 and t.stride(1) == t.shape[0])
    return (t.t() if colmajor else t), colmajor


def _leaf_table(cfg: ModelConfig, params: transformer.Transformer,
                shard: bool):
    """(path, name, spec, tensor) of every leaf of ``params`` in
    ``build_shard``'s order; specs all None when nothing is sharded."""
    out = []

    def leaf(path, name, spec):
        t = tp_sharding.leaf_of(params, path, name)
        if t is not None:
            out.append((path, name, spec if shard else None, t.detach()))
        return t

    tp_sharding.build_shard(cfg, leaf)
    return out


def build_rank_shard(cfg: ModelConfig, source: tuple, device, rank: int,
                     tp: int) -> transformer.Transformer:
    """Rank ``rank``'s exact-TP shard of the model ``source`` names, built
    on ``device`` without the whole model: ``("seed", seed)`` replays
    ``transformer.init_params``' draws from a generator on ``device``
    seeded ``seed`` (``tp_sharding.init_shard``); ``("hf", path)`` reads
    the rank's columns of a local HF checkpoint
    (``hf_loader.load_hf_shard``, in ``cfg.dtype``); ``("orbax", path)``
    reads the rank's columns of an orbax checkpoint directory
    (``checkpoint.load_checkpoint_shard``, in its own dtypes). Quantized
    per output column when ``cfg.weight_dtype`` is int8 (a no-op on an
    int8 checkpoint), which gives the cut of the quantized whole model."""
    from seldon_tpu_torch.models.quantize import quantize_params

    kind, arg = source
    if kind == "seed":
        gen = torch.Generator(device=device)
        gen.manual_seed(int(arg))
        shard = tp_sharding.init_shard(cfg, gen, device, rank, tp)
    elif kind == "hf":
        from seldon_tpu_torch.servers.hf_loader import load_hf_shard

        shard = load_hf_shard(arg, device, rank, tp, cfg.dtype)[0]
    elif kind == "orbax":
        from seldon_tpu_torch.servers.checkpoint import load_checkpoint_shard

        shard = load_checkpoint_shard(arg, device, rank, tp)[0]
    else:
        raise ValueError(f"unknown weight source {kind!r}")
    if cfg.weight_dtype == "int8":
        shard = quantize_params(shard)
    return shard


def _byte_sum(t: torch.Tensor) -> int:
    """The sum of ``t``'s bytes in storage order (in slices, so no large
    temporary forms)."""
    b = _storage_view(t.detach())[0].contiguous().view(-1).view(torch.uint8)
    step = 1 << 26
    return sum(int(b[i:i + step].sum(dtype=torch.int64))
               for i in range(0, b.numel(), step))


def shard_digest(cfg: ModelConfig, params: transformer.Transformer,
                 full: bool = False) -> List[tuple]:
    """(path, name, shape, dtype, sharded?, byte sum or None) of every
    leaf of a rank's shard: what every rank's shard must share. A
    replicated leaf's bytes are the same on every rank, so its byte sum
    is kept; a sharded leaf's part differs by tp coordinate, so only its
    shape is, unless ``full`` (the ranks of one tp coordinate hold the
    same part)."""
    return [(path, name, tuple(t.shape), str(t.dtype), spec is not None,
             None if spec is not None and not full else _byte_sum(t))
            for path, name, spec, t in _leaf_table(cfg, params, True)]


def check_digests(group: MeshGroup, mine: List[tuple],
                  theirs: Sequence[List[tuple]]) -> None:
    """Raise unless every worker's shard digest (``theirs``, in rank
    order) has rank 0's (``mine``) leaf shapes, dtypes and replicated
    leaves' bytes, and, where both are full, the bytes of every rank of
    its tp coordinate."""
    def shared(d):
        return [e[:5] + ((None,) if e[4] else e[5:]) for e in d]

    digests = [mine] + list(theirs)
    for r, d in enumerate(digests[1:], start=1):
        bad = [(a, b) for a, b in zip(shared(mine), shared(d)) if a != b]
        if bad or len(d) != len(mine):
            raise RuntimeError(f"rank {r}'s shard disagrees with rank 0's "
                               f"(rank 0, rank {r}): {bad[:3]}")
    first: Dict[int, int] = {}
    for r, d in enumerate(digests):
        c = group.coord(r)[TP_AXIS]
        if c not in first:
            first[c] = r
            continue
        ref = digests[first[c]]
        if any(e[5] is None for e in d + ref):
            continue
        bad = [(a, b) for a, b in zip(ref, d) if a != b]
        if bad:
            raise RuntimeError(
                f"rank {r}'s shard differs from rank {first[c]}'s, which "
                f"holds the same tp part: {bad[:3]}")


def build_shards(group: MeshGroup, cfg: ModelConfig, source: tuple
                 ) -> transformer.Transformer:
    """Every rank of ``group`` builds the exact-TP shard of its tp
    coordinate of ``source`` (:func:`build_rank_shard`), at once; returns
    rank 0's. Raises unless every shard has rank 0's leaf shapes and
    dtypes and its replicated leaves' bytes, and (a plan with dp or sp
    replicas) the bytes of every rank of its tp coordinate."""
    tp = group.tp
    validate(cfg, tp)
    full = group.world > tp
    shard, theirs = group.build(cfg, tp, source, lambda: build_rank_shard(
        cfg, source, group.device, group.tp_ranks.rank, tp))
    check_digests(group, shard_digest(cfg, shard, full), theirs)
    return shard


def send_weights(group: MeshGroup, cfg: ModelConfig,
                 params: transformer.Transformer, shard: bool) -> None:
    """Give every worker its weights: under ``shard`` the exact-TP shard
    of its tp coordinate of each leaf, else the whole model. Each leaf
    moves on its own, so no rank holds a second full model: through the
    group's transport (``RankGroup.send``), or, where ranks share a card
    (the staged route), as a CUDA IPC handle on the command pipe that the
    worker copies on the card and acknowledges before the next leaf
    (staging gigabytes of weights through host memory would take seconds
    per gigabyte)."""
    ranks = group.ranks
    tp = group.tp if shard else 1
    table = _leaf_table(cfg, params, shard)
    meta = []
    for path, name, spec, t in table:
        part = t if spec is None else t.narrow(
            t.dim() - 1, 0, t.shape[-1] // tp)
        view, colmajor = _storage_view(part)
        meta.append((path, name, tuple(view.shape), str(t.dtype)[6:],
                     colmajor))
    ipc = ranks.route == "staged"
    coords = [group.coord(r)[TP_AXIS] for r in range(ranks.world)]
    with group._lock:
        group._send(("weights", cfg, tp, meta, ipc))
        for path, name, spec, t in table:
            for r in range(1, ranks.world):
                w = t.shape[-1] // tp
                part = t if spec is None else t.narrow(
                    t.dim() - 1, coords[r] * w, w)
                view = _storage_view(part)[0]
                if ipc:
                    # A CUDA tensor pickles as an IPC handle
                    # (torch.multiprocessing's reductions); the part stays
                    # alive here until the worker has copied it.
                    group._conns[r - 1].send(view.contiguous())
                else:
                    ranks.send(view, r)
            if ipc:
                group._replies()
                # Free the parts the worker released (CUDA keeps a sent
                # block until the producer collects it).
                torch.cuda.ipc_collect()


class _Worker:
    """A worker rank: its group (``ranks``, the world; ``axes``, its dp,
    sp and tp groups), its weights and state, and one handler per
    command (``op_<name>``)."""

    def __init__(self, ranks: RankGroup, axes: MeshRanks, conn):
        self.ranks = ranks
        self.axes = axes
        self.conn = conn
        self.device = ranks.device
        self.cfg: Optional[ModelConfig] = None
        self.params: Optional[transformer.Transformer] = None
        self.state: Optional[Dict[str, Any]] = None
        self.tp = None
        # The dense prefix cache's spans of this rank's heads, and the
        # last family's cache-dtype KV they are copied from.
        self.store = KVStore()
        self.writes: Optional[Dict[str, torch.Tensor]] = None
        self.moved = Transfers()

    # Commands whose result goes back to rank 0 (MeshGroup.request).
    REPLIES = ("replica", "run", "build", "store_spans", "gemms", "digest")

    def loop(self) -> None:
        while True:
            msg = self.conn.recv()
            if msg[0] == "exit":
                return
            reply = getattr(self, "op_" + msg[0])(*msg[1:])
            if msg[0] in self.REPLIES:
                self.conn.send((msg[0], reply))

    def _d(self, a: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _hints(self, tp: int):
        return tp_sharding.hints(self.axes.group(TP_AXIS), tp)

    def _args(self, args, kw):
        dargs = [self._d(a) if isinstance(a, np.ndarray)
                 else self.store.resolve(a, self.state["cache"])
                 if isinstance(a, StoreGather) else a for a in args]
        if kw.get("ring") is True:
            kw = dict(kw, ring=self.axes.group("sp"))
        return dargs, kw

    def op_weights(self, cfg: ModelConfig, tp: int, meta,
                   ipc: bool) -> None:
        self.release()
        got = {}
        for path, name, shape, dtype, colmajor in meta:
            if ipc:
                mapped = self.conn.recv()  # rank 0's memory on this card
                t = mapped.clone()
                del mapped
                torch.cuda.synchronize(self.device)
                self.conn.send(("ack", None))
            else:
                t = self.ranks.recv(shape, getattr(torch, dtype), 0)
            got[(path, name)] = t.t() if colmajor else t
        self.cfg = cfg
        self.params = tp_sharding.build_shard(
            cfg, lambda path, name, spec: got.get((path, name)))
        self.tp = self._hints(tp)

    def op_build(self, cfg: ModelConfig, tp: int, source: tuple):
        self.release()
        self.cfg = cfg
        self.params = build_rank_shard(cfg, source, self.device,
                                       self.axes.group(TP_AXIS).rank, tp)
        self.tp = self._hints(tp)
        return shard_digest(cfg, self.params, self.ranks.world > tp)

    def op_digest(self, cfg: ModelConfig):
        return shard_digest(cfg, self.params, True)

    def op_state(self, geometry) -> None:
        self.state = self.writes = None
        self.store = KVStore()
        self.state = state_of(self.cfg, geometry, self.device, self.tp)

    def op_call(self, name: str, args, kw) -> None:
        dargs, kw = self._args(args, kw)
        out = run_family(name, self.params, self.state, dargs, kw,
                         self.cfg, self.tp)
        self.state = out[0]
        self._keep_writes(out)

    def _keep_writes(self, out: tuple) -> tuple:
        """Keep a family's trailing dict, its KV for the prefix trie, as
        ``writes``; returns the outputs before it."""
        has = len(out) > 1 and isinstance(out[-1], dict)
        self.writes = out[-1] if has else None
        return out[:-1] if has else out

    def op_dpcall(self, name: str, args, kw, lo: int, hi: int, items,
                  leader: bool) -> None:
        """Family ``name`` on this replica's slots [lo, hi) with its cut
        of the arguments, its products under the row share of ``items``
        (``engine.run_family``) (``servers/dp_replicas.py``); the replica's leader sends
        its slots' new fields and the outputs to rank 0."""
        dargs, kw = self._args(args, kw)
        out = run_family(name, self.params,
                         dp_replicas.sub_state(self.state, lo, hi), dargs,
                         kw, self.cfg, self.tp, items)
        self.state = dp_replicas.put_fields(
            dict(self.state, cache=out[0]["cache"]), [(lo, hi, out[0])])
        out = self._keep_writes(out)
        if leader:
            fields = {k: v.cpu().numpy() for k, v in out[0].items()
                      if k != "cache"}
            self.conn.send(("dpcall", (fields, [o.cpu().numpy()
                                                for o in out[1:]])))

    def op_store(self, ops) -> None:
        dp = None
        if self.axes.size("dp") > 1:
            dp = (self.axes.group("dp"), self.axes.coord["dp"],
                  self.state["cache"])
        got = self.store.apply(ops, self.writes, dp)
        if dp is not None:
            self.moved.spans += sum(op[0] == "put" for op in ops)
            self.moved.bytes_in += got

    def op_kvmove(self, src: int, dst: int, bids) -> None:
        self.moved.moves += 1
        self.moved.blocks += len(bids)
        self.moved.bytes_in += dp_replicas.move_blocks(
            self.state["cache"], self.axes.group("dp"),
            self.axes.coord["dp"], src, dst, bids)

    def op_store_spans(self):
        return self.store.shapes()

    def op_gemms(self):
        return configure_gemms()

    def op_replica(self) -> Dict[str, np.ndarray]:
        """This rank's per-slot state (everything but the cache)."""
        return {k: v.cpu().numpy() for k, v in self.state.items()
                if k != "cache"}

    def op_score(self, tokens: np.ndarray, ring: bool) -> None:
        """The layers of a score: with ``ring`` this rank's block of the
        sequence over its sp group; on its shard under tp."""
        transformer.forward_hidden(
            self.params, self._d(tokens), self.cfg,
            ring=self.axes.group("sp") if ring else None, tp=self.tp)

    def op_run(self, target: str, args, kw):
        mod, _, fn = target.partition(":")
        return getattr(importlib.import_module(mod), fn)(self, *args, **kw)

    def op_release(self) -> None:
        self.release()

    def op_replan(self, mesh: Mesh) -> None:
        self.release()
        self.axes = MeshRanks(mesh, self.ranks, SERVING_SETS)

    def release(self) -> None:
        self.params = self.state = self.tp = self.writes = None
        self.store = KVStore()
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def worker_transfers(worker: _Worker, reset: bool = False) -> Transfers:
    """Run on a worker (:meth:`MeshGroup.transfers`): its
    :class:`Transfers`, then zeroed with ``reset``."""
    out = worker.moved
    if reset:
        worker.moved = Transfers()
    return out


def _worker_main(rank: int, mesh: Mesh, init_method: str, timeout_s: float,
                 conn) -> None:
    """A spawned rank: set its GEMMs up and report them, join the group
    and build its axis groups, serve commands until "exit" (or until
    rank 0's end of the pipe closes)."""
    conn.send(("gemms", configure_gemms()))
    ranks = init_group(rank, mesh.flat_devices(), init_method, timeout_s)
    try:
        _Worker(ranks, MeshRanks(mesh, ranks, SERVING_SETS), conn).loop()
    except EOFError:
        pass  # rank 0 is gone: nothing is left to serve
    except BaseException:
        with contextlib.suppress(OSError):
            conn.send(("error", traceback.format_exc()))
        raise
    finally:
        ranks.close()


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------


class MeshEngine(InferenceEngine):
    """:class:`InferenceEngine` stood up on a rank group of any serving
    plan (dp x sp x tp).

    ``tp`` may come as the keyword here or already set on the engine
    config; both given and disagreeing is an error, and so is one that
    disagrees with the group's (or ``mesh``'s) 'tp' axis. With no group
    and no mesh, tp=1 is a plain single-device engine with no group —
    the baseline every parity gate compares against — and tp > 1 spawns
    a group on :func:`build_tp_mesh` ``(tp)``. ``params`` is the whole
    model on rank 0's device; this process keeps its shard (replicated
    leaves are ``params``' own tensors) and every worker receives the
    shard of its tp coordinate. With ``sharded`` ``params`` is already
    rank 0's shard and every worker of ``group`` holds its own
    (:func:`build_shards`): nothing is cut or sent. ``group`` (a
    :class:`MeshGroup`) reuses a live group, which outlives the engine;
    without it the engine spawns one on ``mesh`` and closes it in
    :meth:`stop`. A plan with a dp axis serves each replica's block of
    the slots (``servers/dp_replicas.py``; ``max_slots % dp`` must be 0,
    and a prefix cache's KV moves to the replica that reads it); the ring
    runs only on a plan
    with an sp axis. Every worker must run GEMMs under rank 0's settings
    (``device.configure_gemms``), or the engine raises.
    """

    def __init__(
        self,
        params: transformer.Transformer,
        cfg: ModelConfig,
        engine_cfg: Optional[EngineConfig] = None,
        mesh: Optional[Mesh] = None,
        draft: Optional[Tuple[Any, ModelConfig]] = None,
        tp: int = 0,
        group: Optional[MeshGroup] = None,
        sharded: bool = False,
    ):
        ecfg = engine_cfg or EngineConfig()
        tp = int(tp)
        if tp and ecfg.tp > 1 and tp != ecfg.tp:
            raise ValueError(
                f"MeshEngine(tp={tp}) disagrees with "
                f"EngineConfig.tp={ecfg.tp}")
        tp = tp or ecfg.tp
        validate(cfg, tp)  # fail before any rank is started
        plan = group.mesh if group is not None else mesh
        if plan is not None:
            have = int(plan.shape.get(TP_AXIS, 1))
            if tp > 1 and tp != have:
                raise ValueError(
                    f"EngineConfig.tp={tp} but the group carries a "
                    f"{have}-way '{TP_AXIS}' axis")
            tp = have
        if ecfg.tp != tp:
            ecfg = dataclasses.replace(ecfg, tp=tp)
        self._own_group = False
        self._released = False
        if (plan.devices.size if plan is not None else tp) <= 1:
            super().__init__(params, cfg, ecfg, params.device, draft)
            return
        validate(cfg, tp)  # the group's tp
        shape = plan.shape if plan is not None else {}
        if tp > 1:
            check_tp_attention(cfg, tp, shape.get("sp", 1))
        if shape.get("dp", 1) > 1:
            dp_replicas.check_slots(ecfg.max_slots, shape["dp"])
        if sharded and group is None:
            raise ValueError("a sharded MeshEngine needs the group whose "
                             "ranks built the shards")
        if group is None:
            group = spawn_group(mesh if mesh is not None
                                else build_tp_mesh(tp))
            self._own_group = True
        try:
            group.check_gemms(configure_gemms())
            if sharded:
                width = cfg.n_kv_heads * cfg.head_dim // tp
                if params.blocks[0].wk.shape[-1] != width:
                    raise ValueError(
                        f"params are not a {tp}-way shard: wk is "
                        f"{tuple(params.blocks[0].wk.shape)}")
                shard = params
            else:
                send_weights(group, cfg, params, shard=tp > 1)
                shard = (tp_sharding.shard_params(group.tp_ranks, cfg, params)
                         if tp > 1 else params)
            super().__init__(shard, cfg, ecfg, group.ranks.device, draft,
                             mesh=group)
        except BaseException:
            if self._own_group:
                group.close()
            raise

    def mesh_info(self) -> Dict[str, Any]:
        """Host-side description of the group (no device sync): its plan
        (every axis's size), the tp group size, the devices backing it,
        the transport, and the per-device weight bytes actually committed
        (counted from shard shapes)."""
        if not self._grouped:
            return {"tp": 1, "axis": TP_AXIS, "devices": [],
                    "weight_bytes_per_device":
                        self._hbm_weights_device_bytes()}
        return {
            "tp": self.ecfg.tp,
            "axis": TP_AXIS,
            "plan": dict(self._mesh.mesh.shape),
            "world": self._mesh.world,
            "devices": [str(d) for d in self._mesh.mesh.flat_devices()],
            "route": self._mesh.ranks.route,
            "weight_bytes_per_device": self._hbm_weights_device_bytes(),
        }

    def check_replicas(self) -> None:
        """Raise unless every worker's per-slot state (sampled tokens,
        positions, flags, budgets) equals rank 0's over the slots of its
        dp replica; with dp or sp replicas, every worker's weights equal
        (by digest) those of the ranks of its tp coordinate; and, with the
        dense prefix cache, every worker's store holds the trie's node
        ids, each span at the shard shape of rank 0's. Call when idle."""
        if not self._grouped:
            return
        group, B = self._mesh, self.ecfg.max_slots
        mine = {k: v.cpu().numpy() for k, v in self._state.items()
                if k != "cache"}
        for r, theirs in enumerate(group.replicas(), start=1):
            lo, hi = dp_replicas.slot_range(group.coord(r)["dp"], B,
                                            self._dp)
            for k, v in mine.items():
                if not np.array_equal(v[lo:hi], theirs[k][lo:hi]):
                    raise RuntimeError(
                        f"rank {r}'s state[{k!r}] differs from rank 0's "
                        f"over its slots [{lo}, {hi})")
        if group.world > group.tp:
            check_digests(group, shard_digest(self.cfg, self.params, True),
                          group.digests(self.cfg))
        if self._prefix is None:
            return
        self._store_sync()
        spans = self._prefix.spans()
        heads = self.cfg.n_kv_heads // self.ecfg.tp
        for nid, shape in spans.items():
            if any(s[1] != heads for s in shape.values()):
                raise RuntimeError(f"trie node {nid}'s span {shape} does "
                                   f"not hold {heads} KV heads")
        for r, theirs in enumerate(group.store_spans(), start=1):
            if theirs != spans:
                raise RuntimeError(
                    f"rank {r}'s prefix store differs from rank 0's trie: "
                    f"nodes {sorted(theirs)} vs {sorted(spans)}"
                    if set(theirs) != set(spans) else
                    f"rank {r}'s prefix store differs from rank 0's trie "
                    f"in its span shapes")

    def stop(self):
        super().stop()
        if not self._grouped or self._released:
            return
        self._released = True
        if self._own_group:
            self._mesh.close()
        elif not self._mesh.closed and self._mesh.lost() is None:
            self._mesh.release()
