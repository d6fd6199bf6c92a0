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
so a gather is exact in every dtype. The group is created with a
timeout: a rank that died or hung surfaces as an error on the others
within it.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
import re
import time
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from seldon_tpu_torch.device import DeviceLike

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
    on ``devices[r]``), created by :func:`init_group`.

    Collectives count their calls and the host seconds they take
    (``gathers``, ``gather_s``); on the staged route ``wait_s`` is the
    time spent waiting for the card's queued work before a transfer
    (the staging needs the values on the host), kept apart from the
    transfer itself."""

    def __init__(self, rank: int, devices: Sequence[torch.device],
                 timeout_s: float):
        self.rank = int(rank)
        self.devices: List[torch.device] = list(devices)
        self.world = len(self.devices)
        self.device = self.devices[self.rank]
        self.route = route_for(self.devices)
        self.timeout_s = float(timeout_s)
        self.gathers = 0
        self.gather_s = 0.0
        self.wait_s = 0.0

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

    def all_gather_last(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on the last axis in rank order
        (the exact all-gather in front of a replicated contraction)."""
        if self.world == 1:
            return x
        t0 = time.perf_counter()
        shape, dtype = x.shape, x.dtype
        if self.route == "nccl":
            raw = _bytes(x)
            out = torch.empty((self.world, *raw.shape), dtype=torch.uint8,
                              device=x.device)
            dist.all_gather_into_tensor(out, raw)
            parts = list(out.unbind(0))
        elif self.route == "staged":
            host = self._to_host(x)
            t0 = time.perf_counter()
            bufs = [torch.empty_like(host) for _ in range(self.world)]
            dist.all_gather(bufs, host)
            parts = [b.view(*shape[:-1], -1).to(x.device, non_blocking=True)
                     for b in bufs]
        else:
            raw = _bytes(x)
            parts = [torch.empty_like(raw) for _ in range(self.world)]
            dist.all_gather(parts, raw)
        out = torch.cat(parts, dim=-1).view(dtype)
        self.gathers += 1
        self.gather_s += time.perf_counter() - t0
        return out.reshape(*shape[:-1], shape[-1] * self.world)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated on ``dim`` in rank order."""
        if dim in (-1, x.dim() - 1):
            return self.all_gather_last(x)
        return self.all_gather_last(x.movedim(dim, -1)).movedim(-1, dim)

    def exchange(self, x: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """Send ``x`` to rank ``to`` and receive a tensor of its shape and
        dtype from rank ``frm`` (one hop of a ring)."""
        t0 = time.perf_counter()
        if self.route == "nccl":
            out = torch.empty_like(x)
            ops = [dist.P2POp(dist.isend, x.contiguous(), to),
                   dist.P2POp(dist.irecv, out, frm)]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        else:
            src = (self._to_host(x) if self.route == "staged"
                   else _bytes(x).reshape(-1))
            t0 = time.perf_counter()
            buf = torch.empty_like(src)
            works = [dist.isend(src, to), dist.irecv(buf, frm)]
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
        if self.route == "nccl":
            dist.send(_bytes(x), dst)
        elif self.route == "staged":
            dist.send(self._to_host(x, pinned=False), dst)
        else:
            dist.send(_bytes(x).reshape(-1), dst)

    def recv(self, shape, dtype: torch.dtype, src: int) -> torch.Tensor:
        """Receive a ``shape``/``dtype`` tensor sent by rank ``src`` with
        :meth:`send`, on this rank's device."""
        n = int(torch.Size(shape).numel()) * torch.empty(
            (), dtype=dtype).element_size()
        if self.route == "nccl":
            buf = torch.empty(n, dtype=torch.uint8, device=self.device)
            dist.recv(buf, src)
        else:
            buf = torch.empty(n, dtype=torch.uint8)
            dist.recv(buf, src)
        out = buf.view(dtype).reshape(shape)
        return out.to(self.device) if self.route == "staged" else out

    def close(self) -> None:
        """Leave the group (every rank calls it)."""
        if dist.is_initialized():
            dist.destroy_process_group()
