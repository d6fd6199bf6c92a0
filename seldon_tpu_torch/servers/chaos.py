"""Deterministic fault injection for the serving engine — port of
``seldon_tpu/servers/chaos.py``, draw for draw.

The engine's failure paths (the wrecked-wave path, per-group admission
failure, pool-exhaustion shedding, cancel/deadline reaping) are the parts
of the scheduler that real traffic exercises least and outages exercise
most. A :class:`ChaosMonkey` seeded from ``ChaosConfig.seed`` makes them
reproducible; it injects

 * dispatch failures — an admission/decode/ragged dispatch raises
   :class:`ChaosError` before its kernels launch, driving the engine's
   per-group failure path and the wrecked-wave path (a device-state
   rebuild, and with ``heal`` a resurrection);
 * allocator exhaustion — ``_pool_reserve`` reports "no capacity",
   driving the paged admission-stall / shed path without shrinking the
   pool;
 * slow boundaries — the boundary fetch sleeps, widening every
   dispatch/fetch race window (optimistic recycling, stale rosters);
 * mid-stream disconnects — a random live request is cancelled, exactly
   what a vanished streaming client does to the engine;
 * NaN/garbage injection — one token id of a fetched boundary's host
   buffers is overwritten out of vocabulary, what NaN-poisoned logits or
   a corrupt copy hand the host (drives the heal sentinel);
 * fetch hangs — the boundary fetch sleeps past the heal watchdog,
   driving the hung-wave declaration instead of a wedged scheduler;
 * sticky faults — ONE seeded request (``sticky_rid``) faults every
   whole-batch wave it rides, deterministically: the poison-quarantine
   bisection's test vector.

Determinism contract: all scheduler-side draws (``dispatch``, ``alloc``,
``disconnect``) come from one ``random.Random(seed)`` consumed ONLY on
the scheduler thread, so a fixed seed replays the same fault sequence
against the same request stream. The fetcher-side draws (``slow``,
``hang``, ``nan_inject``) use an independent ``random.Random(seed + 1)``
so perturbing the fetcher can never perturb the scheduler's fault
sequence. Sticky faults draw nothing — membership of the seeded rid in
the dispatched wave IS the trigger.

Env gating (``ChaosConfig.from_env``, read by the engine when its config
carries no ``chaos``): ``CHAOS=1`` master switch, ``CHAOS_SEED``,
``CHAOS_DISPATCH_FAIL``, ``CHAOS_ALLOC_FAIL``, ``CHAOS_SLOW_BOUNDARY``,
``CHAOS_SLOW_MS``, ``CHAOS_DISCONNECT``, ``CHAOS_NAN_INJECT``,
``CHAOS_HANG``, ``CHAOS_HANG_MS``, ``CHAOS_STICKY_RID``. Everything
defaults to off — an engine without a ChaosMonkey has no chaos code on
its hot path, and chaos is never a unit parameter (a deployment
manifest cannot enable it by accident).
"""

from __future__ import annotations

import dataclasses
import os
import random
import threading
from typing import Dict, Optional, Sequence

import numpy as np


class ChaosError(RuntimeError):
    """Injected fault (never raised unless chaos is enabled)."""


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    seed: int = 0
    dispatch_fail: float = 0.0  # P(a dispatch raises ChaosError)
    alloc_fail: float = 0.0  # P(_pool_reserve pretends exhaustion)
    slow_boundary: float = 0.0  # P(a boundary fetch sleeps slow_ms)
    slow_ms: float = 5.0
    disconnect: float = 0.0  # P(one live request cancelled / sched step)
    nan_inject: float = 0.0  # P(a fetched boundary's tokens poisoned)
    hang: float = 0.0  # P(a boundary fetch sleeps hang_ms)
    hang_ms: float = 200.0
    sticky_rid: int = -1  # this rid faults EVERY wave it rides (-1 = off)

    def any_enabled(self) -> bool:
        return any(
            p > 0.0 for p in (
                self.dispatch_fail, self.alloc_fail,
                self.slow_boundary, self.disconnect,
                self.nan_inject, self.hang,
            )
        ) or self.sticky_rid >= 0

    @classmethod
    def from_env(cls) -> Optional["ChaosConfig"]:
        """Build from CHAOS_* env vars; None unless CHAOS=1 AND at least
        one probability is non-zero (mis-set knobs without the master
        switch stay inert — prod can't trip chaos by accident)."""
        if os.environ.get("CHAOS", "0") not in ("1", "true", "yes"):
            return None
        cfg = cls(
            seed=int(os.environ.get("CHAOS_SEED", "0") or 0),
            dispatch_fail=float(
                os.environ.get("CHAOS_DISPATCH_FAIL", "0") or 0.0
            ),
            alloc_fail=float(os.environ.get("CHAOS_ALLOC_FAIL", "0") or 0.0),
            slow_boundary=float(
                os.environ.get("CHAOS_SLOW_BOUNDARY", "0") or 0.0
            ),
            slow_ms=float(os.environ.get("CHAOS_SLOW_MS", "5") or 5.0),
            disconnect=float(os.environ.get("CHAOS_DISCONNECT", "0") or 0.0),
            nan_inject=float(
                os.environ.get("CHAOS_NAN_INJECT", "0") or 0.0
            ),
            hang=float(os.environ.get("CHAOS_HANG", "0") or 0.0),
            hang_ms=float(os.environ.get("CHAOS_HANG_MS", "200") or 200.0),
            sticky_rid=int(os.environ.get("CHAOS_STICKY_RID", "-1") or -1),
        )
        return cfg if cfg.any_enabled() else None


class ChaosMonkey:
    """Seeded fault injector; one instance per engine."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._sched_rng = random.Random(cfg.seed)
        self._fetch_rng = random.Random(cfg.seed + 1)
        self._lock = threading.Lock()
        self.counts: Dict[str, int] = {
            "dispatch_faults": 0,
            "alloc_faults": 0,
            "slow_boundaries": 0,
            "disconnects": 0,
            "nan_injects": 0,
            "hangs": 0,
            "sticky_faults": 0,
        }

    def _count(self, key: str) -> None:
        with self._lock:
            self.counts[key] += 1

    # --- scheduler-thread hooks --------------------------------------------

    def on_dispatch(self, site: str, rids: Sequence[int] = ()) -> None:
        """Called before each admission/decode dispatch; raises to
        simulate a device/compile failure at that site. `rids` is the
        wave's live membership — the sticky fault fires iff the seeded
        rid rides a WHOLE-BATCH wave (decode/ragged; deterministic, no
        rng draw), so the heal bisection can isolate it by dispatching
        suspects alone. Admission sites are exempt: the sticky request
        must be admittable so it can keep wrecking decode waves."""
        if (self.cfg.sticky_rid >= 0 and site in ("decode", "ragged")
                and self.cfg.sticky_rid in rids):
            self._count("sticky_faults")
            raise ChaosError(
                f"chaos: sticky fault pinned to rid "
                f"{self.cfg.sticky_rid} ({site} wave)"
            )
        if self.cfg.dispatch_fail and (
            self._sched_rng.random() < self.cfg.dispatch_fail
        ):
            self._count("dispatch_faults")
            raise ChaosError(f"chaos: injected {site} dispatch failure")

    def steal_alloc(self) -> bool:
        """True -> the paged pool should report exhaustion this check."""
        if self.cfg.alloc_fail and (
            self._sched_rng.random() < self.cfg.alloc_fail
        ):
            self._count("alloc_faults")
            return True
        return False

    def pick_disconnect(self, rids: Sequence[int]) -> Optional[int]:
        """Maybe pick one live rid to 'disconnect' (engine cancels it)."""
        if rids and self.cfg.disconnect and (
            self._sched_rng.random() < self.cfg.disconnect
        ):
            self._count("disconnects")
            return self._sched_rng.choice(list(rids))
        return None

    # --- fetcher-thread hook ------------------------------------------------

    def maybe_slow_boundary(self) -> None:
        if self.cfg.slow_boundary and (
            self._fetch_rng.random() < self.cfg.slow_boundary
        ):
            self._count("slow_boundaries")
            import time

            time.sleep(self.cfg.slow_ms / 1000.0)

    def maybe_hang(self) -> None:
        """Sleep the boundary fetch past the heal watchdog (called
        INSIDE the watchdog-bounded fetch closure, so a hang is
        observed exactly like a wedged device transfer)."""
        if self.cfg.hang and (
            self._fetch_rng.random() < self.cfg.hang
        ):
            self._count("hangs")
            import time

            time.sleep(self.cfg.hang_ms / 1000.0)

    def poison_fetch(self, arrays: Sequence) -> None:
        """With P(nan_inject), overwrite one fetched token id with an
        out-of-vocab value — what NaN logits or a corrupt copy look like
        by the time token ids reach the host. Mutates the host buffers in
        place: numpy arrays, or CPU tensors through their zero-copy
        ``.numpy()`` view (the engine's boundary copies; the device state
        is not touched)."""
        if not self.cfg.nan_inject or (
            self._fetch_rng.random() >= self.cfg.nan_inject
        ):
            return
        for a in arrays:
            if a is None:
                continue
            if not isinstance(a, np.ndarray):
                a = a.numpy()
            if a.size == 0:
                continue
            self._count("nan_injects")
            a.flat[self._fetch_rng.randrange(a.size)] = 1 << 30
            return

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self.counts)
