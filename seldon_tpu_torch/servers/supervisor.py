"""Supervised fault recovery for the serving engine — port of
``seldon_tpu/servers/supervisor.py``, line for line.

Without it, ONE errored wave wipes every in-flight request: the engine's
``_fail_all`` fails all live streams with a retriable error and rebuilds
the device state, so a single transient fault becomes N user-visible
failures. The :class:`HealSupervisor` turns that sweep into a
*resurrection*: the engine still rebuilds its device state (the cache a
wrecked wave was writing is not trusted), but every innocent in-flight
request is re-queued with its committed tokens (prompt + generated so
far) folded into the prompt, and replays through the normal prefill /
chunked / ragged admission path on the same device, through the same
kernels. Per-position sampling keys — ``fold_in(key(seed), pos)`` over
the ABSOLUTE sequence position, independent of batch composition
(models/sampling.py) — make a replayed continuation the same stream as
an unfaulted run wherever the re-prefilled logits pick the same token
(greedy and sampled alike); a replay recomputes the folded tokens' KV by
prefill where the clean run had decoded it, so at a near-tie of the
logits it may part (ROADMAP.md C1).

Around resurrection, three guards:

 * poison quarantine — if a fault recurs right after a resurrection,
   some request in the cohort may be deterministically wrecking the
   wave (a poison prompt). The supervisor bisects: it resurrects one
   half of the suspect set (the *probing* set) and parks the rest in
   the pen; a recurring fault narrows suspects to the probes, clean
   progress exonerates them and probes the other half. The bisection
   converges in log2 rounds to a single request that faults when
   dispatched ALONE — that one fails with ``kind="poison"``,
   non-retriable, and everyone else is resurrected.
 * retry budget + backoff — each resurrection charges the request's
   ``heal_max_retries`` budget; exhaustion fails it cleanly
   (retriable=False). Repeat resurrections are penned behind an
   exponential backoff so a flapping device cannot spin the recovery
   loop.
 * dispatch watchdog — :meth:`HealSupervisor.bounded_fetch` runs the
   boundary fetch (the wait on the boundary's host-copy event) on a
   helper thread and bounds it with ``heal_watchdog_ms``; a hung fetch
   raises :class:`WatchdogError` into the engine's wreck path instead of
   wedging the scheduler. 0 disables the bound. What it recovers from
   is a fetch that stalls on the host (the chaos hang is a host sleep;
   the abandoned helper's late result is discarded). A CUDA kernel that
   never finishes cannot be recovered in-process: the rebuilt state's
   work queues behind it on the same stream.

Plus a NaN/garbage sentinel (:meth:`HealSupervisor.check_tokens`): every
sampler output is an index into the vocabulary and therefore in
[0, vocab) by construction, so any out-of-range id in a fetched
boundary's host buffers (numpy arrays or CPU tensors) is corruption —
:class:`SentinelError` trips the same recovery path before a corrupt
token reaches a client.

Health is a state machine — healthy → recovering (a fault happened,
replays in flight) → degraded (the episode quarantined or exhausted a
request) → healthy again after a clean-boundary streak — exported at
``/debug/health`` (+ the readiness detail) and as the
``torchserver_heal_*`` gauges, with a recovery-pressure term in the
pilot's signal snapshot.

:func:`build` returns None unless ``EngineConfig.heal`` or ``HEAL=1``:
a heal-off engine keeps ``self._heal = None`` and the raw ``_fail_all``
failure path.

Locking: the supervisor's own ``_lock`` is a leaf and acquires nothing
while held. Every mutating call except ``bounded_fetch`` / ``snapshot``
happens with the engine's ``_book`` held; the internal lock only makes
the watchdog counter and ``/debug/health`` snapshots coherent from other
threads.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Set

import numpy as np

logger = logging.getLogger(__name__)

# Health states.
HEALTHY = "healthy"
RECOVERING = "recovering"
DEGRADED = "degraded"

# Clean boundaries (with an empty pen, bisection resolved) before a
# recovering/degraded supervisor reports healthy again.
CLEAN_BOUNDARIES_FOR_HEALTHY = 8

# Backoff ceiling for repeat resurrections of the same request (s).
_BACKOFF_MAX_S = 0.5
_BACKOFF_BASE_S = 0.01


class WatchdogError(RuntimeError):
    """The boundary device fetch exceeded heal_watchdog_ms — the wave
    is declared faulted and enters the recovery path."""


class SentinelError(RuntimeError):
    """A fetched boundary carried out-of-vocab token ids — corrupt
    device results tripped recovery before reaching a client."""


class _PenEntry:
    """One parked resurrectee: released at `release_at` (backoff), or
    when `due` flips (bisection verdict / flush)."""

    __slots__ = ("req", "release_at", "due")

    def __init__(self, req: Any, release_at: Optional[float], due: bool):
        self.req = req
        self.release_at = release_at
        self.due = due


def build(ecfg: Any) -> Optional["HealSupervisor"]:
    """The engine's construction gate: a supervisor when
    `EngineConfig.heal` is set, else consult the HEAL=1 env gate
    (HEAL_MAX_RETRIES / HEAL_WATCHDOG_MS knobs), else None — and None
    means the engine carries zero heal code on any path."""
    if ecfg.heal:
        return HealSupervisor(
            max_retries=ecfg.heal_max_retries,
            watchdog_ms=ecfg.heal_watchdog_ms,
        )
    return from_env()


def from_env() -> Optional["HealSupervisor"]:
    """HEAL=1 master switch; knobs stay inert without it (a stray
    HEAL_WATCHDOG_MS in prod can't half-enable recovery)."""
    if os.environ.get("HEAL", "0") not in ("1", "true", "yes"):
        return None
    return HealSupervisor(
        max_retries=int(os.environ.get("HEAL_MAX_RETRIES", "4") or 4),
        watchdog_ms=int(os.environ.get("HEAL_WATCHDOG_MS", "0") or 0),
    )


class HealSupervisor:
    """Replay-based recovery policy + health state machine; one per
    engine. The engine keeps the mechanism (rebuilding device state,
    re-queueing requests); this class keeps the policy (who is
    resurrected, penned, quarantined, or exhausted — and when)."""

    def __init__(self, max_retries: int = 4, watchdog_ms: int = 0):
        self.max_retries = max(1, int(max_retries))
        self.watchdog_ms = max(0, int(watchdog_ms))
        self._lock = threading.Lock()  # leaf by convention: acquires nothing
        self.state = HEALTHY
        # Cumulative counters (the torchserver_heal_* gauges).
        self.resurrected = 0
        self.quarantined = 0
        self.watchdog_trips = 0
        self.retry_exhausted = 0
        self.sentinel_trips = 0
        self.recoveries = 0
        # Episode state.
        self.consec_faults = 0  # recoveries since the last healthy streak
        self.clean_boundaries = 0
        # Per-request resurrection budget spent (rid -> replays);
        # pruned at terminal time (note_done).
        self.retries: Dict[int, int] = {}
        # Bisection: mode "normal" until a fault recurs on a cohort that
        # was JUST resurrected; then "bisect" until a culprit is
        # convicted (poison) or every suspect is exonerated.
        self.mode = "normal"
        self.suspects: Set[int] = set()
        self.probing: Set[int] = set()
        self.prev_resurrected: Set[int] = set()
        self._pen: List[_PenEntry] = []
        # Watchdog worker (lazy; replaced wholesale when abandoned so an
        # orphaned hung fetch can never collide with a fresh call).
        self._wd_jobs: Optional["queue.Queue"] = None
        self._wd_results: Optional["queue.Queue"] = None
        self._wd_thread: Optional[threading.Thread] = None
        self._wd_token = 0

    def describe(self) -> str:
        return (f"HealSupervisor(max_retries={self.max_retries}, "
                f"watchdog_ms={self.watchdog_ms})")

    # --- recovery policy (engine scheduler thread, under _book) ------------

    def plan_recovery(self, rids: Sequence[int], now: float) -> Dict[int, str]:
        """Classify a faulted wave's live cohort. Returns rid ->
        verdict: "resurrect" (re-queue now), "pen" (park — backoff or
        bisection hold), "poison" (quarantine, non-retriable),
        "exhausted" (resurrection budget spent, non-retriable)."""
        with self._lock:
            cohort = set(rids)
            self.recoveries += 1
            self.consec_faults += 1
            self.clean_boundaries = 0
            if self.state == HEALTHY:
                self.state = RECOVERING
            poison: Set[int] = set()
            if self.mode == "bisect":
                if self.probing and self.probing <= cohort:
                    # The fault recurred while (at least) the probes were
                    # live — the culprit is among them.
                    self.suspects = set(self.probing)
                    if len(self.suspects) == 1:
                        # Faulted while dispatched alone: convicted.
                        poison = set(self.suspects)
                        self._exit_bisect_locked()
                # else: the probes already progressed out / finished;
                # an unrelated wave faulted — suspects stand.
            else:
                recurring = cohort & self.prev_resurrected
                if recurring:
                    # Second fault in a row over requests we just
                    # resurrected — start isolating.
                    self.mode = "bisect"
                    self.suspects = set(recurring)
            if self.mode == "bisect" and not poison:
                order = sorted(self.suspects & cohort) or sorted(self.suspects)
                half = max(1, len(order) // 2)
                self.probing = set(order[:half])
            else:
                self.probing = set()
            verdicts: Dict[int, str] = {}
            for rid in cohort:
                if rid in poison:
                    verdicts[rid] = "poison"
                    self.quarantined += 1
                    continue
                n = self.retries.get(rid, 0) + 1
                self.retries[rid] = n
                if n > self.max_retries:
                    verdicts[rid] = "exhausted"
                    self.retry_exhausted += 1
                elif self.mode == "bisect":
                    # Only probes run during a bisection round; everyone
                    # else (suspect or innocent) waits in the pen so a
                    # recurring fault implicates exactly the probes.
                    verdicts[rid] = (
                        "resurrect" if rid in self.probing else "pen"
                    )
                elif n >= 2:
                    verdicts[rid] = "pen"  # repeat replay: backoff first
                else:
                    verdicts[rid] = "resurrect"
            self.prev_resurrected = {
                r for r, v in verdicts.items() if v in ("resurrect", "pen")
            }
            if poison or "exhausted" in verdicts.values():
                self.state = DEGRADED
            return verdicts

    def backoff_s(self) -> float:
        """Pen delay for repeat resurrections, exponential in the
        consecutive-fault streak."""
        with self._lock:
            n = max(0, self.consec_faults - 1)
        return min(_BACKOFF_MAX_S, _BACKOFF_BASE_S * (2 ** min(n, 8)))

    def note_resurrected(self) -> None:
        with self._lock:
            self.resurrected += 1

    # --- pen ----------------------------------------------------------------

    def pen_put(self, req: Any, now: float) -> None:
        """Park a prepared resurrectee. Bisection holds have no release
        time (a verdict flips them due); backoff holds release on the
        clock. A request the bisection already probes is due at once:
        the bisection may advance onto it while the engine is still
        placing a recovery's cohort (a probe of that cohort finished or
        spent its budget), before this put, and nothing else would
        release it. (The JAX twin parks it with no release, which holds
        the pen until an unrelated terminal event: ROADMAP.md C17.)"""
        with self._lock:
            if self.mode == "bisect":
                self._pen.append(
                    _PenEntry(req, None, req.rid in self.probing))
            else:
                n = max(0, self.consec_faults - 1)
                delay = min(
                    _BACKOFF_MAX_S, _BACKOFF_BASE_S * (2 ** min(n, 8))
                )
                self._pen.append(_PenEntry(req, now + delay, False))

    def pen_take(self, now: float, flush: bool = False) -> List[Any]:
        """Pop every pen entry due for release (backoff elapsed,
        bisection verdict, or `flush` — drain/shutdown releases the
        whole pen so nothing is stranded). Finished entries are
        dropped, not returned."""
        with self._lock:
            out: List[Any] = []
            keep: List[_PenEntry] = []
            for e in self._pen:
                if getattr(e.req, "finished", False):
                    continue  # reaped/cancelled while penned
                if flush or e.due or (
                    e.release_at is not None and now >= e.release_at
                ):
                    out.append(e.req)
                else:
                    keep.append(e)
            self._pen = keep
            return out

    def pen_scan(self) -> List[Any]:
        """Snapshot of every parked request (for cancel/deadline
        reaping — penned requests are in neither _slots nor _waiting,
        so the engine's regular reap cannot see them)."""
        with self._lock:
            return [e.req for e in self._pen]

    def pen_drop(self, rid: int) -> None:
        with self._lock:
            self._pen = [e for e in self._pen if e.req.rid != rid]

    def pen_empty(self) -> bool:
        with self._lock:
            return not self._pen

    # --- innocence / lifecycle signals --------------------------------------

    def note_progress(self, rid: int) -> None:
        """A (re)admitted request produced a token. During a bisection
        round, progress from every probe exonerates them — the fault
        did not recur with the probes live — and advances to the next
        half."""
        if self.mode != "bisect":  # cheap racy read; bisect re-checks
            return
        with self._lock:
            if self.mode != "bisect" or rid not in self.probing:
                return
            self.probing.discard(rid)
            self.suspects.discard(rid)
            if not self.probing:
                self._advance_bisect_locked()

    def note_done(self, rid: int) -> None:
        """Terminal bookkeeping: forget the request's retry budget and
        resolve any bisection interest in it."""
        with self._lock:
            self.retries.pop(rid, None)
            if self.mode != "bisect":
                return
            touched = rid in self.probing or rid in self.suspects
            self.probing.discard(rid)
            self.suspects.discard(rid)
            if touched and not self.probing:
                self._advance_bisect_locked()

    def _advance_bisect_locked(self) -> None:
        """Current probe set resolved clean — probe the next half of
        the remaining suspects, or exit if everyone is exonerated."""
        if not self.suspects:
            self._exit_bisect_locked()
            return
        order = sorted(self.suspects)
        half = max(1, len(order) // 2)
        self.probing = set(order[:half])
        for e in self._pen:
            if e.req.rid in self.probing:
                e.due = True  # released by the engine's next heal tick

    def _exit_bisect_locked(self) -> None:
        self.mode = "normal"
        self.suspects = set()
        self.probing = set()
        for e in self._pen:
            e.due = True

    def note_boundary_ok(self) -> None:
        """A boundary fetched and processed cleanly. A streak of these
        (with the pen empty and no bisection pending) walks
        recovering/degraded back to healthy."""
        if self.state == HEALTHY:
            return  # racy cheap read; the transition below re-checks
        with self._lock:
            if self.state == HEALTHY:
                return
            self.clean_boundaries += 1
            if (self.clean_boundaries >= CLEAN_BOUNDARIES_FOR_HEALTHY
                    and self.mode == "normal" and not self._pen):
                self.state = HEALTHY
                self.consec_faults = 0
                self.prev_resurrected = set()

    # --- watchdog (fetcher OR scheduler thread; no engine lock needed) ------

    def _spawn_worker_locked(self) -> None:
        self._wd_jobs = queue.Queue()
        self._wd_results = queue.Queue()
        jobs, results = self._wd_jobs, self._wd_results

        def run() -> None:
            while True:
                token, fn = jobs.get()
                try:
                    results.put((token, True, fn()))
                except BaseException as e:  # delivered to the caller
                    results.put((token, False, e))

        self._wd_thread = threading.Thread(
            target=run, daemon=True, name="heal-watchdog-fetch"
        )
        self._wd_thread.start()

    def bounded_fetch(self, fn: Callable[[], Any]) -> Any:
        """Run `fn` (the boundary device fetch) bounded by
        `watchdog_ms`. On timeout the worker is abandoned wholesale —
        queues and all, so its eventual orphan result can never collide
        with a later call — and `WatchdogError` unwinds into the
        engine's wreck path. watchdog_ms=0 runs `fn` inline."""
        if self.watchdog_ms <= 0:
            return fn()
        with self._lock:
            if self._wd_thread is None or not self._wd_thread.is_alive():
                self._spawn_worker_locked()
            self._wd_token += 1
            token = self._wd_token
            jobs, results = self._wd_jobs, self._wd_results
        jobs.put((token, fn))
        deadline = self.watchdog_ms / 1000.0
        while True:
            try:
                got_token, ok, val = results.get(timeout=deadline)
            except queue.Empty:
                with self._lock:
                    self.watchdog_trips += 1
                    # Abandon the wedged worker; next call spawns fresh.
                    self._wd_thread = None
                    self._wd_jobs = None
                    self._wd_results = None
                raise WatchdogError(
                    f"boundary fetch exceeded heal_watchdog_ms="
                    f"{self.watchdog_ms} — wave declared faulted"
                )
            if got_token != token:
                continue  # stale result from an abandoned call
            if ok:
                return val
            raise val

    # --- sentinel ------------------------------------------------------------

    def check_tokens(self, admit_data: Sequence, chunk_data: Any,
                     vocab_size: int) -> None:
        """Host-side garbage screen on one fetched boundary: every
        sampler output is an index into the vocabulary, hence in
        [0, vocab) by construction — any out-of-range id is corruption
        (a garbage copy or a poisoned buffer). ``admit_data`` holds each
        admission group's (first, done) host buffers, ``chunk_data`` the
        decode leg's (toks, valid, active) or None; numpy arrays or CPU
        tensors (``np.asarray`` views them without a copy). Raises
        SentinelError into the recovery path BEFORE the tokens reach a
        client queue."""
        bad = None
        for first_h, _ in admit_data:
            a = np.asarray(first_h)
            if a.size and (
                (a < 0).any() or (a >= vocab_size).any()
            ):
                bad = int(a.flat[int(
                    np.argmax((a < 0) | (a >= vocab_size))
                )])
                break
        if bad is None and chunk_data is not None:
            t = np.asarray(chunk_data[0])
            if t.size and ((t < 0).any() or (t >= vocab_size).any()):
                bad = int(t.flat[int(
                    np.argmax((t < 0) | (t >= vocab_size))
                )])
        if bad is not None:
            with self._lock:
                self.sentinel_trips += 1
            raise SentinelError(
                f"sentinel: fetched token id {bad} outside "
                f"[0, {vocab_size}) — corrupt boundary quarantined "
                f"before reaching a client"
            )

    # --- observability -------------------------------------------------------

    def pressure(self) -> float:
        """Recovery-pressure level for the pilot's signal snapshot:
        0.0 healthy, 0.5 while replays are in flight, 1.0 once the
        episode cost a request (quarantine / budget exhaustion)."""
        s = self.state
        return 0.0 if s == HEALTHY else (0.5 if s == RECOVERING else 1.0)

    def snapshot(self) -> Dict[str, Any]:
        """The frozen /debug/health schema (the JAX package's
        tests/test_debug_schema.py pins the key set)."""
        with self._lock:
            return {
                "enabled": True,
                "state": self.state,
                "mode": self.mode,
                "max_retries": self.max_retries,
                "watchdog_ms": self.watchdog_ms,
                "resurrected": self.resurrected,
                "quarantined": self.quarantined,
                "watchdog_trips": self.watchdog_trips,
                "retry_exhausted": self.retry_exhausted,
                "sentinel_trips": self.sentinel_trips,
                "recoveries": self.recoveries,
                "consecutive_faults": self.consec_faults,
                "clean_boundaries": self.clean_boundaries,
                "pen": len(self._pen),
                "suspects": sorted(self.suspects),
                "probing": sorted(self.probing),
                "pressure": (
                    0.0 if self.state == HEALTHY
                    else (0.5 if self.state == RECOVERING else 1.0)
                ),
            }
