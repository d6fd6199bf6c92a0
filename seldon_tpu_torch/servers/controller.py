"""graftpilot: the observatory becomes the scheduler's controller — port
of ``seldon_tpu/servers/controller.py``, line for line.

The ledgers give the signals — queue-wait decomposition by cause,
budget starvation counts, pool-stall events, SLO margin accounting.
This module feeds them back: a bounded feedback controller that runs at
scheduler-boundary cadence under ``_book`` and (a) auto-tunes
``dispatch_token_budget``, the adaptive chunk rung, and admission
aggressiveness from the measured pool-stall / budget-contention /
bucket-mismatch split, and (b) replaces FIFO dispatch ordering with
EDF-style deadline priority (no-deadline requests carry a virtual
deadline ``submitted_at + AGE_HORIZON_S``, so aging makes starvation
impossible).  The observability half is the headline: every control
action lands in a **decision ledger** with the signal window that
triggered it, a human-readable rationale, and counterfactual
accounting — the goodput/waste deltas of the decision window that
followed — so an operator can audit exactly why the scheduler moved a
knob and whether the move paid.

Control discipline (why the pilot can never misbehave):

 * **clamped ranges** — every knob moves only inside an envelope fixed
   at bind time from the validated ``EngineConfig``: the budget stays a
   multiple of ``prefill_chunk`` in ``[prefill_chunk, max_slots *
   prefill_chunk]`` (the ``__post_init__`` invariant), the admit cap
   stays a power of two in ``[1, max_admit]`` (admission groups pad to
   pow2), the chunk bias stays in ``[-1, +1]`` rungs;
 * **hysteresis** — raise and lower thresholds are separated bands
   (e.g. budget raises at >= 50% starved passes, lowers at <= 12.5%
   with utilization under half), and recovery moves additionally
   require ``RECOVER_WINDOWS`` consecutive calm windows;
 * **cooldowns** — after any move a knob freezes for
   ``COOLDOWN_WINDOWS`` decision windows, so cause and measured effect
   stay attributable and the loop cannot oscillate faster than it can
   observe.

Concurrency contract (the compile-ledger discipline, applied again):

 * ``PILOT=1`` enables the full loop; ``PILOT=hold`` keeps EDF ordering
   and the ledger live but freezes every knob at its initial value (how
   an operator pins hand-tuned knobs and still flies the deadline
   scheduler); anything else -> ``from_env()`` returns None and the
   engine keeps a None attribute plus the raw dispatch path — zero
   hot-path cost when off.  ``PILOT=1`` implies the sched ledger (it is
   the controller's signal source): the engine builds one even without
   ``SCHED_LEDGER=1``.
 * All mutable controller state is ``guarded-by(_book)``: mutators run
   on the scheduler thread under the bookkeeping lock (annotated
   ``holds(_book)``), and ``snapshot()`` is served by
   ``InferenceEngine.debug_pilot`` which takes ``_book`` itself.  The
   controller acquires no locks of its own, so it cannot extend the
   documented lock order.
 * Greedy outputs are BIT-IDENTICAL pilot-on-vs-off at fixed knobs:
   batched kernel rows are independent, so EDF admission reordering
   never changes a request's own token stream, and at the neutral
   defaults every knob read resolves to exactly the config value the
   raw path would have used.

``snapshot()`` is the documented ``/debug/pilot`` schema::

    {
      "enabled": true,
      "mode": "auto" | "hold",
      "boundaries": int,          # dispatched boundaries observed
      "windows": int,             # decision windows evaluated
      "period_boundaries": int,   # boundaries per decision window
      "decisions_total": int,
      "decisions_by_knob": {"dispatch_token_budget": int,
                            "max_admit": int, "chunk_bias": int,
                            "spec_k": int},
      "knobs": {"dispatch_token_budget": int,   # live values the
                "max_admit": int,               # scheduler reads
                "chunk_bias": int,
                "spec_k": int},    # 0 when spec decoding is off
      "envelope": {"budget_min": int, "budget_max": int,
                   "admit_min": int, "admit_max": int,
                   "bias_min": int, "bias_max": int,
                   "speck_min": int, "speck_max": int},
      "edf": {"inversions": int,      # out-of-order adjacent pairs
              "reorders": int,        #   repaired across all sorts
              "expired_at_pop": int}, # expired heads shed at pop time
      "counterfactual": {"windows": int,        # decision windows with
                         "goodput_delta": float,  # a measured effect,
                         "waste_frac_delta": float},  # summed deltas
      "ledger": [                  # oldest-first, bounded
        {"ts": float,              # wall-clock seconds
         "knob": str, "old": int, "new": int,
         "rationale": str,         # what the signals said
         "expected_effect": str,   # what the move should buy
         "signal_snapshot": {      # the decision window's deltas
           "boundaries": int, "dispatch_cells": int,
           "useful_tokens": int, "frag_tokens": int,
           "budget_dispatches": int, "budget_starved_passes": int,
           "budget_offered_tokens": int, "budget_used_tokens": int,
           "pool_stall_events": int, "preemptions": int,
           "deadline_expired": int,
           "spec_drafted": int, "spec_accepted": int,
           "goodput": float,
           "queue_depth": int, "free_slots": int,
           "roof_backlog_ms": float,   # graftroof queue cost (0 when
                                       # ROOF_LEDGER is off)
           "heal_pressure": float},    # graftheal recovery pressure
                                       # (0 when HEAL is off)
         "effect": null | {"goodput_delta": float,
                           "waste_frac_delta": float}},
        ...
      ],
    }

Consumers: the ``/debug/pilot`` route (runtime/wrapper.py),
torchserver's ``torchserver_pilot_*`` Prometheus gauges and
flight-recorder "pilot" records (one per decision). The key sets are
the JAX controller's, frozen by its schema goldens — change both
packages together.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

# Boundaries per decision window: long enough that one window sees a
# full admission wave on the tiny test engines, short enough that the
# CI audit converges inside a two-second load run.
PERIOD_BOUNDARIES = 8
# A knob that moved freezes for this many windows (cooldown).
COOLDOWN_WINDOWS = 2
# Recovery moves (re-raising admit, relaxing chunk bias) additionally
# need this many consecutive calm windows (hysteresis).
RECOVER_WINDOWS = 2
# Budget hysteresis band: raise at >= HI starved-pass fraction, lower
# at <= LO with utilization under BUDGET_SURPLUS_UTIL.
STARVED_HI = 0.5
STARVED_LO = 0.125
BUDGET_SURPLUS_UTIL = 0.5
# Admission hysteresis: lower on any pool stall / preemption in the
# window (the pool is telling the truth), recover only after calm.
# Speculation-depth hysteresis band: raise the draft rung when the
# window's acceptance rate clears HI, lower when it drops under LO.
# The wide gap is the point — acceptance is workload-phase noisy, and
# a rung move retraces nothing (both rungs are pre-warmed lattice
# variants), so the only cost of patience is a slightly-stale k.
SPEC_ACCEPT_HI = 0.8
SPEC_ACCEPT_LO = 0.4
# Virtual deadline for requests that carry none: starvation-proof aging
# — after this many seconds queued, a no-deadline request outranks any
# deadline further out than its age.
AGE_HORIZON_S = 10.0
# Decision ledger bound (oldest entries drop; counters never reset).
LEDGER_CAP = 256

KNOB_BUDGET = "dispatch_token_budget"
KNOB_ADMIT = "max_admit"
KNOB_BIAS = "chunk_bias"
KNOB_SPECK = "spec_k"

# The cumulative counters a signal snapshot windows over.
_DELTA_KEYS = (
    "boundaries", "dispatch_cells", "useful_tokens", "frag_tokens",
    "budget_dispatches", "budget_starved_passes",
    "budget_offered_tokens", "budget_used_tokens",
    "pool_stall_events", "preemptions", "deadline_expired",
    "spec_drafted", "spec_accepted",
)
# Instantaneous signals copied into the window as-is. roof_backlog_ms
# is the graftroof cost model's predicted service time of the queue
# (0.0 whenever ROOF_LEDGER is off) — the level a cost-model tier
# router conditions on. heal_pressure is the graftheal supervisor's
# recovery-pressure level (0.0 healthy / 0.5 recovering / 1.0
# degraded; 0.0 whenever HEAL is off) — a pilot conditioning on it can
# back off admissions while replays drain.
_LEVEL_KEYS = ("goodput", "queue_depth", "free_slots",
               "roof_backlog_ms", "heal_pressure")


def from_env() -> Optional["PilotController"]:
    """PILOT=1 -> full controller; PILOT=hold -> EDF + ledger with every
    knob frozen (operator pin); anything else -> None (and the engine
    keeps the raw dispatch path — zero hot-path cost)."""
    val = os.environ.get("PILOT", "0")
    if val in ("1", "true", "True"):
        return PilotController(hold=False)
    if val == "hold":
        return PilotController(hold=True)
    return None


class PilotController:
    """Bounded scheduler feedback controller with a decision ledger.

    Mutable state below is guarded-by(_book) by contract: every mutator
    is annotated ``holds(_book)`` and called only from the scheduler's
    boundary path (or from ``debug_pilot``, which takes the lock)."""

    def __init__(self, hold: bool = False):
        self.hold = hold
        self.period = PERIOD_BOUNDARIES
        self.age_horizon_s = AGE_HORIZON_S
        # Envelope — fixed at bind() time from the validated config.
        self.chunked = False
        self.budget_min = 0
        self.budget_max = 0
        self.admit_min = 1
        self.admit_max = 1
        self.bias_min = -1
        self.bias_max = 1
        # Speculation-depth envelope: the engine's pow2 rung ladder.
        # Empty () means spec decoding is off and the knob is inert.
        self.spec = False
        self.speck_rungs: Tuple[int, ...] = ()
        # Live knob values the scheduler reads (via the accessor
        # methods, so cross-class field access never leaks).
        self._pl_budget = 0  # graftlint: guarded-by(_book)
        self._pl_admit = 1  # graftlint: guarded-by(_book)
        self._pl_bias = 0  # graftlint: guarded-by(_book)
        self._pl_speck = 0  # graftlint: guarded-by(_book)
        # Controller bookkeeping.
        self._pl_boundaries = 0  # graftlint: guarded-by(_book)
        self._pl_windows = 0  # graftlint: guarded-by(_book)
        self._pl_prev: Optional[Dict[str, float]] = None  # graftlint: guarded-by(_book)
        self._pl_cool: Dict[str, int] = {  # graftlint: guarded-by(_book)
            KNOB_BUDGET: 0, KNOB_ADMIT: 0, KNOB_BIAS: 0, KNOB_SPECK: 0,
        }
        self._pl_calm = 0  # consecutive stall-free windows  # graftlint: guarded-by(_book)
        self._pl_meet = 0  # consecutive expiry-free windows  # graftlint: guarded-by(_book)
        self._pl_counts: Dict[str, int] = {  # graftlint: guarded-by(_book)
            KNOB_BUDGET: 0, KNOB_ADMIT: 0, KNOB_BIAS: 0, KNOB_SPECK: 0,
        }
        self._pl_ledger: Deque[Dict[str, Any]] = collections.deque(  # graftlint: guarded-by(_book)
            maxlen=LEDGER_CAP
        )
        # Decisions whose effect window is still open, paired with the
        # window metrics at decision time: (entry, goodput, waste_frac).
        self._pl_open: List[Tuple[Dict[str, Any], float, float]] = []  # graftlint: guarded-by(_book)
        self._pl_cf_windows = 0  # graftlint: guarded-by(_book)
        self._pl_cf_goodput = 0.0  # graftlint: guarded-by(_book)
        self._pl_cf_waste = 0.0  # graftlint: guarded-by(_book)
        # EDF accounting.
        self._pl_inversions = 0  # graftlint: guarded-by(_book)
        self._pl_reorders = 0  # graftlint: guarded-by(_book)
        self._pl_expired_pops = 0  # graftlint: guarded-by(_book)

    # --- wiring -------------------------------------------------------------

    def bind(self, *, chunked: bool, prefill_chunk: int, max_slots: int,  # graftlint: holds(_book)
             max_admit: int, dispatch_token_budget: int,
             spec: bool = False,
             spec_rungs: Tuple[int, ...] = ()) -> None:
        """Capture the validated config envelope.  Called from engine
        __init__ before the engine is published to other threads (the
        lock-guard __init__ exemption applies on the engine side)."""
        self.chunked = bool(chunked)
        self.spec = bool(spec) and bool(spec_rungs)
        if self.spec:
            self.speck_rungs = tuple(spec_rungs)
            # Neutral default: the deepest rung, exactly what the raw
            # path uses — pilot-on-at-defaults drafts identical waves.
            self._pl_speck = self.speck_rungs[-1]
        if self.chunked:
            self.budget_min = prefill_chunk
            self.budget_max = max(prefill_chunk, max_slots * prefill_chunk)
            # Neutral default: exactly the effective budget the raw
            # path computes, so pilot-on-at-defaults dispatches the
            # same waves as pilot-off.
            self._pl_budget = min(
                max(dispatch_token_budget or prefill_chunk,
                    self.budget_min),
                self.budget_max,
            )
        self.admit_max = max(1, max_admit)
        self._pl_admit = self.admit_max

    # --- knob reads (scheduler hot path, under _book) -----------------------

    def dispatch_budget(self) -> int:  # graftlint: holds(_book)
        """Live dispatch_token_budget (already defaulted: never 0 on a
        chunked engine)."""
        return self._pl_budget

    def admit_cap(self) -> int:  # graftlint: holds(_book)
        """Live admission group-size cap (power of two)."""
        return self._pl_admit

    def chunk_bias(self) -> int:  # graftlint: holds(_book)
        """Adaptive-chunk rung bias in [bias_min, bias_max]."""
        return self._pl_bias

    def spec_k(self, current: int) -> int:  # graftlint: holds(_book)
        """Live speculation depth (a rung from the bound ladder).
        Inert passthrough when spec was never bound."""
        if not self.spec:
            return current
        return self._pl_speck

    # --- EDF ordering -------------------------------------------------------

    def _edf_key(self, req: Any) -> float:
        d = req.deadline
        return d if d is not None else req.submitted_at + self.age_horizon_s

    def order_queue(self, waiting: Deque[Any]) -> Deque[Any]:  # graftlint: holds(_book)
        """Earliest-effective-deadline-first ordering of the admission
        queue.  Stable: equal keys keep FIFO order, so an all-no-
        deadline queue (monotone submit times) is returned untouched —
        including the exact same deque object, keeping the FIFO
        workload's dispatch byte-identical."""
        if len(waiting) < 2:
            return waiting
        keys = [self._edf_key(r) for r in waiting]
        inv = sum(1 for a, b in zip(keys, keys[1:]) if a > b)
        if not inv:
            return waiting
        self._pl_inversions += inv
        self._pl_reorders += 1
        return collections.deque(
            sorted(waiting, key=self._edf_key)
        )

    def note_expired_pop(self) -> None:  # graftlint: holds(_book)
        """An expired head was shed at pop time instead of displacing a
        viable request (the EDF pop-time margin re-check)."""
        self._pl_expired_pops += 1

    # --- control loop -------------------------------------------------------

    def on_boundary(  # graftlint: holds(_book)
        self, signals_fn: Callable[[], Dict[str, float]]
    ) -> List[Dict[str, Any]]:
        """One dispatched scheduler boundary.  Every ``period``
        boundaries, close the decision window: snapshot the cumulative
        signals, attribute the previous window's goodput/waste deltas
        to the decisions that opened it, and (unless holding) evaluate
        the control rules.  Returns the new decision entries so the
        engine can mirror them into the flight recorder."""
        self._pl_boundaries += 1
        if self._pl_boundaries % self.period:
            return []
        sig = signals_fn()
        prev, self._pl_prev = self._pl_prev, sig
        self._pl_windows += 1
        if prev is None:
            return []
        window: Dict[str, Any] = {
            k: sig[k] - prev[k] for k in _DELTA_KEYS
        }
        for k in _LEVEL_KEYS:
            window[k] = sig[k]
        cells = window["dispatch_cells"]
        waste = (
            1.0 - window["useful_tokens"] / cells if cells > 0 else 0.0
        )
        self._close_effects(float(sig["goodput"]), waste)
        for knob in self._pl_cool:
            if self._pl_cool[knob] > 0:
                self._pl_cool[knob] -= 1
        stalled = (
            window["pool_stall_events"] > 0 or window["preemptions"] > 0
        )
        self._pl_calm = 0 if stalled else self._pl_calm + 1
        expired = window["deadline_expired"] > 0
        self._pl_meet = 0 if expired else self._pl_meet + 1
        if self.hold:
            return []
        decisions: List[Dict[str, Any]] = []
        decisions += self._rule_budget(window)
        decisions += self._rule_admit(window, stalled)
        decisions += self._rule_bias(window, expired)
        decisions += self._rule_speck(window)
        for entry in decisions:
            self._pl_open.append(
                (entry, float(sig["goodput"]), waste)
            )
        return decisions

    def _close_effects(self, goodput: float, waste: float) -> None:  # graftlint: holds(_book)
        """Counterfactual accounting: the window that just closed is
        the effect window of the decisions taken when it opened."""
        if not self._pl_open:
            return
        for entry, g0, w0 in self._pl_open:
            dg = round(goodput - g0, 4)
            dw = round(waste - w0, 4)
            entry["effect"] = {
                "goodput_delta": dg, "waste_frac_delta": dw,
            }
            self._pl_cf_windows += 1
            self._pl_cf_goodput += dg
            self._pl_cf_waste += dw
        self._pl_open = []

    def _decide(  # graftlint: holds(_book)
        self, knob: str, old: int, new: int, rationale: str,
        expected: str, window: Dict[str, Any]
    ) -> List[Dict[str, Any]]:
        entry = {
            "ts": round(time.time(), 3),
            "knob": knob,
            "old": int(old),
            "new": int(new),
            "rationale": rationale,
            "expected_effect": expected,
            "signal_snapshot": {
                k: (round(float(v), 4) if isinstance(v, float) else int(v))
                for k, v in window.items()
            },
            "effect": None,
        }
        self._pl_ledger.append(entry)
        self._pl_counts[knob] += 1
        self._pl_cool[knob] = COOLDOWN_WINDOWS
        # Apply: the live knob value IS the decision (rules only ever
        # propose values already clamped to the envelope).
        if knob == KNOB_BUDGET:
            self._pl_budget = int(new)
        elif knob == KNOB_ADMIT:
            self._pl_admit = int(new)
        elif knob == KNOB_SPECK:
            self._pl_speck = int(new)
        else:
            self._pl_bias = int(new)
        return [entry]

    def _rule_budget(self, w: Dict[str, Any]) -> List[Dict[str, Any]]:  # graftlint: holds(_book)
        """Budget contention vs surplus, from the sched ledger's starved
        budget passes (the budget_ms wait component's source)."""
        if not self.chunked or self._pl_cool[KNOB_BUDGET]:
            return []
        passes = w["budget_dispatches"]
        if passes <= 0:
            return []
        starved_frac = w["budget_starved_passes"] / passes
        offered = w["budget_offered_tokens"]
        util = w["budget_used_tokens"] / offered if offered > 0 else 1.0
        old = self._pl_budget
        if starved_frac >= STARVED_HI and old < self.budget_max:
            new = min(old * 2, self.budget_max)
            return self._decide(
                KNOB_BUDGET, old, new,
                f"budget starved in {w['budget_starved_passes']}/{passes} "
                f"passes with {w['queue_depth']} queued",
                "more prefill tokens per dispatch; fewer starved passes, "
                "lower budget_ms queue wait",
                w,
            )
        if (starved_frac <= STARVED_LO and util <= BUDGET_SURPLUS_UTIL
                and old > self.budget_min):
            new = max(old // 2, self.budget_min)
            return self._decide(
                KNOB_BUDGET, old, new,
                f"budget surplus: {util:.0%} utilization, "
                f"{w['budget_starved_passes']}/{passes} starved passes",
                "shorter dispatches at equal throughput; tighter "
                "admission-boundary latency",
                w,
            )
        return []

    def _rule_admit(  # graftlint: holds(_book)
        self, w: Dict[str, Any], stalled: bool
    ) -> List[Dict[str, Any]]:
        """Admission aggressiveness from pool pressure: stalls and
        preemptions say the KV pool cannot absorb the group size."""
        if self._pl_cool[KNOB_ADMIT]:
            return []
        old = self._pl_admit
        if stalled and old > self.admit_min:
            new = max(old // 2, self.admit_min)
            return self._decide(
                KNOB_ADMIT, old, new,
                f"pool pressure: {w['pool_stall_events']} stalls, "
                f"{w['preemptions']} preemptions in the window",
                "smaller admission groups; fewer pool stalls and "
                "preempted tokens",
                w,
            )
        if (not stalled and self._pl_calm >= RECOVER_WINDOWS
                and old < self.admit_max):
            new = min(old * 2, self.admit_max)
            return self._decide(
                KNOB_ADMIT, old, new,
                f"pool calm for {self._pl_calm} windows",
                "larger admission groups; better batching at unchanged "
                "pool pressure",
                w,
            )
        return []

    def _rule_bias(  # graftlint: holds(_book)
        self, w: Dict[str, Any], expired: bool
    ) -> List[Dict[str, Any]]:
        """Chunk-rung bias from deadline pressure: admissions happen
        only at chunk boundaries, so expiries under load argue for
        shorter chunks (the EDF queue re-evaluates sooner)."""
        if self._pl_cool[KNOB_BIAS]:
            return []
        old = self._pl_bias
        if expired and old > self.bias_min:
            new = old - 1
            return self._decide(
                KNOB_BIAS, old, new,
                f"{w['deadline_expired']} deadline expiries in the window",
                "shorter decode chunks; more admission boundaries for "
                "the EDF queue to act on",
                w,
            )
        if not expired and self._pl_meet >= RECOVER_WINDOWS and old < 0:
            new = old + 1
            return self._decide(
                KNOB_BIAS, old, new,
                f"no expiries for {self._pl_meet} windows",
                "longer decode chunks; amortize the host round trip "
                "again",
                w,
            )
        return []

    def _rule_speck(self, w: Dict[str, Any]) -> List[Dict[str, Any]]:  # graftlint: holds(_book)
        """Speculation depth from the window's measured acceptance
        rate: drafts the target keeps are nearly free tokens, drafts
        it rejects are pure verify-lane waste, so k should track how
        predictable the current traffic actually is."""
        if not self.spec or self._pl_cool[KNOB_SPECK]:
            return []
        drafted = w["spec_drafted"]
        if drafted <= 0:
            return []
        rate = w["spec_accepted"] / drafted
        old = self._pl_speck
        i = self.speck_rungs.index(old)
        if rate >= SPEC_ACCEPT_HI and i + 1 < len(self.speck_rungs):
            new = self.speck_rungs[i + 1]
            return self._decide(
                KNOB_SPECK, old, new,
                f"acceptance {rate:.0%} over {int(drafted)} drafted "
                f"tokens clears {SPEC_ACCEPT_HI:.0%}",
                "deeper drafts; more accepted tokens per verify "
                "dispatch at unchanged fidelity",
                w,
            )
        if rate <= SPEC_ACCEPT_LO and i > 0:
            new = self.speck_rungs[i - 1]
            return self._decide(
                KNOB_SPECK, old, new,
                f"acceptance {rate:.0%} over {int(drafted)} drafted "
                f"tokens under {SPEC_ACCEPT_LO:.0%}",
                "shallower drafts; less rejected-token waste in the "
                "verify lane",
                w,
            )
        return []

    # --- export -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:  # graftlint: holds(_book)
        """The documented /debug/pilot schema (module docstring).
        Served by InferenceEngine.debug_pilot, which takes _book."""
        return {
            "enabled": True,
            "mode": "hold" if self.hold else "auto",
            "boundaries": self._pl_boundaries,
            "windows": self._pl_windows,
            "period_boundaries": self.period,
            "decisions_total": sum(self._pl_counts.values()),
            "decisions_by_knob": dict(self._pl_counts),
            "knobs": {
                KNOB_BUDGET: self._pl_budget,
                KNOB_ADMIT: self._pl_admit,
                KNOB_BIAS: self._pl_bias,
                KNOB_SPECK: self._pl_speck,
            },
            "envelope": {
                "budget_min": self.budget_min,
                "budget_max": self.budget_max,
                "admit_min": self.admit_min,
                "admit_max": self.admit_max,
                "bias_min": self.bias_min,
                "bias_max": self.bias_max,
                "speck_min": self.speck_rungs[0] if self.spec else 0,
                "speck_max": self.speck_rungs[-1] if self.spec else 0,
            },
            "edf": {
                "inversions": self._pl_inversions,
                "reorders": self._pl_reorders,
                "expired_at_pop": self._pl_expired_pops,
            },
            "counterfactual": {
                "windows": self._pl_cf_windows,
                "goodput_delta": round(self._pl_cf_goodput, 4),
                "waste_frac_delta": round(self._pl_cf_waste, 4),
            },
            "ledger": [dict(e) for e in self._pl_ledger],
        }
