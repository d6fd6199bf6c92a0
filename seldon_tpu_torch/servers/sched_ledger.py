"""Scheduler waste ledger — port of ``seldon_tpu/servers/sched_ledger.py``,
line for line: where the goodput gap goes, boundary by boundary.

The compile ledger says what compiled and the flight recorder says what
ran; neither says why dispatched capacity was not useful tokens.  This
ledger attributes every token-slot the scheduler offered to exactly one
of: useful prompt/chunk work, bucket padding (a prompt or chunk rounded
up to its lattice bucket), group padding (admission groups replicated
up to the next power of two), or — under SPEC=1 — rejected draft
positions (verify-wave slots whose proposed token the target refused;
graftspec's speculative price, the fourth waste category).  Chunked-
prefill budget passes additionally
record fragmentation — dispatch-token-budget left on the table while
prefill work was still queued — and scheduler ticks with nothing to do
at all count as idle boundaries.  Alongside the token ledger it keeps a
queue-wait decomposition: each request's submit -> first-dispatch wait
is split into pool-stall / bucket-mismatch / budget-contention /
scheduler-interval components at attribution time, each clamped so the
components always sum to the measured wait.

Design constraints (the compile-ledger discipline, applied again):

 * every mutator runs on the scheduler thread — dispatch taps, budget
   accounting and wait attribution under ``_book``, idle ticks on the
   loop between dispatches — single-writer, GIL-atomic stores, no
   locks, no blocking, no device access.
 * ``audit()`` runs under ``_book`` next to graftsan's boundary audits
   and checks the conservation invariants below; ``snapshot()`` (debug
   route thread) tolerates a torn *window*, never a torn record.
 * env-only gating: ``SCHED_LEDGER=1`` enables it; off -> ``from_env()``
   returns None and the engine keeps a None attribute plus the raw
   dispatch path — zero hot-path cost, not even a branch inside the
   dispatch sequence.

Conservation invariants (checked by ``audit()``):

 * ``useful_tokens + bucket_pad_tokens + group_pad_tokens +
   spec_rejected_tokens == dispatch_cells`` — every offered token-slot
   attributed, exactly;
 * ``spec.accepted_tokens + spec.rejected_tokens ==
   spec.drafted_tokens`` — every drafted token resolved one way;
 * ``frag_tokens <= budget_offered_tokens - budget_used_tokens`` —
   fragmentation only counts budget left while work was still queued;
 * the wait components sum to the total measured wait within 1%.

``snapshot()`` is the documented ``/debug/sched`` schema::

    {
      "boundaries": int,            # dispatch + idle scheduler ticks
      "dispatch_boundaries": int,
      "idle_boundaries": int,
      "dispatch_cells": int,        # token-slots offered by dispatches
      "useful_tokens": int,
      "bucket_pad_tokens": int,
      "group_pad_tokens": int,
      "spec_rejected_tokens": int,  # rejected verify-wave positions
      "frag_tokens": int,
      "budget_offered_tokens": int, # chunked-prefill budget passes
      "budget_used_tokens": int,
      "budget_starved_passes": int, # passes that ended with work queued
      "padding_waste_frac": float,  # (bucket + group) / cells
      "budget_utilization": float,  # used / offered (1.0 w/o budget)
      "goodput_gap": {              # fractions of offered opportunity
        "bucket_pad_frac": float,   #   (cells + frag tokens) lost to
        "group_pad_frac": float,    #   each cause; idle_frac is the
        "spec_rejected_frac": float,#   share of scheduler ticks that
        "frag_frac": float,         #   dispatched nothing at all
        "idle_frac": float,
      },
      "spec": {                     # graftspec acceptance accounting
        "drafted_tokens": int,      #   (all zero when SPEC is off)
        "accepted_tokens": int,
        "rejected_tokens": int,
        "verify_waves": int,
        "acceptance_rate": float,   # accepted / drafted (1.0 if none)
      },
      "pool_stall_events": int,
      "pool_stall_requests": int,   # requests whose admission stalled
      "preemptions": int,
      "preempted_tokens": int,      # prompt + generated work discarded
      "wait": {"requests": int, "total_ms": float, "pool_ms": float,
               "bucket_ms": float, "budget_ms": float,
               "sched_ms": float,
               "predicted_ms": float},  # graftroof cost stamp (not a
                                        # wait component; excluded from
                                        # the conservation re-sum)
      "conservation": {"checked": int, "breaches": int,
                       "last_breach": str | None},
      "by_shape": [                 # per-variant waste, compile-ledger
        {"key": str,                #   key spellings ("admit/64/4")
         "dispatches": int, "cells": int, "useful_tokens": int,
         "bucket_pad_tokens": int, "group_pad_tokens": int,
         "spec_rejected_tokens": int}
      ],
    }
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Dict, List, Optional, Tuple

from seldon_tpu_torch.servers.compile_ledger import key_str

logger = logging.getLogger(__name__)

Key = Tuple[Any, ...]

# Per-shape table cap: past it, new shapes fold into one overflow row so
# the snapshot payload stays bounded (totals keep exact counts).
_MAX_SHAPES = 128
# Wait-mark cap: requests that never reach a first dispatch (shed while
# queued) would otherwise leak their marks; past the cap the oldest mark
# is dropped and that request's wait degrades to the sched component.
_MAX_WAIT_MARKS = 4096
_OVERFLOW_KEY: Key = ("other",)


class SchedLedger:
    """Per-boundary waste attribution + queue-wait decomposition."""

    def __init__(self):
        # Token ledger — mutated only by the scheduler thread under
        # _book (dispatch taps), read via bulk copies in snapshot().
        self._dispatch_boundaries = 0
        self._idle_boundaries = 0
        self._cells = 0
        self._useful = 0
        self._bucket_pad = 0
        self._group_pad = 0
        self._spec_rejected = 0
        self._frag = 0
        self._budget_offered = 0
        self._budget_used = 0
        self._budget_starved = 0
        self._pool_stall_events = 0
        self._pool_stall_requests = 0
        self._preemptions = 0
        self._preempted_tokens = 0
        # graftspec acceptance accounting: every drafted token resolves
        # to accepted or rejected (audited below).
        self._spec_drafted = 0
        self._spec_accepted = 0
        self._spec_waves = 0
        # key -> [dispatches, cells, useful, bucket_pad, group_pad,
        #         spec_rejected]
        self._shapes: Dict[Key, List[int]] = {}
        # Queue-wait decomposition: rid -> first-cause timestamps, popped
        # at first dispatch; _budget_full_at is the latest budget pass
        # that ended with prefill work still queued.
        self._wait_marks: Dict[int, Dict[str, float]] = {}
        self._budget_full_at: Optional[float] = None
        self._wait_requests = 0
        self._wait_total_ms = 0.0
        self._wait_pool_ms = 0.0
        self._wait_bucket_ms = 0.0
        self._wait_budget_ms = 0.0
        self._wait_sched_ms = 0.0
        self._wait_predicted_ms = 0.0  # graftroof cost stamp (off-path 0)
        # Current-wave delta marks for boundary_waste() (the recorder's
        # per-boundary waste_frac counter lane).
        self._wave_cells = 0
        self._wave_pad = 0
        # Conservation audit state.
        self._audit_checked = 0
        self._audit_breaches = 0
        self._last_breach: Optional[str] = None

    # -- hot path (scheduler thread) -----------------------------------------

    def note_group(self, key: Key, cells: int, useful: int,
                   bucket_pad: int, group_pad: int,
                   spec_rejected: int = 0) -> None:
        """One dispatched admission/chunk/verify group: `cells` token-
        slots offered by its static shape, split exactly into useful
        tokens, bucket padding, pow2 group-replication padding and —
        for graftspec verify waves — rejected draft positions."""
        self._cells += cells
        self._useful += useful
        self._bucket_pad += bucket_pad
        self._group_pad += group_pad
        self._spec_rejected += spec_rejected
        self._wave_cells += cells
        self._wave_pad += bucket_pad + group_pad + spec_rejected
        rec = self._shapes.get(key)
        if rec is None:
            if len(self._shapes) >= _MAX_SHAPES:
                key = _OVERFLOW_KEY
                rec = self._shapes.get(key)
            if rec is None:
                rec = [0, 0, 0, 0, 0, 0]
                self._shapes[key] = rec
        rec[0] += 1
        rec[1] += cells
        rec[2] += useful
        rec[3] += bucket_pad
        rec[4] += group_pad
        rec[5] += spec_rejected

    def note_spec(self, drafted: int, accepted: int,
                  rejected: int) -> None:
        """One verify wave's acceptance split. `rejected` is carried by
        the caller (not derived) so audit() can re-sum the identity
        accepted + rejected == drafted from independently-counted
        inputs."""
        self._spec_drafted += drafted
        self._spec_accepted += accepted
        self._spec_waves += 1
        if accepted + rejected != drafted:
            self._breach(
                f"spec wave accounting: accepted {accepted} + rejected "
                f"{rejected} != drafted {drafted}"
            )

    def note_budget(self, offered: int, used: int, starved: bool) -> None:
        """One chunked-prefill budget pass. `starved`: prefill work was
        still queued when the pass ended — unspent budget then counts as
        fragmentation, and the pass marks budget contention for the
        wait decomposition (even a fully-spent pass contends)."""
        self._budget_offered += offered
        self._budget_used += used
        if starved:
            self._budget_starved += 1
            self._frag += offered - used
            self._budget_full_at = time.perf_counter()

    def note_boundary(self) -> None:
        """One scheduler tick that dispatched device work."""
        self._dispatch_boundaries += 1

    def note_idle(self) -> None:
        """One scheduler tick with nothing to dispatch (loop idle
        branch — scheduler thread, outside _book is fine: same single
        writer as every other mutator)."""
        self._idle_boundaries += 1

    def boundary_waste(self) -> float:
        """Padding fraction of the wave dispatched since the last call
        (scheduler thread only) — feeds the per-boundary waste_frac the
        flight recorder turns into a Perfetto counter lane."""
        cells, pad = self._wave_cells, self._wave_pad
        self._wave_cells = 0
        self._wave_pad = 0
        return pad / cells if cells else 0.0

    def _mark(self, rid: int) -> Dict[str, float]:
        m = self._wait_marks.get(rid)
        if m is None:
            if len(self._wait_marks) >= _MAX_WAIT_MARKS:
                self._wait_marks.pop(next(iter(self._wait_marks)))
            m = {}
            self._wait_marks[rid] = m
        return m

    def note_pool_stall(self, rid: int) -> None:
        """Head-of-line request `rid` could not be admitted because the
        KV pool had no capacity. First stall stamps the wait mark."""
        self._pool_stall_events += 1
        self._mark(rid).setdefault("pool", time.perf_counter())

    def note_bucket_defer(self, rid: int) -> None:
        """Head-of-line request `rid` was left queued behind a full
        engine whose last admitted group used a DIFFERENT bucket — the
        bucket-mismatch wait cause."""
        self._mark(rid).setdefault("bucket", time.perf_counter())

    def note_preempt(self, rid: int, tokens: int) -> None:
        """A live stream was preempted to free pool blocks; `tokens` is
        the prefill + decode work thrown away with it."""
        self._preemptions += 1
        self._preempted_tokens += tokens

    def note_first_dispatch(self, rid: int, submitted_at: float,
                            now: float, predicted_ms: float = 0.0) -> None:
        """Attribute one request's queue wait at its first dispatch.
        Components are claimed in priority order (pool stall, then
        bucket mismatch, then budget contention), each clamped to the
        wait still unclaimed, so they sum to the measured wait exactly;
        the remainder is the inherent scheduler-boundary interval.
        `predicted_ms` is the roofline cost model's service-time
        estimate for the request (graftroof; 0.0 when that ledger is
        off) — accumulated beside the wait so waits can be read against
        the predicted work they bought, without entering the
        conservation re-sum."""
        wait_ms = max(0.0, 1000.0 * (now - submitted_at))
        m = self._wait_marks.pop(rid, None) or {}
        pool_ms = bucket_ms = budget_ms = 0.0
        if "pool" in m:
            self._pool_stall_requests += 1
            pool_ms = min(wait_ms, max(0.0, 1000.0 * (now - m["pool"])))
        rem = wait_ms - pool_ms
        if "bucket" in m and rem > 0.0:
            bucket_ms = min(rem, max(0.0, 1000.0 * (now - m["bucket"])))
            rem -= bucket_ms
        t = self._budget_full_at
        if t is not None and t >= submitted_at and rem > 0.0:
            budget_ms = min(rem, max(0.0, 1000.0 * (now - t)))
            rem -= budget_ms
        self._wait_requests += 1
        self._wait_total_ms += wait_ms
        self._wait_pool_ms += pool_ms
        self._wait_bucket_ms += bucket_ms
        self._wait_budget_ms += budget_ms
        self._wait_sched_ms += rem
        self._wait_predicted_ms += max(0.0, predicted_ms)

    # -- conservation audit (under _book) ------------------------------------

    def audit(self) -> None:
        """Conservation check, run under ``_book`` at boundary
        processing (both the sync scheduler and the fetcher thread) —
        the graftsan boundary-audit slot. Token counters only mutate
        under ``_book``, so the identities below can never be
        legitimately torn here; a breach is real attribution drift."""
        self._audit_checked += 1
        attributed = (self._useful + self._bucket_pad + self._group_pad
                      + self._spec_rejected)
        if attributed != self._cells:
            self._breach(
                f"attributed tokens {attributed} != dispatched cells "
                f"{self._cells} (useful {self._useful} + bucket "
                f"{self._bucket_pad} + group {self._group_pad} + spec "
                f"rejected {self._spec_rejected})"
            )
        if self._spec_rejected > self._spec_drafted - self._spec_accepted:
            self._breach(
                f"spec rejected cells {self._spec_rejected} exceed "
                f"unaccepted drafts "
                f"{self._spec_drafted - self._spec_accepted}"
            )
        if self._frag > self._budget_offered - self._budget_used:
            self._breach(
                f"frag tokens {self._frag} exceed unspent budget "
                f"{self._budget_offered - self._budget_used}"
            )
        parts = (self._wait_pool_ms + self._wait_bucket_ms
                 + self._wait_budget_ms + self._wait_sched_ms)
        if abs(parts - self._wait_total_ms) > max(
            1.0, 0.01 * self._wait_total_ms
        ):
            self._breach(
                f"wait components {parts:.3f} ms != total wait "
                f"{self._wait_total_ms:.3f} ms"
            )

    def _breach(self, msg: str) -> None:
        self._audit_breaches += 1
        self._last_breach = msg
        logger.warning("sched-ledger conservation breach: %s", msg)

    # -- readers -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        shapes = {k: list(v) for k, v in self._shapes.items()}
        cells = self._cells
        frag = self._frag
        boundaries = self._dispatch_boundaries + self._idle_boundaries
        # Opportunity = every token-slot dispatched plus budget tokens
        # that went undispatched with work queued — the denominator the
        # goodput-gap fractions share.
        opportunity = cells + frag
        return {
            "boundaries": boundaries,
            "dispatch_boundaries": self._dispatch_boundaries,
            "idle_boundaries": self._idle_boundaries,
            "dispatch_cells": cells,
            "useful_tokens": self._useful,
            "bucket_pad_tokens": self._bucket_pad,
            "group_pad_tokens": self._group_pad,
            "spec_rejected_tokens": self._spec_rejected,
            "frag_tokens": frag,
            "budget_offered_tokens": self._budget_offered,
            "budget_used_tokens": self._budget_used,
            "budget_starved_passes": self._budget_starved,
            "padding_waste_frac": (
                round((self._bucket_pad + self._group_pad
                       + self._spec_rejected) / cells, 6)
                if cells else 0.0
            ),
            "budget_utilization": (
                round(self._budget_used / self._budget_offered, 6)
                if self._budget_offered else 1.0
            ),
            "goodput_gap": {
                "bucket_pad_frac": (
                    round(self._bucket_pad / opportunity, 6)
                    if opportunity else 0.0
                ),
                "group_pad_frac": (
                    round(self._group_pad / opportunity, 6)
                    if opportunity else 0.0
                ),
                "spec_rejected_frac": (
                    round(self._spec_rejected / opportunity, 6)
                    if opportunity else 0.0
                ),
                "frag_frac": (
                    round(frag / opportunity, 6) if opportunity else 0.0
                ),
                "idle_frac": (
                    round(self._idle_boundaries / boundaries, 6)
                    if boundaries else 0.0
                ),
            },
            "pool_stall_events": self._pool_stall_events,
            "pool_stall_requests": self._pool_stall_requests,
            "preemptions": self._preemptions,
            "preempted_tokens": self._preempted_tokens,
            "spec": {
                "drafted_tokens": self._spec_drafted,
                "accepted_tokens": self._spec_accepted,
                "rejected_tokens": (
                    self._spec_drafted - self._spec_accepted
                ),
                "verify_waves": self._spec_waves,
                "acceptance_rate": (
                    round(self._spec_accepted / self._spec_drafted, 6)
                    if self._spec_drafted else 1.0
                ),
            },
            "wait": {
                "requests": self._wait_requests,
                "total_ms": round(self._wait_total_ms, 3),
                "pool_ms": round(self._wait_pool_ms, 3),
                "bucket_ms": round(self._wait_bucket_ms, 3),
                "budget_ms": round(self._wait_budget_ms, 3),
                "sched_ms": round(self._wait_sched_ms, 3),
                "predicted_ms": round(self._wait_predicted_ms, 3),
            },
            "conservation": {
                "checked": self._audit_checked,
                "breaches": self._audit_breaches,
                "last_breach": self._last_breach,
            },
            "by_shape": [
                {
                    "key": key_str(k),
                    "dispatches": v[0],
                    "cells": v[1],
                    "useful_tokens": v[2],
                    "bucket_pad_tokens": v[3],
                    "group_pad_tokens": v[4],
                    "spec_rejected_tokens": v[5],
                }
                for k, v in sorted(shapes.items(), key=lambda kv:
                                   key_str(kv[0]))
            ],
        }


def from_env() -> Optional[SchedLedger]:
    """Ledger iff SCHED_LEDGER=1; None otherwise — callers keep a None
    attribute and the raw dispatch path (compile-ledger idiom)."""
    if os.environ.get("SCHED_LEDGER", "0") not in ("1", "true", "True"):
        return None
    return SchedLedger()
