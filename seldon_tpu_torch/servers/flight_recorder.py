"""Engine flight recorder — port of
``seldon_tpu/servers/flight_recorder.py``, line for line: a bounded,
lock-free-per-append ring buffer of per-boundary / per-lifecycle-event
records.

Design constraints (the point of this module):

 * appends happen on the scheduler hot path — under ``_book`` at sites
   that already hold it — so an append must never block, sync a device,
   or take another lock.  The ring is a preallocated list plus a
   monotonically increasing write index; ``buf[n % size] = rec`` and the
   index bump are each a single bytecode-level store, and records are
   immutable tuples once written, so a reader taking a snapshot from
   another thread sees at worst a torn *window* (an old record where a
   new one just landed), never a torn record.  Single-writer discipline
   comes from the call sites: every ``record()`` caller is the scheduler
   thread or holds ``_book``.
 * host timestamps only (``time.monotonic()``): recording never waits
   for the device — no ``.item()``, no ``torch.cuda.synchronize()`` —
   which is why boundary records carry dispatch/fetch wall-clock and
   leave device time to the env-gated ``torch.profiler`` window
   (``TRACE_PROFILE_N``, wired in the engine scheduler).
 * env-only gating, like chaos and graftsan: ``FLIGHT_RECORDER=1``
   enables it (never a config field, so manifests cannot enable it by
   accident); off -> ``from_env()`` returns None and the engine keeps a
   None attribute — zero hot-path cost, not even a method call.

Record shape (immutable tuple, ``Record._fields`` order)::

    (ts, kind, rid, detail)

``ts`` is ``time.monotonic()`` seconds; ``kind`` is a short event name
("boundary", "submit", "admit", "trie-hit", "cow", "preempt",
"deadline", "cancel", "shed", "drain", "chaos", "terminal", ...);
``rid`` is the request id or -1 for engine-wide events; ``detail`` is a
small dict of host-side scalars (never arrays, never device values).

``snapshot()`` returns records oldest-first plus a stable epoch origin
so a trace viewer can render absolute wall-clock; the
``/debug/timeline`` endpoint (wrapper -> torchserver.debug_timeline)
serves the same JSON, with the JAX recorder's keys.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Any, Dict, List, Optional

Record = collections.namedtuple("Record", ("ts", "kind", "rid", "detail"))

_DEFAULT_SIZE = 4096


class FlightRecorder:
    """Bounded ring of lifecycle records; append is lock-free."""

    def __init__(self, size: int = _DEFAULT_SIZE):
        if size <= 0:
            raise ValueError(f"recorder size must be positive, got {size}")
        self.size = size
        # Epoch pairing: monotonic timestamps in records are converted to
        # wall clock via (epoch_wall + (ts - epoch_mono)) at export time.
        self.epoch_mono = time.monotonic()
        self.epoch_wall = time.time()
        self._buf: List[Optional[Record]] = [None] * size
        # Write index; monotonically increasing, wraps via modulo at the
        # store.  Plain int: single-writer (scheduler thread / callers
        # already serialized under _book), readers tolerate staleness.
        self._n = 0

    # -- hot path ------------------------------------------------------------

    def record(self, kind: str, rid: int = -1,
               detail: Optional[Dict[str, Any]] = None) -> None:
        """Append one record. No locks, no blocking, no device access —
        safe under ``_book`` (rated by lock_order.py: nothing acquired)."""
        n = self._n
        self._buf[n % self.size] = Record(
            time.monotonic(), kind, rid, detail or {}
        )
        self._n = n + 1

    # -- readers -------------------------------------------------------------

    def __len__(self) -> int:
        return min(self._n, self.size)

    def snapshot(self) -> Dict[str, Any]:
        """Records oldest-first + epoch info, as plain JSON-able data.
        Reads racing an append may see a torn window (one slot observed
        pre-overwrite); records themselves are immutable tuples."""
        n = self._n
        buf = list(self._buf)  # one bulk copy, then index math on it
        if n <= self.size:
            recs = [r for r in buf[:n] if r is not None]
        else:
            cut = n % self.size
            recs = [r for r in buf[cut:] + buf[:cut] if r is not None]
        return {
            "epoch_mono": self.epoch_mono,
            "epoch_wall": self.epoch_wall,
            "size": self.size,
            "total_recorded": n,
            "dropped": max(0, n - self.size),
            "records": [
                {"ts": r.ts, "kind": r.kind, "rid": r.rid, "detail": r.detail}
                for r in recs
            ],
        }


def from_env() -> Optional[FlightRecorder]:
    """Recorder iff FLIGHT_RECORDER=1 (size via FLIGHT_RECORDER_SIZE);
    None otherwise — callers keep a None attribute and skip recording
    entirely, the chaos/graftsan zero-cost-off idiom."""
    if os.environ.get("FLIGHT_RECORDER", "0") not in ("1", "true", "True"):
        return None
    size = int(os.environ.get("FLIGHT_RECORDER_SIZE", "0") or 0)
    return FlightRecorder(size if size > 0 else _DEFAULT_SIZE)
