"""Compile ledger — port of ``seldon_tpu/servers/compile_ledger.py``,
line for line.

Every device family of the engine registers its dispatches here under a
static-shape key — the tuple the JAX engine keys a jit variant on
(family, prompt/chunk bucket, padded group size, resident prefix width,
decode chunk length).  ``warmup()`` runs first and every key it
dispatches is *declared*: the expected variant lattice.  Once the
engine marks ``warmup_done()``, a first dispatch on an UNDECLARED key
is a **live-retrace witness**, recorded with the static key, the
first-dispatch host wall time and the rid that paid for it. The port
runs each family eagerly, so a first dispatch pays no trace or compile:
its time is the host's launch time (plus the one-off build of a CUDA
kernel, which ``warmup()`` triggers), and a witness marks a shape class
live traffic reached that the lattice did not declare — the key a
captured program (ROADMAP.md A15) would miss.

Design constraints (the flight-recorder discipline, applied again):

 * the hot path is ``dispatch()`` — called on the scheduler thread
   (or from ``warmup()`` before ``start()``), so appends are
   single-writer.  Dict stores and the scalar bumps are GIL-atomic;
   readers (``snapshot()`` from a debug route) tolerate a torn
   *window*, never a torn record.  No locks, no blocking, no device
   access — safe under ``_book``.
 * env-only gating: ``COMPILE_LEDGER=1`` enables it; off ->
   ``from_env()`` returns None and the engine keeps a None attribute
   plus the raw dispatch path — zero hot-path cost, not even a branch
   inside the dispatch sequence.
 * keys are plain tuples on the hot path; they render to stable
   strings ("admit/64/4") only at snapshot time, so Prometheus tags
   and ``/debug/compile`` agree on spelling.

``snapshot()`` is the documented ``/debug/compile`` schema::

    {
      "warmup_complete": bool,
      "tp": int,                    # TP group size (1 = single chip)
      "mesh_devices": int,          # devices the sealed lattice serves
      "declared_variants": int,     # lattice size warmup declared
      "dispatched_variants": int,   # distinct keys seen at all
      "warmup_coverage": float,     # declared keys actually dispatched
                                    #   post-warmup / declared (1.0 when
                                    #   traffic exercised the lattice)
      "compile_s_total": float,     # cumulative first-dispatch seconds
      "live_retrace_count": int,
      "live_retraces": [            # newest-capped witness list
        {"key": str, "rid": int, "compile_ms": float, "ts": float}
      ],
      "lattice": [                  # per-variant dispatch accounting
        {"key": str, "dispatches": int, "first_dispatch_ms": float,
         "declared": bool}
      ],
    }
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional, Tuple

Key = Tuple[Any, ...]

# Witness list cap: a retrace storm keeps counting past it, but the
# snapshot payload stays bounded.
_MAX_WITNESSES = 256


def key_str(key: Key) -> str:
    """Canonical rendering shared by /debug/compile, Prometheus variant
    tags and the flight-recorder "retrace"/"dispatch" records."""
    return "/".join(str(p) for p in key)


class CompileLedger:
    """Static-shape dispatch ledger with live-retrace witnesses."""

    def __init__(self):
        # All mutated by the single dispatching thread (warmup caller,
        # then the scheduler thread); readers snapshot via bulk copies.
        self._declared: set = set()
        self._warmup_complete = False
        self._counts: Dict[Key, int] = {}
        self._first_s: Dict[Key, float] = {}
        self._compile_s_total = 0.0
        self._retraces: list = []
        self._retrace_count = 0
        # TP geometry: set once at engine init when the engine serves a
        # TP group (tp > 1); the lattice
        # keys are tp-invariant, and these fields let /debug/compile
        # readers assert that ONE sealed lattice serves the whole group.
        self._tp = 1
        self._mesh_devices = 1

    # -- warmup-time ---------------------------------------------------------

    def set_mesh(self, tp: int, devices: int) -> None:
        """Record the TP group geometry this lattice serves (engine
        init time, before any dispatch)."""
        self._tp = int(tp)
        self._mesh_devices = int(devices)

    def declare(self, key: Key) -> None:
        """Declare one expected lattice key without dispatching it."""
        self._declared.add(key)

    def warmup_done(self) -> None:
        """Seal the lattice: every key dispatched so far was warmup's
        doing and counts as declared; any NEW key from here on is a
        live retrace."""
        self._declared.update(self._counts)
        self._warmup_complete = True

    # -- hot path ------------------------------------------------------------

    def dispatch(self, key: Key, rid: int,
                 seconds: float) -> Optional[Dict[str, Any]]:
        """Register one dispatch under `key`, taking `seconds` of host
        wall time.  Returns a witness dict iff this dispatch was a live
        retrace, so the engine can pin it to the flight recording."""
        n = self._counts.get(key)
        if n is not None:
            self._counts[key] = n + 1
            return None
        self._counts[key] = 1
        self._first_s[key] = seconds
        self._compile_s_total += seconds
        if not self._warmup_complete:
            self._declared.add(key)
            return None
        if key in self._declared:
            return None
        self._retrace_count += 1
        witness = {
            "key": key_str(key),
            "rid": rid,
            "compile_ms": round(1000.0 * seconds, 3),
            "ts": time.monotonic(),
        }
        if len(self._retraces) < _MAX_WITNESSES:
            self._retraces.append(witness)
        return witness

    # -- readers -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        counts = dict(self._counts)
        first = dict(self._first_s)
        declared = set(self._declared)
        # Coverage: declared variants a live dispatch actually re-used
        # (count > 1 — warmup itself paid the first). Before warmup_done
        # nothing is sealed, so coverage reads 0.0.
        reused = sum(
            1 for k, c in counts.items() if k in declared and c > 1
        )
        return {
            "warmup_complete": self._warmup_complete,
            "tp": self._tp,
            "mesh_devices": self._mesh_devices,
            "declared_variants": len(declared),
            "dispatched_variants": len(counts),
            "warmup_coverage": (
                round(reused / len(declared), 4) if declared else 0.0
            ),
            "compile_s_total": round(self._compile_s_total, 4),
            "live_retrace_count": self._retrace_count,
            "live_retraces": list(self._retraces),
            "lattice": [
                {
                    "key": key_str(k),
                    "dispatches": counts[k],
                    "first_dispatch_ms": round(1000.0 * first.get(k, 0.0), 3),
                    "declared": k in declared,
                }
                for k in sorted(counts, key=key_str)
            ],
        }


def from_env() -> Optional[CompileLedger]:
    """Ledger iff COMPILE_LEDGER=1; None otherwise — callers keep a None
    attribute and the raw dispatch path (flight-recorder/chaos idiom)."""
    if os.environ.get("COMPILE_LEDGER", "0") not in ("1", "true", "True"):
        return None
    return CompileLedger()
