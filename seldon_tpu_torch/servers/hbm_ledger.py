"""HBM ledger — port of ``seldon_tpu/servers/hbm_ledger.py``: live-byte
accounting for device memory, by category.

Where does HBM go?  Three places in this engine: model **weights**
(static, paid at load), the **KV cache** (static reservation — a dense
slot tensor or the paged block pool — plus a *live* fraction actually
holding request state), and transient **workspace** (activations and
logits materialised per dispatch).  The ledger tracks bytes per
category with high-watermarks, served at ``/debug/hbm``.

Accounting is arithmetic over shapes the engine already knows —
``nbytes`` over the module's parameters and buffers and the cache's
tensors at init, allocator block counts at snapshot — never a device
sync (no ``torch.cuda.memory_allocated()``: the ledger counts what the
engine holds, the allocator's figure adds its own caching).  Rules of the house:

 * static categories are set once at engine init (``set_static``);
 * live categories register a zero-argument callable (``gauge``)
   evaluated ONLY at snapshot time, so the hot path never touches the
   ledger;
 * workspace is the one hot-path touch: ``note_workspace`` does a
   compare-and-max on a plain float (GIL-atomic) with bytes the
   dispatcher computes from host-side shape math;
 * env-gated ``HBM_LEDGER=1`` via ``from_env()`` -> None off, same
   zero-overhead-off contract as the flight recorder.

``snapshot()`` is the documented ``/debug/hbm`` schema::

    {
      "categories": {
        name: {"bytes": int, "bytes_per_device": int,
               "high_bytes": int, "static": bool}
      },
      "devices": int,                  # mesh devices accounted (1 = chip)
      "total_bytes": int,              # sum of current bytes (mesh-wide)
      "total_bytes_per_device": int,   # sum of per-device bytes
      "total_high_bytes": int,   # sum of per-category high-watermarks
    }

Expected category names: "weights", "kv_cache" (static reservation),
"kv_live" (bytes holding active request state), "prefix_cache",
"workspace", and on the card "graph_pool" (the port's own: the segments
of the shared pool that the converged engine's captured programs keep
for their transients, ``servers/wave_program.py``; 0 once released).

graftmesh (tp > 1) grows per-device accounting, not a new schema mode:
``set_devices`` records the mesh size, ``set_static``/``gauge`` take an
optional per-device figure (weights: the committed shard bytes; KV:
logical // tp — the head axis shards exactly), and categories without
one report their full bytes per device (replicated / conservative —
workspace and host-gathered prefix KV live whole on every chip).  On a
single chip every ``bytes_per_device`` equals ``bytes``, so the tp=1
payload carries the same numbers it always did, plus the new keys.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Optional


class HbmLedger:
    """Per-category device byte accounting with high-watermarks."""

    def __init__(self):
        self._static: Dict[str, int] = {}
        self._static_per_device: Dict[str, int] = {}
        self._gauges: Dict[str, Callable[[], int]] = {}
        self._gauge_per_device: Dict[str, Callable[[], int]] = {}
        self._gauge_high: Dict[str, int] = {}
        self._workspace = 0
        self._workspace_high = 0
        self._devices = 1

    def set_devices(self, n: int) -> None:
        """Record the mesh size the per-device figures divide over
        (engine init; 1 = single chip)."""
        self._devices = max(1, int(n))

    def set_static(self, name: str, nbytes: int,
                   per_device: Optional[int] = None) -> None:
        """Record a category whose size is fixed for the engine's life
        (weights, the KV reservation).  `per_device` is the resident
        bytes on EACH mesh device (None = fully replicated: the whole
        category on every chip)."""
        self._static[name] = int(nbytes)
        self._static_per_device[name] = int(
            nbytes if per_device is None else per_device
        )

    def gauge(self, name: str, fn: Callable[[], int],
              per_device_fn: Optional[Callable[[], int]] = None) -> None:
        """Register a live category.  `fn` is called only at snapshot —
        it must be sync-free (host-side counter math, e.g. allocator
        used-blocks x per-block bytes).  `per_device_fn` reports the
        per-mesh-device share (None = replicated: fn's value on every
        chip)."""
        self._gauges[name] = fn
        if per_device_fn is not None:
            self._gauge_per_device[name] = per_device_fn
        self._gauge_high.setdefault(name, 0)

    def note_workspace(self, nbytes: int) -> None:
        """Hot-path: fold one dispatch's transient footprint (padded
        activations + logits, from host shape math) into the workspace
        watermark.  Plain-float max; single scheduler-thread writer."""
        n = int(nbytes)
        self._workspace = n
        if n > self._workspace_high:
            self._workspace_high = n

    def snapshot(self) -> Dict[str, Any]:
        cats: Dict[str, Dict[str, Any]] = {}
        for name, nbytes in self._static.items():
            cats[name] = {"bytes": nbytes,
                          "bytes_per_device":
                              self._static_per_device.get(name, nbytes),
                          "high_bytes": nbytes,
                          "static": True}
        for name, fn in self._gauges.items():
            # A gauge that raises propagates: the JAX ledger reports 0
            # for it, the port reports no number it did not read.
            n = int(fn())
            pfn = self._gauge_per_device.get(name)
            per_dev = n if pfn is None else int(pfn())
            if n > self._gauge_high.get(name, 0):
                self._gauge_high[name] = n
            cats[name] = {"bytes": n,
                          "bytes_per_device": per_dev,
                          "high_bytes": self._gauge_high[name],
                          "static": False}
        cats["workspace"] = {"bytes": self._workspace,
                             "bytes_per_device": self._workspace,
                             "high_bytes": self._workspace_high,
                             "static": False}
        return {
            "categories": cats,
            "devices": self._devices,
            "total_bytes": sum(c["bytes"] for c in cats.values()),
            "total_bytes_per_device": sum(
                c["bytes_per_device"] for c in cats.values()
            ),
            "total_high_bytes": sum(c["high_bytes"] for c in cats.values()),
        }


def from_env() -> Optional[HbmLedger]:
    """Ledger iff HBM_LEDGER=1; None otherwise."""
    if os.environ.get("HBM_LEDGER", "0") not in ("1", "true", "True"):
        return None
    return HbmLedger()
