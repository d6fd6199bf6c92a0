"""Canonical engine lock order — port of ``seldon_tpu/servers/lock_order.py``,
row for row.

Stdlib-only and import-light: the port's runtime sanitizer
(``seldon_tpu_torch/servers/graftsan.py``) reads it, and its table equals
the JAX package's (``tests/test_torch_graftsan.py`` holds the two equal),
so the port's engine is held to the acquired-before relation the JAX
engine documents. The port's lock owners carry the JAX class and
attribute names, so every row maps one of the port's locks.

The relation, as a rank table (lower rank = acquired first / outermost):

    _book (0)                scheduler bookkeeping — the outermost lock
      └─> trie._lock (10)    prefix radix trie (PrefixIndex /
      │                      PagedPrefixIndex); may unref pool blocks
      │     └─> allocator._lock (30)
      ├─> _rid_lock (20)     rid -> request registry          [leaf]
      ├─> stats.lock (20)    EngineStats counters             [leaf]
      ├─> chaos._lock (20)   ChaosMonkey fault counters       [leaf]
      └─> allocator._lock (30)  BlockAllocator free list/refs [leaf]

Leaves acquire nothing: in particular ``stats.lock`` must never reach
``allocator._lock`` (``EngineStats.snapshot`` calls ``pool_gauges()``
*outside* its lock for exactly this reason), and ``allocator._lock``
must never call back into the engine.  Locks not in the table (other
subsystems, test fixtures) are unranked: any nesting among them is
permitted until it forms a cycle, which both enforcers reject.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Optional, Tuple

# Canonical name -> rank.  An edge held->acquired is legal only when
# rank(held) < rank(acquired) and held is not a leaf.
LOCK_RANK: Dict[str, int] = {
    "_book": 0,
    "trie._lock": 10,
    "_rid_lock": 20,
    "stats.lock": 20,
    "chaos._lock": 20,
    "allocator._lock": 30,
}

# Leaves: no lock may be acquired while one of these is held — not even
# a lock of higher rank.
LEAF_LOCKS: FrozenSet[str] = frozenset(
    {"_rid_lock", "stats.lock", "chaos._lock", "allocator._lock"}
)

# (class name, lock attribute) -> canonical name.  This is how both
# enforcers map a concrete `self.<attr>` lock to a row in the table.
CANONICAL_ATTRS: Dict[Tuple[str, str], str] = {
    ("InferenceEngine", "_book"): "_book",
    ("InferenceEngine", "_rid_lock"): "_rid_lock",
    ("EngineStats", "lock"): "stats.lock",
    ("BlockAllocator", "_lock"): "allocator._lock",
    ("ChaosMonkey", "_lock"): "chaos._lock",
    ("PrefixIndex", "_lock"): "trie._lock",
    ("PagedPrefixIndex", "_lock"): "trie._lock",
}


def canonical_name(cls: str, attr: str) -> str:
    """Canonical name for lock attribute `attr` of class `cls`; locks
    outside the table get a qualified fallback name (unranked)."""
    return CANONICAL_ATTRS.get((cls, attr), f"{cls}.{attr}")


def edge_violation(held: str, acquired: str) -> Optional[str]:
    """Reason string if acquiring `acquired` while holding `held` breaks
    the documented order, else None.  Unranked locks are permitted (the
    cycle check still applies to them)."""
    if held == acquired:
        return (f"re-acquisition of non-reentrant lock '{held}' "
                "(self-deadlock)")
    if held in LEAF_LOCKS:
        return (f"'{held}' is a leaf in the documented lock order — "
                "nothing may be acquired under it")
    rh = LOCK_RANK.get(held)
    ra = LOCK_RANK.get(acquired)
    if rh is None or ra is None:
        return None
    if rh >= ra:
        return (f"acquiring '{acquired}' (rank {ra}) while holding "
                f"'{held}' (rank {rh}) inverts the documented order")
    return None
