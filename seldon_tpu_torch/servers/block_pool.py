"""Host-side block allocator for the paged KV cache.

Copy of ``seldon_tpu/servers/block_pool.py`` (the port keeps its own so
that it never imports the JAX package; tests/test_torch_engine.py holds
the two against each other).

The paged engine (EngineConfig.paged_kv) carves the KV device budget into
`num_blocks` fixed-size blocks of `kv_block` tokens each and hands out
block IDs; device state holds one global pool
[L, num_blocks, Hkv, kv_block, (Dh)] and per-slot int32 block tables
(servers/engine.py). This allocator is the single source of truth for
block lifetime:

 * `alloc()` pops a free block with refcount 1 (the caller owns it).
 * `ref()` adds a sharer — prefix-cache trie nodes and warm admissions
   share prompt blocks zero-copy by taking refs instead of copying KV.
 * `unref()` drops a ref and returns the block to the free list when the
   count hits zero.

Block 0 is RESERVED as the trash block and is never allocated: freed
slots' table entries are reset to 0, so garbage writes from in-flight
decode chunks (inactive rows scatter at their frozen position every
step, exactly like the dense slab path) land in a block nobody reads
unmasked. Misuse (double-free, ref of a free block) raises.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional


class BlockAllocator:
    TRASH = 0  # reserved block id; freed table entries point here

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"kv pool needs >= 2 blocks (1 trash + 1 usable), got "
                f"{num_blocks}"
            )
        self.num_blocks = num_blocks
        self._lock = threading.Lock()
        # LIFO free list: recently-freed blocks are reused first, which
        # keeps the working set of pool pages warm.
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))  # graftlint: guarded-by(_lock)
        self._refs: Dict[int, int] = {}  # graftlint: guarded-by(_lock)

    # --- lifecycle ----------------------------------------------------------

    def alloc(self) -> Optional[int]:
        """Pop a free block with refcount 1, or None on exhaustion."""
        with self._lock:
            if not self._free:
                return None
            bid = self._free.pop()
            self._refs[bid] = 1
            return bid

    def alloc_many(self, n: int) -> Optional[List[int]]:
        """All-or-nothing allocation of n blocks (None on exhaustion)."""
        with self._lock:
            if len(self._free) < n:
                return None
            out = [self._free.pop() for _ in range(n)]
            for bid in out:
                self._refs[bid] = 1
            return out

    def ref(self, bid: int) -> None:
        """Add a sharer to a LIVE block (zero-copy prefix sharing)."""
        with self._lock:
            if bid == self.TRASH:
                raise RuntimeError("ref of the reserved trash block")
            if bid not in self._refs:
                raise RuntimeError(f"ref of free block {bid}")
            self._refs[bid] += 1

    def unref(self, bid: int) -> None:
        """Drop one ref; the block is freed when the last sharer leaves."""
        with self._lock:
            if bid == self.TRASH:
                raise RuntimeError("unref of the reserved trash block")
            count = self._refs.get(bid)
            if count is None:
                raise RuntimeError(f"double free of block {bid}")
            if count == 1:
                del self._refs[bid]
                self._free.append(bid)
            else:
                self._refs[bid] = count - 1

    # --- observability ------------------------------------------------------

    @property
    def free_count(self) -> int:
        with self._lock:
            return len(self._free)

    @property
    def live_count(self) -> int:
        with self._lock:
            return len(self._refs)

    def refcount(self, bid: int) -> int:
        with self._lock:
            return self._refs.get(bid, 0)

    def shared_count(self) -> int:
        """Blocks with more than one sharer (prefix reuse at work)."""
        with self._lock:
            return sum(1 for c in self._refs.values() if c > 1)

    def refs_snapshot(self) -> Dict[int, int]:
        """Copy of the live refcount table (block id -> count), for the
        graftsan boundary audit: every ref must be accounted for by a
        live request's block table or a prefix-trie pin."""
        with self._lock:
            return dict(self._refs)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            live = len(self._refs)
            return {
                "total": self.num_blocks - 1,  # trash excluded
                "used": live,
                "free": len(self._free),
                "shared": sum(1 for c in self._refs.values() if c > 1),
            }
