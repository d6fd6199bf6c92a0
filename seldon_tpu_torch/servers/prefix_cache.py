"""Host-side prefix index over prompt tokens -> device-resident KV.

Copy of ``seldon_tpu/servers/prefix_cache.py`` (the port keeps its own so
that it never imports the JAX package; tests/test_torch_prefix_cache.py
runs one sequence of operations through both and holds them equal).

A radix trie keyed by fixed-size token BLOCKS. Two variants:

 * :class:`PagedPrefixIndex` (the ragged engine's): nodes hold POOL
   BLOCK IDS. A warm admission refs the matched blocks into the new
   slot's block table (zero-copy); a match that ends inside a pool block
   copies that block on the device (copy-on-write). Eviction runs on
   demand, leaf-first LRU over unpinned nodes, when the engine needs
   free pool blocks.
 * :class:`PrefixIndex` (the dense engine's): nodes own that block's KV
   segment for every layer — tensors in cache storage dtype
   ([L, Hkv, block, Dh] k/v, plus [L, Hkv, block] scales for int8
   caches), LRU-evicted leaf-first under a byte budget. Its ``gather``
   concatenates and pads a pinned path on the nodes' device.

Concurrency/lifetime model (engine scheduler + boundary-fetcher threads):
 * `lookup` pins the matched path (refcount) and returns a PrefixHandle;
   the engine holds it for the request's whole slot lifetime and releases
   in `_complete`, so a LIVE slot's prefix can never be evicted.
 * `insert` extends the handle's pin over the request's full block path
   (existing nodes and new ones alike). Evicting leaf-first keeps every
   stored path rooted, so a later lookup can never match through a hole.
 * All trie mutation is under one lock; `gather` intentionally runs
   outside it — pinned nodes are immutable.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


class _Node:
    __slots__ = ("key", "parent", "children", "arrays", "nbytes", "refs",
                 "tick")

    def __init__(self, key, parent, arrays, nbytes, tick):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.arrays = arrays  # cache key -> [L, Hkv, block, (Dh)]
        self.nbytes = nbytes
        self.refs = 0
        self.tick = tick


class PrefixHandle:
    """Pinned trie path for one request. `match_len` is the reused token
    count (a multiple of `block`); `nodes` grows when `insert` extends
    the pin over the request's own prompt blocks."""

    __slots__ = ("nodes", "match_len", "released")

    def __init__(self, nodes: List[_Node], match_len: int):
        self.nodes = nodes
        self.match_len = match_len
        self.released = False


class PrefixIndex:
    """The dense engine's trie of K/V segments. Kept for parity with the
    JAX module only: nothing in the port calls it until the dense engine
    (ROADMAP.md A7) comes, which brings it into use."""

    def __init__(self, block: int = 16, byte_budget: int = 256 << 20):
        if block < 1:
            raise ValueError(f"prefix block must be >= 1, got {block}")
        self.block = block
        self.byte_budget = byte_budget
        self._root = _Node(None, None, None, 0, 0)
        self._lock = threading.Lock()
        self._tick = 0
        self.bytes = 0
        self.n_nodes = 0
        self.evictions = 0

    # --- request lifecycle --------------------------------------------------

    def lookup(self, tokens: Sequence[int],
               max_len: Optional[int] = None) -> PrefixHandle:
        """Longest block-aligned cached prefix of tokens[:max_len]. Pins
        the matched path until release()."""
        n = len(tokens) if max_len is None else min(len(tokens), max_len)
        with self._lock:
            self._tick += 1
            node, path, i = self._root, [], 0
            while i + self.block <= n:
                child = node.children.get(tuple(tokens[i:i + self.block]))
                if child is None:
                    break
                child.refs += 1
                child.tick = self._tick
                path.append(child)
                node = child
                i += self.block
            return PrefixHandle(path, i)

    def release(self, handle: PrefixHandle) -> None:
        with self._lock:
            if handle.released:
                return
            handle.released = True
            for nd in handle.nodes:
                nd.refs -= 1

    def gather(self, handle: PrefixHandle, pad_to: int) -> Dict[str, Any]:
        """Concatenate the pinned path's per-block tensors along the token
        axis (dim 2 for k/v AND scales) and zero-pad to `pad_to`, on the
        nodes' device; requires match_len > 0."""
        blocks = [nd.arrays for nd in handle.nodes]
        out = {}
        for key in blocks[0]:
            cat = torch.cat([b[key] for b in blocks], dim=2)
            pad = pad_to - cat.shape[2]
            if pad:
                # F.pad's widths run from the last dim backwards.
                cat = F.pad(cat, [0, 0] * (cat.ndim - 3) + [0, pad])
            out[key] = cat
        return out

    def insert(
        self,
        tokens: Sequence[int],
        get_span: Callable[[int, int], Dict[str, Any]],
        handle: Optional[PrefixHandle] = None,
    ) -> int:
        """Walk/extend the trie over tokens' full blocks. Missing blocks
        pull their arrays from get_span(start, end) (token span, absolute
        prompt positions). The whole walked path is pinned into `handle`
        so the inserting request's own prompt can't be evicted while its
        slot lives. Returns the number of nodes LRU-evicted to fit the
        byte budget."""
        n_blocks = len(tokens) // self.block
        with self._lock:
            self._tick += 1
            node = self._root
            pinned = len(handle.nodes) if handle is not None else 0
            for j in range(n_blocks):
                s, e = j * self.block, (j + 1) * self.block
                key = tuple(tokens[s:e])
                child = node.children.get(key)
                if child is None:
                    arrays = get_span(s, e)
                    nbytes = sum(int(a.nbytes) for a in arrays.values())
                    child = _Node(key, node, arrays, nbytes, self._tick)
                    node.children[key] = child
                    self.bytes += nbytes
                    self.n_nodes += 1
                child.tick = self._tick
                if handle is not None and j >= pinned:
                    child.refs += 1
                    handle.nodes.append(child)
                node = child
            return self._evict_locked()

    # --- eviction -----------------------------------------------------------

    def _leaves(self) -> List[_Node]:
        out, stack = [], list(self._root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            else:
                out.append(nd)
        return out

    def _evict_locked(self) -> int:
        evicted = 0
        while self.bytes > self.byte_budget:
            victims = [nd for nd in self._leaves() if nd.refs == 0]
            if not victims:
                break  # everything left is pinned by live slots
            nd = min(victims, key=lambda n: n.tick)
            nd.parent.children.pop(nd.key)
            self.bytes -= nd.nbytes
            self.n_nodes -= 1
            nd.arrays = None
            evicted += 1
        self.evictions += evicted
        return evicted

    def flush(self) -> int:
        """Evict every UNPINNED node regardless of the byte budget
        (drain / leak-audit path — retained KV is cache, so dropping it
        wholesale is always safe). Nodes left afterwards are pinned by
        live handles; with no live requests a non-zero n_nodes after
        flush() is a handle leak. Returns the number dropped."""
        with self._lock:
            dropped = 0
            while True:
                victims = [nd for nd in self._leaves() if nd.refs == 0]
                if not victims:
                    break
                for nd in victims:
                    nd.parent.children.pop(nd.key)
                    self.bytes -= nd.nbytes
                    self.n_nodes -= 1
                    nd.arrays = None
                    dropped += 1
            self.evictions += dropped
            return dropped

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {
                "nodes": self.n_nodes,
                "bytes": self.bytes,
                "evictions": self.evictions,
            }


# ---------------------------------------------------------------------------
# Paged variant: the trie stores pool BLOCK IDS, not KV copies
# ---------------------------------------------------------------------------


class _PagedNode:
    __slots__ = ("key", "parent", "children", "block", "refs", "tick")

    def __init__(self, key, parent, block, tick):
        self.key = key
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_PagedNode"] = {}
        self.block = block  # pool block id holding this span's KV
        self.refs = 0
        self.tick = tick


class PagedPrefixIndex:
    """Radix trie over prompt blocks whose nodes hold POOL BLOCK IDS
    instead of KV arrays (paged_kv engines). Retention costs no extra
    HBM — a node just keeps one allocator ref on the pool block that
    physically holds its span, so a warm admission turns into table
    surgery (ref the cached blocks into the new slot's block table) with
    zero device traffic; `gather` does not exist here on purpose.

    Trie granularity stays `prefix_block` tokens (matching the engine's
    lookup/insert discipline and chunked prefill), while pool blocks are
    `kv_block` = k * prefix_block tokens, so several consecutive nodes
    can record the same — or different — pool blocks. `plan` resolves
    that fan-in: within each kv_block span of the matched path, the
    DEEPEST node's recorded block is the one whose owning request also
    walked every shallower node in the span, hence the one block that
    contains the whole span's KV.

    Lifetime: a node takes one allocator ref at insert and unrefs at
    eviction; eviction is LRU over unpinned leaves, but runs ON DEMAND
    (`evict_for`, when the engine needs free blocks) rather than against
    a byte budget — retained prefixes occupy blocks the pool could not
    otherwise use only while it has them spare."""

    def __init__(self, block: int, kv_block: int,
                 allocator: "BlockAllocator"):
        if kv_block % block:
            raise ValueError(
                f"kv_block ({kv_block}) must be a multiple of the prefix "
                f"block ({block})"
            )
        self.block = block
        self.kv_block = kv_block
        self._alloc = allocator
        self._root = _PagedNode(None, None, None, 0)
        self._lock = threading.Lock()
        self._tick = 0
        self.n_nodes = 0
        self.evictions = 0

    # --- request lifecycle --------------------------------------------------

    def lookup(self, tokens: Sequence[int],
               max_len: Optional[int] = None) -> PrefixHandle:
        """Longest block-aligned cached prefix (same contract as the
        dense PrefixIndex.lookup — pins the path until release())."""
        n = len(tokens) if max_len is None else min(len(tokens), max_len)
        with self._lock:
            self._tick += 1
            node, path, i = self._root, [], 0
            while i + self.block <= n:
                child = node.children.get(tuple(tokens[i:i + self.block]))
                if child is None:
                    break
                child.refs += 1
                child.tick = self._tick
                path.append(child)
                node = child
                i += self.block
            return PrefixHandle(path, i)

    def release(self, handle: PrefixHandle) -> None:
        with self._lock:
            if handle.released:
                return
            handle.released = True
            for nd in handle.nodes:
                nd.refs -= 1

    def plan(self, handle: PrefixHandle) -> Tuple[List[int], Optional[int]]:
        """Resolve a pinned match into pool-block sources:
        (full_srcs, partial_src) where full_srcs[i] is the block to
        share zero-copy for the i-th FULLY matched kv_block, and
        partial_src is the copy-on-write source when the match ends
        inside a kv_block (None when block-aligned). Blocks stay alive
        via the handle's node pins until the engine takes its own refs
        / dispatches the copy."""
        per = self.kv_block // self.block
        full = handle.match_len // self.kv_block
        srcs = [handle.nodes[(i + 1) * per - 1].block for i in range(full)]
        partial = None
        if handle.match_len % self.kv_block:
            partial = handle.nodes[-1].block
        return srcs, partial

    def insert(
        self,
        tokens: Sequence[int],
        block_of: Callable[[int], int],
        handle: Optional[PrefixHandle] = None,
    ) -> None:
        """Walk/extend the trie over tokens' full prefix blocks. A NEW
        node for span j records block_of(j) (the pool block the
        inserting request's table maps that span to) and takes one
        allocator ref on it; existing nodes are left untouched — their
        block already holds identical KV. The walked path is pinned into
        `handle`, mirroring the dense insert."""
        n_blocks = len(tokens) // self.block
        with self._lock:
            self._tick += 1
            node = self._root
            pinned = len(handle.nodes) if handle is not None else 0
            for j in range(n_blocks):
                s = j * self.block
                key = tuple(tokens[s:s + self.block])
                child = node.children.get(key)
                if child is None:
                    bid = block_of(j)
                    self._alloc.ref(bid)
                    child = _PagedNode(key, node, bid, self._tick)
                    node.children[key] = child
                    self.n_nodes += 1
                child.tick = self._tick
                if handle is not None and j >= pinned:
                    child.refs += 1
                    handle.nodes.append(child)
                node = child

    def block_refs(self) -> Dict[int, int]:
        """Pool block id -> number of trie nodes holding a ref on it
        (several consecutive prefix-block nodes can share one kv_block).
        Graftsan's boundary audit sums this with live request tables to
        reconcile the allocator's refcounts."""
        out: Dict[int, int] = {}
        with self._lock:
            stack = list(self._root.children.values())
            while stack:
                nd = stack.pop()
                out[nd.block] = out.get(nd.block, 0) + 1
                stack.extend(nd.children.values())
        return out

    # --- eviction -----------------------------------------------------------

    def _leaves(self) -> List[_PagedNode]:
        out, stack = [], list(self._root.children.values())
        while stack:
            nd = stack.pop()
            if nd.children:
                stack.extend(nd.children.values())
            else:
                out.append(nd)
        return out

    def evict_for(self, n_free: int) -> int:
        """LRU-evict unpinned leaves (unref their pool blocks) until the
        allocator has >= n_free free blocks or nothing evictable is
        left. Returns the number of nodes evicted. Note: several nodes
        can share one pool block, so freeing n blocks may take more than
        n evictions."""
        evicted = 0
        with self._lock:
            while self._alloc.free_count < n_free:
                victims = [nd for nd in self._leaves() if nd.refs == 0]
                if not victims:
                    break
                nd = min(victims, key=lambda v: v.tick)
                nd.parent.children.pop(nd.key)
                self._alloc.unref(nd.block)
                self.n_nodes -= 1
                evicted += 1
        self.evictions += evicted
        return evicted

    def flush(self) -> int:
        """Evict every UNPINNED node, unreffing its pool block (drain /
        leak-audit path). Nodes left afterwards are pinned by live
        handles; with no live requests a non-zero n_nodes after flush()
        is a handle leak. Returns the number dropped."""
        dropped = 0
        with self._lock:
            while True:
                victims = [nd for nd in self._leaves() if nd.refs == 0]
                if not victims:
                    break
                for nd in victims:
                    nd.parent.children.pop(nd.key)
                    self._alloc.unref(nd.block)
                    self.n_nodes -= 1
                    dropped += 1
            self.evictions += dropped
        return dropped

    def clear(self) -> None:
        """Drop every node WITHOUT touching the allocator — only valid
        when the caller is resetting the allocator wholesale (engine
        _fail_all rebuilds pool bookkeeping from scratch)."""
        with self._lock:
            self._root = _PagedNode(None, None, None, 0)
            self.n_nodes = 0

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return {"nodes": self.n_nodes, "evictions": self.evictions}
