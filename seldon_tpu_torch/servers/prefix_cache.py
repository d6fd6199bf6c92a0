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

Under tensor parallelism the dense trie's host logic (lookup, pins, LRU
ticks, eviction order) lives on rank 0 alone, and each node carries an
id. Every rank keeps the KV span of each node for its own heads: rank 0
in the node, each worker in a :class:`KVStore` keyed by node id. Rank 0
mirrors its insertions and drops to the workers (``on_new`` /
``on_drop``), and a family argument that names trie nodes
(:class:`StoreGather`) is gathered on each rank from its own spans by
:func:`gather_spans`, so every rank runs the same concatenation. A node
is charged its span's bytes times ``byte_scale`` (the group's width):
the global array's bytes, as the JAX trie charges a sharded array, so
hits and evictions under a byte budget do not depend on tp.

Under dp (``servers/dp_replicas.py``) a node's span is computed by the
replica that ran its admission row only. Each put names that replica,
and its rank of every tp coordinate broadcasts the span to the ranks of
the same coordinate on the other replicas (:func:`share_spans`, over
the rank's dp group); rank 0's node, inserted before the broadcast,
takes its span from it. So every rank holds every node for its heads,
at the bytes of a dp = 1 rank.

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
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def concat_pad(blocks: Sequence[Dict[str, Any]],
               pad_to: int) -> Dict[str, Any]:
    """Per-block tensors concatenated along the token axis (dim 2 for k/v
    AND scales) and zero-padded to ``pad_to``."""
    out = {}
    for key in blocks[0]:
        cat = torch.cat([b[key] for b in blocks], dim=2)
        pad = pad_to - cat.shape[2]
        if pad:
            # F.pad's widths run from the last dim backwards.
            cat = F.pad(cat, [0, 0] * (cat.ndim - 3) + [0, pad])
        out[key] = cat
    return out


@dataclass(frozen=True)
class StoreGather:
    """A device family's prefix KV named by trie node ids: ``rows`` holds
    one path of node ids per admission row, each concatenated and padded
    to ``pad_to`` (:func:`concat_pad`; a path of no nodes is all
    padding); ``stack`` stacks the rows on axis 1 (the warm admission's
    ``[L, G, Hkv, Pb, (Dh)]``), else the one row is the family's argument
    (the chunked seed's ``[L, Hkv, W, (Dh)]``). Host data: it crosses the
    command pipe, and each rank resolves it from its own spans."""

    rows: Tuple[Tuple[int, ...], ...]
    pad_to: int
    stack: bool


def span_like(cache: Dict[str, Any], n: int,
              fill: Optional[float] = None) -> Dict[str, Any]:
    """Tensors of an ``n``-token span of the dense slab ``cache``
    (``[L, rows, Hkv, T, (Dh)]`` per key): ``[L, Hkv, n, (Dh)]`` in its
    dtype, on its device; uninitialised unless ``fill``."""
    out = {}
    for key, c in cache.items():
        shape = (c.shape[0], c.shape[2], n) + tuple(c.shape[4:])
        out[key] = (torch.empty(shape, dtype=c.dtype, device=c.device)
                    if fill is None else
                    torch.full(shape, fill, dtype=c.dtype, device=c.device))
    return out


def gather_spans(span: Callable[[int], Dict[str, Any]], g: StoreGather,
                 like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """The tensors ``g`` names, from ``span`` (node id -> that node's
    per-block tensors); a row of no nodes is zeros shaped as a span of
    the slab ``like``."""
    outs = [concat_pad([span(nid) for nid in row], g.pad_to) if row
            else span_like(like, g.pad_to, 0) for row in g.rows]
    if not g.stack:
        return outs[0]
    return {key: torch.stack([o[key] for o in outs], dim=1)
            for key in outs[0]}


def share_spans(group, replica: int,
                puts: Sequence[Tuple[int, Dict[str, Any]]]) -> int:
    """Under dp: every put's span from the rank of its owner replica to
    this rank's peers on the other replicas (``group``, the rank's dp
    group, indexed by replica). ``puts`` are (owner, span) in op order,
    on every rank of the group: the owner's span holds its KV, the
    others' are filled in place. One broadcast per owner, in replica
    order. Returns the bytes this rank received."""
    got = 0
    for owner in sorted({o for o, _ in puts}):
        spans = [t for o, span in puts if o == owner
                 for _, t in sorted(span.items())]
        if owner == replica:
            flat = torch.cat([t.contiguous().view(-1).view(torch.uint8)
                              for t in spans])
        else:
            flat = torch.empty(sum(t.numel() * t.element_size()
                                   for t in spans),
                               dtype=torch.uint8, device=spans[0].device)
        flat = group.broadcast(flat, owner)
        if owner == replica:
            continue
        at = 0
        for t in spans:
            n = t.numel() * t.element_size()
            t.view(-1).view(torch.uint8).copy_(flat[at:at + n])
            at += n
        got += at
    return got


class KVStore:
    """A worker rank's half of the dense trie under tp: node id -> the
    node's KV span on this rank's heads. Applies rank 0's operations in
    order and raises where they disagree with what it holds."""

    def __init__(self):
        self.spans: Dict[int, Dict[str, Any]] = {}

    def apply(self, ops: Sequence[tuple], writes: Optional[Dict[str, Any]],
              dp: Optional[Tuple[Any, int, Dict[str, Any]]] = None) -> int:
        """``("put", nid, row, lo, hi[, owner])``: keep ``[lo, hi)`` of
        row ``row`` of ``writes`` (the last family's cache-dtype KV
        ``[L, G, Hkv, S, (Dh)]``) as node ``nid``; ``("drop", nid)``:
        forget node ``nid``. Under dp (``(dp group, this rank's replica,
        its slab)``) ``writes`` and ``row`` are those of the owner
        replica (0 when not named), and the owner's rank sends the span
        to the others (:func:`share_spans`). Returns the bytes of the
        spans other replicas sent this rank."""
        puts = []
        for op in ops:
            nid = op[1]
            if op[0] == "put":
                if nid in self.spans:
                    raise RuntimeError(f"prefix store: node {nid} is "
                                       f"already held")
                row, lo, hi = op[2:5]
                owner = op[5] if len(op) > 5 else 0
                if dp is not None and owner != dp[1]:
                    span = span_like(dp[2], hi - lo)
                elif writes is None:
                    raise RuntimeError(f"prefix store: node {nid} has no "
                                       f"family output to copy from")
                else:
                    span = {key: w[:, row, :, lo:hi].clone()
                            for key, w in writes.items()}
                self.spans[nid] = span
                puts.append((owner, span))
            elif self.spans.pop(nid, None) is None:
                raise RuntimeError(f"prefix store: dropped node {nid} is "
                                   f"not held")
        if dp is None or not puts:
            return 0
        return share_spans(dp[0], dp[1], puts)

    def resolve(self, g: StoreGather,
                like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        return gather_spans(self.spans.__getitem__, g, like)

    def shapes(self) -> Dict[int, Dict[str, Tuple[int, ...]]]:
        """node id -> {key: span shape}."""
        return {nid: {k: tuple(t.shape) for k, t in arrays.items()}
                for nid, arrays in self.spans.items()}


class _Node:
    __slots__ = ("key", "parent", "children", "arrays", "nbytes", "refs",
                 "tick", "id")

    def __init__(self, key, parent, arrays, nbytes, tick, nid=-1):
        self.id = nid
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
    """The dense engine's trie of K/V segments. ``byte_scale`` multiplies
    each node's span bytes (the group's width under tp: the global
    array's bytes); ``on_drop`` is called under the trie's lock with the
    ids of every node evicted or flushed."""

    def __init__(self, block: int = 16, byte_budget: int = 256 << 20,
                 byte_scale: int = 1,
                 on_drop: Optional[Callable[[List[int]], None]] = None):
        if block < 1:
            raise ValueError(f"prefix block must be >= 1, got {block}")
        self.block = block
        self.byte_budget = byte_budget
        self.byte_scale = int(byte_scale)
        self.on_drop = on_drop
        self._root = _Node(None, None, None, 0, 0)
        self._lock = threading.Lock()
        self._tick = 0
        self._next_id = 0
        self._by_id: Dict[int, _Node] = {}
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
        return concat_pad([nd.arrays for nd in handle.nodes], pad_to)

    def resolve(self, g: StoreGather,
                like: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
        """The tensors ``g`` names, from the nodes' own spans (pinned
        paths: read outside the lock, as :meth:`gather`)."""
        return gather_spans(lambda nid: self._by_id[nid].arrays, g, like)

    def arrays_of(self, nid: int) -> Optional[Dict[str, Any]]:
        """Node ``nid``'s span, or None once it is dropped."""
        with self._lock:
            nd = self._by_id.get(nid)
            return None if nd is None else nd.arrays

    def spans(self) -> Dict[int, Dict[str, Tuple[int, ...]]]:
        """node id -> {key: span shape} of every node held."""
        with self._lock:
            return {nid: {k: tuple(t.shape) for k, t in nd.arrays.items()}
                    for nid, nd in self._by_id.items()}

    def insert(
        self,
        tokens: Sequence[int],
        get_span: Callable[[int, int], Dict[str, Any]],
        handle: Optional[PrefixHandle] = None,
        on_new: Optional[Callable[[int, int, int], None]] = None,
    ) -> int:
        """Walk/extend the trie over tokens' full blocks. Missing blocks
        pull their arrays from get_span(start, end) (token span, absolute
        prompt positions); ``on_new(node id, start, end)`` follows each.
        The whole walked path is pinned into `handle` so the inserting
        request's own prompt can't be evicted while its slot lives.
        Returns the number of nodes LRU-evicted to fit the byte budget."""
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
                    nbytes = self.byte_scale * sum(
                        int(a.nbytes) for a in arrays.values())
                    child = _Node(key, node, arrays, nbytes, self._tick,
                                  self._next_id)
                    self._by_id[child.id] = child
                    self._next_id += 1
                    node.children[key] = child
                    self.bytes += nbytes
                    self.n_nodes += 1
                    if on_new is not None:
                        on_new(child.id, s, e)
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

    def _drop_locked(self, nd: _Node) -> None:
        nd.parent.children.pop(nd.key)
        self._by_id.pop(nd.id)
        self.bytes -= nd.nbytes
        self.n_nodes -= 1
        nd.arrays = None

    def _dropped(self, ids: List[int]) -> None:
        if ids and self.on_drop is not None:
            self.on_drop(ids)

    def _evict_locked(self) -> int:
        ids = []
        while self.bytes > self.byte_budget:
            victims = [nd for nd in self._leaves() if nd.refs == 0]
            if not victims:
                break  # everything left is pinned by live slots
            nd = min(victims, key=lambda n: n.tick)
            self._drop_locked(nd)
            ids.append(nd.id)
        self.evictions += len(ids)
        self._dropped(ids)
        return len(ids)

    def flush(self) -> int:
        """Evict every UNPINNED node regardless of the byte budget
        (drain / leak-audit path — retained KV is cache, so dropping it
        wholesale is always safe). Nodes left afterwards are pinned by
        live handles; with no live requests a non-zero n_nodes after
        flush() is a handle leak. Returns the number dropped."""
        with self._lock:
            ids = []
            while True:
                victims = [nd for nd in self._leaves() if nd.refs == 0]
                if not victims:
                    break
                for nd in victims:
                    self._drop_locked(nd)
                    ids.append(nd.id)
            self.evictions += len(ids)
            self._dropped(ids)
            return len(ids)

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
