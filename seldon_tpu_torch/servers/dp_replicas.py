"""The 'dp' axis of a serving rank group: which replica runs a device
family, on which of its slots, and how the replicas' outputs meet on
rank 0.

JAX puts the engine state's batch axis on 'dp' (``cache_pspec``,
``batch_pspec``): each dp replica holds, and computes, a contiguous
block of the slots. The port keeps that layout with one process per
rank (``servers/mesh_engine.py``):
 * replica d (the ranks at dp coordinate d: one tp group, or one sp x tp
   block) owns slots ``[d * B / dp, (d + 1) * B / dp)``;
   ``B % dp != 0`` raises (:func:`check_slots`);
 * every rank keeps the per-slot fields of all B slots, of which it
   maintains its replica's block (rank 0 maintains all of them, from the
   replicas' replies); the KV cache holds the replica's slots only: the
   dense slab its B / dp rows (slot ``s`` at row ``s - lo``), the paged
   pool the whole pool's shape with the global block ids, written only
   through the tables of the replica's own slots;
 * a family runs on a replica's view of the state (:func:`sub_state`):
   its block of the per-slot fields and its cache, with its cut of the
   host arguments (:func:`cut`): the admission rows whose slots it owns
   (their slot ids made local), or its block of every per-slot array
   (the ragged wave's packed rows, the decode chunk, the verify wave,
   the deactivate mask). A replica with nothing live in the cut runs
   nothing (``None``), so each replica's kernel launches follow its
   own wave legs. Its products run under ``lt_gemm.row_share`` of its
   items: each GEMM by the algorithm of the whole batch's rows, and the
   products batched over the slots padded to the whole batch's count,
   so a row's bits are the dp = 1 engine's (on the H100 ``wo`` and the
   f32 logits by cuBLAS's own choice, and the decode's fresh scores
   batched over half the slots, were not);
 * rank 0 puts the replicas' outputs back in slot (or row) order
   (:func:`merge`): a replica that ran nothing contributes what the
   family gives an idle row (no token, not valid, not active).

Every decision is made on rank 0 from host data and the state's
``active`` flags, so the block tables, the admission order, the trie's
hits, evictions and copy-on-write copies, the lattice keys and the
ledgers are the dp = 1 engine's. The prefix caches share KV across
slots, hence across replicas; the KV moves to the slot, never the slot
to the KV:
 * paged: rank 0 keeps, per pool block of the trie, the replicas whose
   pool holds its KV (the replica whose slot wrote it, and those it was
   moved to since). Before a warm admission on replica d reads a shared
   or copy-on-write source block that d does not hold, the block moves
   from a holder (:func:`move_blocks`, one state-only command): each
   holder rank sends ``arr[:, bids]`` of every cache array (k, v and the
   int8 scales) to the rank of d at its own tp (and sp) coordinate;
 * dense: an admission family's KV writes stay on the replica that ran
   each row (:class:`RowWrites`), and each trie node's span goes from
   that replica to every other at its insertion
   (``prefix_cache.share_spans``), so every rank holds every node for
   its heads; the warm admission (``_admit_prefix_impl``) is a row
   family and the chunked seed (``_seed_prefix_impl``) runs on the
   replica of its slot (:data:`ONE_SLOT`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from seldon_tpu_torch.servers.prefix_cache import StoreGather

# Admission families: G rows, each writing the slot its ``slots`` row
# names (the index of ``slots`` among the arguments after the state).
ROW_FAMILIES = {"_admit_impl": 7, "_admit_prefix_impl": 9,
                "_admit_chunk_impl": 8, "_paged_admit_impl": 9,
                "_paged_admit_chunk_impl": 9}
# Families on one slot, named by the argument at this index: they run on
# the replica that owns it.
ONE_SLOT = {"_seed_prefix_impl": 1}
# Families over every slot: each array argument carries a row per slot
# (the ragged wave's packed tokens a block of ``C`` per slot).
SLOT_FAMILIES = frozenset({"_chunk_impl", "_paged_chunk_impl",
                           "_deactivate_impl", "_verify_impl",
                           "ragged_wave"})
# The copy-on-write block copy (the paged prefix cache's, and warmup's
# trash-block copy): every replica, on its own pool.
EVERY_REPLICA = frozenset({"_cow_copy_impl"})


def check_slots(max_slots: int, dp: int) -> None:
    """Raise unless ``max_slots`` splits evenly over ``dp`` replicas."""
    if max_slots % dp:
        raise ValueError(f"max_slots={max_slots} does not split over the "
                         f"dp={dp} replicas of the plan (max_slots % dp "
                         f"must be 0)")


def slot_range(replica: int, max_slots: int, dp: int) -> Tuple[int, int]:
    """(lo, hi): the slots replica ``replica`` owns."""
    n = max_slots // dp
    return replica * n, (replica + 1) * n


def replica_of(slot: int, max_slots: int, dp: int) -> int:
    """The replica that owns slot ``slot``."""
    return int(slot) // (max_slots // dp)


@dataclasses.dataclass
class Cut:
    """One replica's share of a family: its slots [lo, hi), its host
    arguments, for an admission the global rows it runs, and (``items``)
    how many of the whole batch's items (slots or admission rows) it
    runs, of how many: the products run under ``lt_gemm.row_share`` of
    them."""

    lo: int
    hi: int
    args: List[Any]
    kw: Dict[str, Any]
    rows: Optional[np.ndarray] = None
    items: Tuple[int, int] = (1, 1)


def cut(name: str, args: Sequence, kw: Dict[str, Any], lo: int, hi: int,
        active: np.ndarray) -> Optional[Cut]:
    """Replica [lo, hi)'s share of family ``name`` with host arguments
    ``args`` / ``kw``, or None when it has nothing to run. ``active`` is
    every slot's active flag before the family."""
    if name in EVERY_REPLICA:
        return Cut(lo, hi, list(args), dict(kw))
    if name in ONE_SLOT:
        i = ONE_SLOT[name]
        # The slot: an int, or the engine's [1] host scalar.
        slot = int(np.asarray(args[i]).reshape(-1)[0])
        if not lo <= slot < hi:
            return None
        out = list(args)
        out[i] = (np.array([slot - lo], np.int32)
                  if isinstance(args[i], np.ndarray) else slot - lo)
        return Cut(lo, hi, out, dict(kw))
    if name in ROW_FAMILIES:
        slots = np.asarray(args[ROW_FAMILIES[name]])
        rows = (slots >= lo) & (slots < hi)
        if not rows.any():
            return None
        out = [a[rows] if isinstance(a, np.ndarray)
               else _gather_rows(a, rows) if isinstance(a, StoreGather)
               else a for a in args]
        out[ROW_FAMILIES[name]] = (slots[rows] - lo).astype(slots.dtype)
        return Cut(lo, hi, out, dict(kw), rows,
                   (int(rows.sum()), len(slots)))
    if name not in SLOT_FAMILIES:
        raise ValueError(f"unknown device family {name!r}")
    B = active.shape[0]
    live = bool(active[lo:hi].any())
    kw = dict(kw)
    if name == "ragged_wave":
        pre = np.asarray(args[10])[lo:hi].any()
        live = live or bool(pre)
        if kw.get("has_prefill") is not None:
            kw["has_prefill"] = bool(pre)
    elif name == "_deactivate_impl":
        live = bool((~np.asarray(args[0])[lo:hi]).any())
    elif name == "_verify_impl":
        live = live or bool(np.asarray(args[2])[lo:hi].any())
    if not live:
        return None
    out = []
    for i, a in enumerate(args):
        if name == "ragged_wave" and i == 1:  # packed tokens [B * C]
            a = a.reshape(B, -1)[lo:hi].reshape(-1)
        elif isinstance(a, np.ndarray):
            a = a[lo:hi]
        out.append(a)
    return Cut(lo, hi, out, kw, items=(hi - lo, B))


def _gather_rows(g: StoreGather, rows: np.ndarray) -> StoreGather:
    """A warm admission's prefix paths of the rows in ``rows``."""
    return dataclasses.replace(g, rows=tuple(
        r for r, keep in zip(g.rows, rows) if keep))


def has_writes(name: str, kw: Dict[str, Any]) -> bool:
    """Whether family ``name`` called with ``kw`` returns its KV writes
    for the dense trie (its last output)."""
    return name == "_admit_prefix_impl" or bool(kw.get("return_sub"))


@dataclasses.dataclass
class RowWrites:
    """An admission family's KV writes for the dense trie under dp: each
    row's stay on the replica that ran it (``owner``, at ``index`` among
    its rows); rank 0 holds replica 0's (``local``, or None when it ran
    no row)."""

    local: Optional[Dict[str, torch.Tensor]]
    owner: np.ndarray
    index: np.ndarray


def row_writes(cuts: Dict[int, Cut], local) -> RowWrites:
    """The :class:`RowWrites` of a row family's ``cuts``; ``local`` is
    replica 0's writes."""
    G = len(next(iter(cuts.values())).rows)
    owner = np.full(G, -1, np.int64)
    index = np.full(G, -1, np.int64)
    for d, c in cuts.items():
        rows = np.flatnonzero(c.rows)
        owner[rows] = d
        index[rows] = np.arange(len(rows))
    return RowWrites(local, owner, index)


def move_blocks(cache: Dict[str, torch.Tensor], group, replica: int,
                src: int, dst: int, bids: Sequence[int]) -> int:
    """This rank's part of moving pool blocks ``bids`` from replica ``src``
    to replica ``dst`` (``group``: the rank's dp group, indexed by
    replica): on ``src``'s rank it sends ``arr[:, bids]`` of every cache
    array, in key order and in one buffer; on ``dst``'s it receives them
    into the same block ids of its pool (written in place, queued on the
    rank's stream before any later family). Returns the bytes it
    received."""
    if replica not in (src, dst):
        return 0
    idx = torch.tensor(list(bids), dtype=torch.long,
                       device=next(iter(cache.values())).device)
    keys = sorted(cache)
    if replica == src:
        group.send(torch.cat([cache[k][:, idx].contiguous().view(-1).view(
            torch.uint8) for k in keys]), dst)
        return 0
    parts = [(cache[k].shape[:1] + (len(bids),) + cache[k].shape[2:],
              cache[k].dtype) for k in keys]
    sizes = [int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
             for shape, dt in parts]
    flat = group.recv((sum(sizes),), torch.uint8, src)
    at = 0
    for k, (shape, dt), n in zip(keys, parts, sizes):
        cache[k][:, idx] = flat[at:at + n].view(dt).reshape(shape)
        at += n
    return at


def sub_state(state: Dict[str, Any], lo: int, hi: int) -> Dict[str, Any]:
    """The replica's view of a rank's state: its block of every per-slot
    field, and its cache."""
    return {k: v if k == "cache" else v[lo:hi] for k, v in state.items()}


def put_fields(state: Dict[str, Any],
               blocks: Sequence[Tuple[int, int, Dict[str, torch.Tensor]]]
               ) -> Dict[str, Any]:
    """A new state whose per-slot fields take each ``(lo, hi, fields)``
    block (new tensors: the old ones may still be read by a queued
    copy)."""
    if not blocks:
        return state
    out = dict(state)
    for k, v in state.items():
        if k == "cache":
            continue
        parts, at = [], 0
        for lo, hi, fields in sorted(blocks, key=lambda b: b[0]):
            parts += [v[at:lo], fields[k].to(v.device, v.dtype)]
            at = hi
        parts.append(v[at:])
        out[k] = torch.cat(parts)
    return out


def idle_outputs(name: str, args: Sequence, kw: Dict[str, Any], B: int,
                 pad: int, device) -> List[torch.Tensor]:
    """What family ``name`` returns (after the state) for B slots none of
    which is live: no first token, no token (``pad``), nothing valid or
    active."""
    def full(shape, fill, dtype):
        return torch.full(shape, fill, dtype=dtype, device=device)

    i32, b = torch.int32, torch.bool
    if name == "ragged_wave":
        return [full((B,), 0, i32), full((B,), False, b),
                full((1, B), pad, i32), full((1, B), False, b)]
    if name in ("_chunk_impl", "_paged_chunk_impl", "_verify_impl"):
        n = (kw["n_steps"] if name != "_verify_impl"
             else np.asarray(args[1]).shape[1] + 1)
        return [full((n, B), pad, i32), full((n, B), False, b),
                full((B,), False, b)]
    return []


def merge(name: str, args: Sequence, kw: Dict[str, Any],
          cuts: Dict[int, Cut], pieces: Dict[int, Sequence[torch.Tensor]],
          B: int, pad: int, device) -> tuple:
    """The family's outputs (after the state) for the whole batch, from
    each replica's ``pieces`` (on ``device``) in slot or row order."""
    if name in EVERY_REPLICA or name in ONE_SLOT:
        return ()
    if name in ROW_FAMILIES:
        G = len(args[ROW_FAMILIES[name]])
        first = next(iter(pieces.values()))
        outs = [torch.zeros((G,) + tuple(p.shape[1:]), dtype=p.dtype,
                            device=device) for p in first]
        for d, ps in pieces.items():
            rows = torch.from_numpy(cuts[d].rows).to(device)
            for o, p in zip(outs, ps):
                o[rows] = p
        return tuple(outs)
    outs = idle_outputs(name, args, kw, B, pad, device)
    for d, ps in pieces.items():
        lo, hi = cuts[d].lo, cuts[d].hi
        for i, p in enumerate(ps):
            outs[i] = outs[i].to(p.dtype)
            outs[i][..., lo:hi] = p
    return tuple(outs)
