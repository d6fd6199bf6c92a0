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
``active`` flags, so the block tables, the admission order, the lattice
keys and the ledgers are the dp = 1 engine's. The prefix caches share
KV across slots, hence across replicas, so they are refused under dp > 1
(:data:`REFUSED`, and the engine refuses ``prefix_cache``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Admission families: G rows, each writing the slot its ``slots`` row
# names (the index of ``slots`` among the arguments after the state).
ROW_FAMILIES = {"_admit_impl": 7, "_admit_chunk_impl": 8,
                "_paged_admit_impl": 9, "_paged_admit_chunk_impl": 9}
# Families over every slot: each array argument carries a row per slot
# (the ragged wave's packed tokens a block of ``C`` per slot).
SLOT_FAMILIES = frozenset({"_chunk_impl", "_paged_chunk_impl",
                           "_deactivate_impl", "_verify_impl",
                           "ragged_wave"})
# The copy-on-write block copy (the paged prefix cache's, and warmup's
# trash-block copy): every replica, on its own pool.
EVERY_REPLICA = frozenset({"_cow_copy_impl"})
# The dense prefix cache's families: its trie spans a slot's KV into
# any other slot, which may sit on another replica.
REFUSED = frozenset({"_admit_prefix_impl", "_seed_prefix_impl"})


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
    if name in REFUSED:
        raise ValueError(f"{name} (the dense prefix cache) does not run "
                         f"under dp > 1")
    if name in EVERY_REPLICA:
        return Cut(lo, hi, list(args), dict(kw))
    if name in ROW_FAMILIES:
        slots = np.asarray(args[ROW_FAMILIES[name]])
        rows = (slots >= lo) & (slots < hi)
        if not rows.any():
            return None
        out = [a[rows] if isinstance(a, np.ndarray) else a for a in args]
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
    if name in EVERY_REPLICA:
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
