"""Block-sparse ragged paged-attention partials — port of
``seldon_tpu/ops/ragged_paged_attention.py``.

The op computes attention PARTIALS, not outputs: ``(m, l, acc)`` —
running max, exp-sum and unnormalised value accumulator of every query
row against the pool positions ``t < bound[b, s]``, read through the
per-slot block table. Callers fold their own fresh columns in with
:func:`combine_fresh`. Layouts follow the JAX package: q
``[B, Sq, Hkv, G, Dh]`` grouped, partials ``[B, Hkv, G, Sq, (1|Dh)]`` f32.

Legs:
 * :func:`partials_reference` — full-width gather + closed-form partials
   (the parity oracle).
 * :func:`partials_sparse` — the PLAIN version of the kernel: a Python
   loop over the live block columns (``ceil(max(bound) / block)``).
 * :func:`partials_kernel` — the kernel wrapper. For CUDA tensors it
   launches the hand-written Hopper kernel
   (``csrc/ragged_paged_attention.cu``, the port of the TPU kernel
   ``_rpa_kernel``) or raises; for CPU tensors, and only then, it runs
   the plain version. Each call adds one to :data:`launches`. The kernel
   has two routes, picked from the rows ``R = G * Sq`` of one (slot,
   kv-head): below :data:`PREFILL_ROWS` the split-KV decode route on the
   CUDA cores (the walk cut into :func:`decode_split` splits whose
   partials a merge folds, the fold :func:`merge_partials` computes), at
   or above it the tensor-core (``wgmma``) prefill route.

:func:`ragged_paged_partials` dispatches ``mode="reference"`` or
``mode="pallas"``. The mode keeps its JAX name so ``RAGGED_KERNEL=pallas``
carries across unchanged; in the port it selects the hand-written CUDA
kernel. There is no fallback: a kernel that fails to build or launch
raises.

The ``"sparse"`` wave leg does not produce partials: it runs the
masked-MATCHED two-pass walk (:func:`sparse_max_sum`, then
:func:`sparse_weighted_value`), plain PyTorch on every device, as the
JAX package's twin is ``jnp``. It reproduces the masked leg's term set:
every softmax weight is normalised in f32, scaled, rounded to the query
dtype before it multiplies the value block, and the blocks accumulate in
f32 with one final cast by the caller, so the sparse and masked legs
differ only in f32 summation order and their greedy tokens agree. Both
passes walk ``n_live`` block columns; the wave passes the count the host
knows from its own descriptors (reading ``max(bound)`` would wait for
the device). A count above ``ceil(max(bound) / block)`` walks columns
whose lanes are all dead, which add exact zeros.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from seldon_tpu_torch.ops import _build
from seldon_tpu_torch.ops._build import check_tensor

NEG_INF = -1e30

# Documented |logits_kernel - logits_masked| bound (f32 logits), the JAX
# package's RAGGED_LOGITS_ATOL: the one-pass f32 partials reassociate the
# softmax and keep the value mix in f32 where the masked leg rounds the
# weights to bf16.
RAGGED_LOGITS_ATOL = 1e-2

MODES = ("reference", "sparse", "pallas")

Partials = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Pool = Dict[str, torch.Tensor]

# Kernel launches since the last reset (the wrapper's plain integer
# counter; chip_smoke.py zeroes it before driving the serving path).
launches = 0

# The kernel's routes: rows R = G * Sq of one (slot, kv-head) at or above
# this run on the tensor cores (one 64-row warpgroup tile), below it on the
# split-KV decode route, whose splits cover SPLIT_POSITIONS pool positions
# each (a whole number of the route's 32-position steps).
PREFILL_ROWS = 64
SPLIT_POSITIONS = 128


def decode_split(nbs: int, block: int) -> Tuple[int, int]:
    """The decode route's split plan ``(n_split, span)``: split i walks
    the pool positions ``[i * span, (i + 1) * span)`` of its slot, span =
    SPLIT_POSITIONS. ``n_split`` follows the table's width, ``nbs * block``
    positions, never the bounds (reading them would wait for the device):
    a 2048-position table gives 16 splits, so a slot near the end of it
    is walked by 16 CTAs, and a serving slot of a few hundred positions
    by up to 4."""
    return -(-(nbs * block) // SPLIT_POSITIONS), SPLIT_POSITIONS


def _block_scores(qr, kb, k_scale_b, mask):
    """One block column's masked scores [B, Hkv, G, Sq, block] f32; int8
    keys are exact in bf16 and the scale multiplies the f32 scores."""
    Dh = qr.shape[-1]
    s = torch.einsum("bskgd,bktd->bkgst", qr.float(),
                     kb.to(qr.dtype).float()) / (Dh ** 0.5)
    if k_scale_b is not None:
        s = s * k_scale_b.float()[:, :, None, None, :]
    return torch.where(mask[:, None, None, :, :], s, NEG_INF)


def _block_accumulate(carry: Partials, s, p_mask, vb, v_scale_b) -> Partials:
    """Online-softmax fold of one block column into (m, l, acc); the
    ``where`` on p guards the all-masked prefix (m still at NEG_INF would
    make exp(s - m) == 1 on dead lanes)."""
    m, l, acc = carry
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    p = torch.where(p_mask[:, None, None, :, :], torch.exp(s - m_new), 0.0)
    alpha = torch.exp(m - m_new)
    pw = p if v_scale_b is None else p * v_scale_b.float()[:, :, None, None, :]
    acc = acc * alpha + torch.einsum("bkgst,bktd->bkgsd", pw, vb.float())
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    return m_new, l, acc


def _init_partials(B, Hkv, G, Sq, Dh, device) -> Partials:
    return (
        torch.full((B, Hkv, G, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=device),
        torch.zeros((B, Hkv, G, Sq, 1), dtype=torch.float32, device=device),
        torch.zeros((B, Hkv, G, Sq, Dh), dtype=torch.float32, device=device),
    )


def combine_fresh(partials: Partials, s_fresh: torch.Tensor,
                  v_fresh: torch.Tensor,
                  p_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fold fresh score columns into pool partials and normalise.

    s_fresh [B, Hkv, G, Sq, F] f32 (masked to NEG_INF where invisible; at
    least one live column per row unless ``p_mask`` re-zeroes dead
    lanes); v_fresh [B, Hkv, F, Dh]. Returns [B, Sq, Hkv*G*Dh] f32."""
    m, l, acc = partials
    m_t = torch.maximum(m, s_fresh.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m - m_t)
    p_f = torch.exp(s_fresh - m_t)
    if p_mask is not None:
        p_f = torch.where(p_mask, p_f, 0.0)
    l_t = l * alpha + p_f.sum(dim=-1, keepdim=True)
    out = acc * alpha + torch.einsum("bkgsf,bkfd->bkgsd", p_f,
                                     v_fresh.float())
    out = out / torch.clamp(l_t, min=1e-30)
    B, Hkv, G, Sq, Dh = out.shape
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hkv * G * Dh)


# ---------------------------------------------------------------------------
# Reference (full-width gather) — the parity oracle
# ---------------------------------------------------------------------------


def partials_reference(q: torch.Tensor, pool_layer: Pool,
                       table: torch.Tensor, bound: torch.Tensor) -> Partials:
    """Full-width gather + closed-form partials. q [B, Sq, Hkv, G, Dh];
    pool_layer {"k","v"[,"k_scale","v_scale"]} [NB, Hkv, block, (Dh)];
    table [B, nbs] int32; bound [B, Sq] int32."""
    B, Sq = bound.shape
    nbs = table.shape[1]
    block = pool_layer["k"].shape[2]
    tl = table.long()

    def gather(key):
        g = pool_layer[key][tl].movedim(1, 2)  # [B, Hkv, nbs, block, (Dh)]
        return g.reshape(g.shape[0], g.shape[1], g.shape[2] * g.shape[3],
                         *g.shape[4:])

    ck, cv = gather("k"), gather("v")
    ks = gather("k_scale") if "k_scale" in pool_layer else None
    vs = gather("v_scale") if "v_scale" in pool_layer else None
    t = torch.arange(nbs * block, device=q.device)
    mask = t[None, None, :] < bound[:, :, None]
    s = _block_scores(q, ck, ks, mask)
    init = _init_partials(B, q.shape[2], q.shape[3], Sq, q.shape[4],
                          q.device)
    return _block_accumulate(init, s, mask, cv, vs)


# ---------------------------------------------------------------------------
# The plain version of the kernel
# ---------------------------------------------------------------------------


def partials_sparse(q: torch.Tensor, pool_layer: Pool, table: torch.Tensor,
                    bound: torch.Tensor) -> Partials:
    """Walk only live block columns, ``ceil(max(bound) / block)`` of them
    (reading the count waits for the device). Rows shorter than the
    longest mask their dead tail lanes; rows past their own table prefix
    gather the trash block (table tails are 0) and mask it the same way."""
    B, Sq = bound.shape
    nbs = table.shape[1]
    block = pool_layer["k"].shape[2]
    quantized = "k_scale" in pool_layer
    offs = torch.arange(block, device=q.device)
    carry = _init_partials(B, q.shape[2], q.shape[3], Sq, q.shape[4],
                           q.device)
    n_live = min(nbs, -(-int(bound.max()) // block)) if bound.numel() else 0
    for j in range(n_live):
        bids = table[:, j].long()
        kb = pool_layer["k"][bids]  # [B, Hkv, block, Dh]
        vb = pool_layer["v"][bids]
        ks = pool_layer["k_scale"][bids] if quantized else None
        vs = pool_layer["v_scale"][bids] if quantized else None
        mask = (j * block + offs)[None, None, :] < bound[:, :, None]
        s = _block_scores(q, kb, ks, mask)
        carry = _block_accumulate(carry, s, mask, vb, vs)
    return carry


def merge_partials(parts) -> Partials:
    """Fold the partials of disjoint position ranges of the same rows into
    one (the decode route's merge): ``m = max m_i``, ``l = sum l_i
    e^(m_i - m)``, ``acc = sum acc_i e^(m_i - m)``, in the order of
    ``parts``. A range with no live position for a row is
    ``(NEG_INF, 0, 0)`` there and weighs 0 beside a live one; a row with
    no live range stays exactly ``(NEG_INF, 0, 0)``."""
    m = parts[0][0]
    for mi, _, _ in parts[1:]:
        m = torch.maximum(m, mi)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for mi, li, ai in parts:
        w = torch.exp(mi - m)
        l = l + li * w
        acc = acc + ai * w
    return m, l, acc


# ---------------------------------------------------------------------------
# Masked-matched two-pass walk — the sparse wave leg
# ---------------------------------------------------------------------------
#
# ``dequant`` selects which masked kernel is matched: False for the
# factored-scale decode path (scores x k_scale in f32 after the product,
# weights x v_scale in f32 before the cast); True for the prefill path,
# which dequantizes the int8 prefix KV into the activation dtype FIRST
# (_run_blocks_prefill_prefix's ``pk * k_scale``, rounded there) and runs
# unscaled attention over it.


def live_columns(bound: torch.Tensor, block: int, nbs: int,
                 n_live: Optional[int] = None) -> int:
    """The walk's trip count: ``n_live`` when the caller knows it (the
    host's count), else ``ceil(max(bound) / block)`` read from ``bound``
    (which waits for the device); clipped to the table's width."""
    if n_live is None:
        n_live = -(-int(bound.max()) // block) if bound.numel() else 0
    return max(0, min(nbs, int(n_live)))


def _sparse_block(pool_layer: Pool, table: torch.Tensor, j: int,
                  dtype: torch.dtype, dequant: bool):
    """Gather block column j: (kb, vb, k_scale, v_scale) with the
    dequant-vs-factored convention applied. The dequantized block is a
    materialized ``dtype`` tensor, rounded as the masked twin's (the JAX
    twin pins it with an ``optimization_barrier``)."""
    bids = table[:, j].long()
    kb = pool_layer["k"][bids]  # [B, Hkv, block, Dh]
    vb = pool_layer["v"][bids]
    ks = pool_layer["k_scale"][bids] if "k_scale" in pool_layer else None
    vs = pool_layer["v_scale"][bids] if "v_scale" in pool_layer else None
    if dequant and ks is not None:
        kb = kb.to(dtype) * ks[..., None].to(dtype)
        vb = vb.to(dtype) * vs[..., None].to(dtype)
        ks = vs = None
    return kb, vb, ks, vs


def sparse_max_sum(q: torch.Tensor, pool_layer: Pool, table: torch.Tensor,
                   bound: torch.Tensor, dequant: bool = False,
                   n_live: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pass 1 of the matched walk: running max ``m`` and exp-sum ``l``
    (relative to m) of the live pool scores, no value traffic. Shapes as
    the partials' ``[B, Hkv, G, Sq, 1]``; dead rows stay (NEG_INF, 0)."""
    B, Sq = bound.shape
    block = pool_layer["k"].shape[2]
    offs = torch.arange(block, device=q.device)
    m = torch.full((B, q.shape[2], q.shape[3], Sq, 1), NEG_INF,
                   dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    for j in range(live_columns(bound, block, table.shape[1], n_live)):
        kb, _, ks, _ = _sparse_block(pool_layer, table, j, q.dtype, dequant)
        mask = (j * block + offs)[None, None, :] < bound[:, :, None]
        s = _block_scores(q, kb, ks, mask)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(mask[:, None, None, :, :], torch.exp(s - m_new), 0.0)
        l = l * torch.exp(m - m_new) + p.sum(dim=-1, keepdim=True)
        m = m_new
    return m, l


def sparse_weighted_value(q: torch.Tensor, pool_layer: Pool,
                          table: torch.Tensor, bound: torch.Tensor,
                          m_t: torch.Tensor, l_t: torch.Tensor,
                          dequant: bool = False,
                          n_live: Optional[int] = None) -> torch.Tensor:
    """Pass 2 of the matched walk: ``sum_t round(exp(s_t - m_t) / l_t
    [* v_scale]) . v_t`` over the live pool columns, f32 accumulation
    across blocks. ``m_t``/``l_t`` are the GLOBAL max / exp-sum after the
    caller folded its fresh columns in, so each weight is the very number
    the masked kernel rounds to the query dtype. Returns [B, Hkv, G, Sq,
    Dh] f32, cast once by the caller."""
    B, Sq = bound.shape
    block = pool_layer["k"].shape[2]
    offs = torch.arange(block, device=q.device)
    l_safe = torch.clamp(l_t, min=1e-30)
    acc = torch.zeros((B, q.shape[2], q.shape[3], Sq, q.shape[4]),
                      dtype=torch.float32, device=q.device)
    for j in range(live_columns(bound, block, table.shape[1], n_live)):
        kb, vb, ks, vs = _sparse_block(pool_layer, table, j, q.dtype,
                                       dequant)
        mask = (j * block + offs)[None, None, :] < bound[:, :, None]
        s = _block_scores(q, kb, ks, mask)
        # Re-zero dead lanes BEFORE dividing: with bound = 0 and m_t at
        # NEG_INF, exp(s - m_t) would be exp(0) on every lane.
        w = torch.where(mask[:, None, None, :, :], torch.exp(s - m_t),
                        0.0) / l_safe
        if vs is not None:
            w = w * vs.float()[:, :, None, None, :]
        acc = acc + torch.einsum("bkgst,bktd->bkgsd",
                                 w.to(q.dtype).float(),
                                 vb.to(q.dtype).float())
    return acc


# ---------------------------------------------------------------------------
# The hand-written CUDA kernel
# ---------------------------------------------------------------------------

_lib: Optional[ctypes.CDLL] = None


def _kernel_lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/ragged_paged_attention.cu``."""
    global _lib
    if _lib is None:
        lib = _build.load("ragged_paged_attention")
        fn = lib.rpa_partials
        fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def partials_kernel(q: torch.Tensor, pool_layer: Pool, table: torch.Tensor,
                    bound: torch.Tensor) -> Partials:
    """The kernel wrapper: same (m, l, acc) contract as the plain legs.

    CUDA tensors launch the Hopper kernel on the current stream: the
    decode route (R = G * Sq < PREFILL_ROWS) with its split plan from
    :func:`decode_split` and, for more than one split, a workspace for the
    splits' partials, merged on the device by the same call; the
    tensor-core route otherwise. Outputs and workspace are allocated here;
    the launch is checked and any error raises. CPU tensors run
    :func:`partials_sparse`. Anything else — a CUDA tensor the kernel does
    not take — raises. The table entries of live columns must be block ids
    of the pool; the kernel does not range-check them (reading them back
    would wait for the device)."""
    if not q.is_cuda:
        return partials_sparse(q, pool_layer, table, bound)
    global launches
    B, Sq, Hkv, G, Dh = q.shape
    NB, _, block, _ = pool_layer["k"].shape
    nbs = table.shape[1]
    quantized = "k_scale" in pool_layer
    dev = q.device
    kv_dtype = torch.int8 if quantized else torch.bfloat16
    check_tensor("q", q, torch.bfloat16, (B, Sq, Hkv, G, Dh), dev)
    check_tensor("k", pool_layer["k"], kv_dtype, (NB, Hkv, block, Dh),
                 dev)
    check_tensor("v", pool_layer["v"], kv_dtype, (NB, Hkv, block, Dh),
                 dev)
    if quantized:
        for key in ("k_scale", "v_scale"):
            check_tensor(key, pool_layer[key], torch.bfloat16,
                         (NB, Hkv, block), dev)
    check_tensor("table", table, torch.int32, (B, nbs), dev)
    check_tensor("bound", bound, torch.int32, (B, Sq), dev)
    if Dh not in (16, 64, 128) or not 1 <= block <= 64:
        raise ValueError(f"kernel built for Dh in (16, 64, 128) and "
                         f"block <= 64, got Dh={Dh} block={block}")
    R = G * Sq
    n_split, span = decode_split(nbs, block) if R < PREFILL_ROWS else (1, 1)
    m = torch.empty((B, Hkv, G, Sq, 1), dtype=torch.float32, device=dev)
    l = torch.empty_like(m)
    acc = torch.empty((B, Hkv, G, Sq, Dh), dtype=torch.float32, device=dev)
    ws = (torch.empty(B * Hkv * n_split * R * (Dh + 2), dtype=torch.float32,
                      device=dev) if n_split > 1 else None)
    lib = _kernel_lib()
    err = lib.rpa_partials(
        q.data_ptr(), pool_layer["k"].data_ptr(), pool_layer["v"].data_ptr(),
        pool_layer["k_scale"].data_ptr() if quantized else None,
        pool_layer["v_scale"].data_ptr() if quantized else None,
        table.data_ptr(), bound.data_ptr(), m.data_ptr(), l.data_ptr(),
        acc.data_ptr(), None if ws is None else ws.data_ptr(), B, Sq, Hkv, G,
        Dh, block, nbs, NB, int(quantized), n_split, span,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"ragged paged-attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return m, l, acc


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def ragged_paged_partials(
    q: torch.Tensor,  # [B, Sq, Hkv, G, Dh] grouped queries
    pool_layer: Pool,  # one layer's paged pool slice
    table: torch.Tensor,  # [B, nbs] int32 block tables
    bound: torch.Tensor,  # [B, Sq] int32 — attend pool t < bound
    mode: str = "pallas",
) -> Partials:
    """``"pallas"``: the kernel wrapper (the hand-written CUDA kernel on
    the card, its plain version on the CPU); ``"sparse"``: the plain
    walker :func:`partials_sparse`, as the JAX dispatch's ``"sparse"``
    (the sparse WAVE leg runs the two-pass walk instead, not this);
    ``"reference"``: the full-width oracle. No fallback between them."""
    if mode == "pallas":
        return partials_kernel(q, pool_layer, table, bound)
    if mode == "sparse":
        return partials_sparse(q, pool_layer, table, bound)
    if mode == "reference":
        return partials_reference(q, pool_layer, table, bound)
    raise ValueError(f"unknown ragged kernel mode {mode!r} (modes: "
                     f"{MODES})")
