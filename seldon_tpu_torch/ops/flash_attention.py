"""Flash attention (blockwise online softmax) — port of
``seldon_tpu/ops/flash_attention.py``.

Layout, as in the JAX package: q ``[B*H, Sq, Dh]``, k/v ``[B*Hkv, Skv,
Dh]``; callers fold batch and heads. GQA is native: query row ``b`` reads
KV row ``b // q_per_kv``. ``causal=True`` masks with the global positions
``q_offset + i >= j``.

Legs:
 * :func:`attention_reference` — the closed-form oracle (full score
   matrix, softmax rounded to q's dtype before the value product).
 * :func:`flash_blockwise` — the PLAIN version of the kernel: a loop over
   KV blocks with the TPU kernel's rounding points (scores summed in f32
   and then scaled; ``l`` sums the unrounded probabilities, the value
   product takes them rounded to v's dtype; ``acc / max(l, 1e-30)``
   rounded to q's dtype). A tail block that ``block_k`` does not divide
   is cut short, which is what masking its dead columns to ``NEG_INF``
   gives exactly (their probabilities underflow to 0). For bf16 tensors
   on the card the scores are the matrix unit's bf16 product with f32
   accumulation (see :func:`_block_scores`).
 * :func:`flash_kernel` — the kernel wrapper, the counterpart of
   ``_flash_pallas``. For CUDA tensors it launches a hand-written Hopper
   kernel, the port of the TPU kernel ``_flash_kernel``, or raises: bf16
   runs on the tensor cores (``csrc/flash_attention.cu``, ``wgmma``), f32
   on them too as 3xTF32 ``wgmma`` chains (``csrc/flash_attention_f32.cu``:
   each f32 operand split into two TF32 parts, ``ops/_tf32.py``, which
   keeps f32 accuracy). For CPU tensors,
   and only then, it runs the plain version. Each launch adds one to
   :data:`launches` and to its entry point's count in
   :data:`entry_launches`, through ``ops/host_hooks.host_callback``: at
   once on the eager route, after every replay of a captured program
   that holds the launch (``servers/wave_program.py``), never in a
   capture's warm run.

:func:`flash_attention` dispatches with the JAX signature. Unlike the
JAX dispatch it has no fallback: the kernel masks ragged tails itself,
so any ``Sq``/``Skv`` runs on it, and a failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Dict

import torch

from seldon_tpu_torch.ops import _build, host_hooks
from seldon_tpu_torch.ops._build import check_tensor

DEFAULT_BLOCK_Q = 128
DEFAULT_BLOCK_K = 128
NEG_INF = -1e30

# Head dims the CUDA kernels are built for, and the KV block they walk
# (their block is the plain version's block_k: the rescaling points, and
# hence the bf16 rounding of the probabilities, depend on it).
KERNEL_HEAD_DIMS = (16, 64, 128)
KERNEL_BLOCK_K = 128

# The two routes of the kernel, by input dtype: (library = csrc/<name>.cu,
# C entry point).
ENTRY = {
    torch.bfloat16: ("flash_attention", "flash_attention_bf16_fwd"),
    torch.float32: ("flash_attention_f32", "flash_attention_f32_fwd"),
}

# Kernel launches since the last reset (the wrapper's plain integer
# counters, all routes and by entry point; chip_smoke.py zeroes them with
# reset_launches before driving a path).
launches = 0
entry_launches = {fn: 0 for _, fn in ENTRY.values()}


def reset_launches() -> None:
    global launches
    launches = 0
    for fn in entry_launches:
        entry_launches[fn] = 0


def _scale(Dh: int) -> float:
    return Dh ** -0.5


def _causal_keep(Sq: int, Skv: int, q_offset: int,
                 device: torch.device) -> torch.Tensor:
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    kj = torch.arange(Skv, device=device)[None, :]
    return qi >= kj


# ---------------------------------------------------------------------------
# Reference — the closed-form oracle
# ---------------------------------------------------------------------------


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        q_offset: int = 0) -> torch.Tensor:
    """q [BH, Sq, Dh], k/v [BH, Skv, Dh] (KV already expanded). Scores in
    f32, softmax in f32 rounded to q's dtype, value product summed in f32
    and rounded to q's dtype."""
    scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) \
        * _scale(q.shape[-1])
    if causal:
        keep = _causal_keep(q.shape[1], k.shape[1], q_offset, q.device)
        scores = torch.where(keep, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bqk,bkd->bqd", w.float(), v.float()).to(q.dtype)


def _expand_kv(x: torch.Tensor, q_per_kv: int) -> torch.Tensor:
    if q_per_kv == 1:
        return x
    return torch.repeat_interleave(x, q_per_kv, dim=0)


# ---------------------------------------------------------------------------
# The plain version of the kernel
# ---------------------------------------------------------------------------


def _check_group(q: torch.Tensor, k: torch.Tensor, q_per_kv: int) -> None:
    if k.shape[0] * q_per_kv != q.shape[0]:
        raise ValueError(f"kv rows {k.shape[0]} x group {q_per_kv} != q "
                         f"rows {q.shape[0]}")


def _block_scores(qg: torch.Tensor, kb: torch.Tensor,
                  scores_f32: bool) -> torch.Tensor:
    """q . k summed in f32 (not yet scaled): qg [B*Hkv, G, R, Dh] against
    kb [B*Hkv, C, Dh], in their dtype; returns [B*Hkv, G, R, C] f32.

    The TPU kernel takes ``dot_general(bf16, bf16,
    preferred_element_type=f32)``: bf16 products summed in f32 by the
    matrix unit, in the order the unit takes. For bf16 tensors on the card
    this is the tensor cores' bf16 product with f32 accumulation
    (``torch.bmm(..., out_dtype=float32)``), whose f32 sums run in the
    order of the kernel's wgmma chain. Any other f32 order (an f32 GEMM,
    ``scores_f32``, and the only one on the CPU) gives sums as accurate but
    not the same numbers, and p = exp(s - m) is rounded to bf16 before
    the value product: where that rounding sits on a knife's edge the two
    round p apart, and a flipped p of large weight moves a small output
    by more than one bf16 ulp."""
    G, R, Dh = qg.shape[1:]
    if qg.is_cuda and qg.dtype == torch.bfloat16 and not scores_f32:
        return torch.bmm(qg.reshape(qg.shape[0], G * R, Dh),
                         kb.transpose(1, 2),
                         out_dtype=torch.float32).view(-1, G, R, kb.shape[1])
    return torch.matmul(qg.float(), kb[:, None].float().transpose(-1, -2))


def flash_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0,
                    block_k: int = DEFAULT_BLOCK_K,
                    q_per_kv: int = 1,
                    scores_f32: bool = False) -> torch.Tensor:
    """Online softmax over KV blocks of ``min(block_k, Skv)`` positions.

    The query axis is not tiled: a block's columns that a row cannot see
    give it p = 0 and alpha = 1, so the rows above a block's first
    visible column are left out of that block's update, and blocks past
    the last row's diagonal are skipped, exactly as the TPU kernel's
    per-tile skip. ``scores_f32`` sums the scores with an f32 matmul
    also for bf16 tensors on the card (see :func:`_block_scores`).
    Returns [BH, Sq, Dh] in q's dtype."""
    _check_group(q, k, q_per_kv)
    BH, Sq, Dh = q.shape
    Skv = k.shape[1]
    if Sq < 1 or Skv < 1:
        raise ValueError(f"empty attention: Sq={Sq}, Skv={Skv}")
    bk = min(block_k, Skv)
    scale = _scale(Dh)
    # Grouped view: [B*Hkv, G, Sq, Dh] against KV rows [B*Hkv, Skv, Dh].
    qg = q.reshape(BH // q_per_kv, q_per_kv, Sq, Dh)
    m = torch.full((*qg.shape[:3], 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=q.device)
    last_col = Skv - 1 if not causal else min(Skv - 1, q_offset + Sq - 1)
    for c0 in range(0, last_col + 1, bk):
        c1 = min(c0 + bk, Skv)
        # Rows that see a column of this block: q_offset + i >= c0.
        r0 = max(0, c0 - q_offset) if causal else 0
        vb = v[:, None, c0:c1]
        s = _block_scores(qg[:, :, r0:], k[:, c0:c1], scores_f32) * scale
        if causal:
            keep = _causal_keep(Sq - r0, c1 - c0, q_offset + r0 - c0,
                                q.device)
            s = torch.where(keep, s, NEG_INF)
        m_prev = m[:, :, r0:]
        m_new = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m_prev - m_new)
        l[:, :, r0:] = alpha * l[:, :, r0:] + p.sum(dim=-1, keepdim=True)
        acc[:, :, r0:] = acc[:, :, r0:] * alpha + torch.matmul(
            p.to(v.dtype).float(), vb.float())
        m[:, :, r0:] = m_new
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(BH, Sq, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# The hand-written CUDA kernel
# ---------------------------------------------------------------------------

_fns: Dict[torch.dtype, Callable[..., int]] = {}


def _kernel_fn(dtype: torch.dtype) -> Callable[..., int]:
    """Build (at first use) and bind the entry point for ``dtype``."""
    if dtype not in _fns:
        lib_name, fn_name = ENTRY[dtype]
        fn = getattr(_build.load(lib_name), fn_name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 \
            + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return _fns[dtype]


def flash_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, q_offset: int,
                 block_q: int = DEFAULT_BLOCK_Q,
                 block_k: int = DEFAULT_BLOCK_K,
                 q_per_kv: int = 1) -> torch.Tensor:
    """The kernel wrapper, with ``_flash_pallas``'s arguments.

    CUDA tensors launch the Hopper kernel on the current stream (the
    output is allocated here; the launch is checked and any error
    raises). CPU tensors run :func:`flash_blockwise`. A CUDA tensor the
    kernel does not take raises. ``block_q`` does not change the result
    (see :func:`flash_blockwise`): both kernels tile queries by 128.
    ``block_k`` does, and the kernels walk KV blocks of 128,
    so they take a ``block_k`` of 128, or any ``block_k >= Skv`` (one
    block)."""
    if not q.is_cuda:
        return flash_blockwise(q, k, v, causal, q_offset, block_k, q_per_kv)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise NotImplementedError(
            "flash attention has no backward kernel: the Hopper kernel "
            "ports the forward-only TPU kernel (seldon_tpu/ops/"
            "flash_attention.py defines no custom_vjp); train with "
            "attn_impl 'xla' or 'ring'")
    _check_group(q, k, q_per_kv)
    BH, Sq, Dh = q.shape
    Skv = k.shape[1]
    dev = q.device
    if q.dtype not in ENTRY:
        raise TypeError(f"q has dtype {q.dtype}, expected bfloat16 or "
                        f"float32")
    check_tensor("q", q, q.dtype, (BH, Sq, Dh), dev)
    check_tensor("k", k, q.dtype, (BH // q_per_kv, Skv, Dh), dev)
    check_tensor("v", v, q.dtype, (BH // q_per_kv, Skv, Dh), dev)
    if Dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"kernel built for Dh in {KERNEL_HEAD_DIMS}, got "
                         f"Dh={Dh}")
    if min(block_k, Skv) != min(KERNEL_BLOCK_K, Skv):
        raise ValueError(f"kernel walks KV blocks of {KERNEL_BLOCK_K}, got "
                         f"block_k={block_k} for Skv={Skv}")
    if Sq < 1 or Skv < 1 or q_offset < 0:
        raise ValueError(f"kernel needs Sq, Skv >= 1 and q_offset >= 0, got "
                         f"Sq={Sq} Skv={Skv} q_offset={q_offset}")
    out = torch.empty_like(q)
    err = _kernel_fn(q.dtype)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, Sq,
        Skv, Dh, q_per_kv, int(causal), q_offset, _scale(Dh),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash attention kernel launch failed: "
                           f"cudaError {err}")
    host_hooks.host_callback(functools.partial(_count, ENTRY[q.dtype][1]))
    return out


def _count(entry: str) -> None:
    """One launch of ``entry``'s route: now on the eager route, at each
    replay of a captured program that launches it
    (``ops/host_hooks.host_callback``)."""
    global launches
    launches += 1
    entry_launches[entry] += 1


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


def flash_attention(
    q: torch.Tensor,  # [B*H, Sq, Dh]
    k: torch.Tensor,  # [B*Hkv, Skv, Dh] (Hkv == H / q_per_kv)
    v: torch.Tensor,
    causal: bool = True,
    q_offset: int = 0,
    q_per_kv: int = 1,
    block_q: int = DEFAULT_BLOCK_Q,
    block_k: int = DEFAULT_BLOCK_K,
    force_pallas: bool = False,
    force_reference: bool = False,
) -> torch.Tensor:
    """``force_reference``: the closed-form oracle (KV expanded to the
    query heads). Otherwise the kernel wrapper: the hand-written CUDA
    kernel for CUDA tensors, its plain version for CPU tensors.
    ``force_pallas`` keeps its JAX name and demands the kernel: with a CPU
    tensor it raises."""
    if force_reference:
        return attention_reference(q, _expand_kv(k, q_per_kv),
                                   _expand_kv(v, q_per_kv), causal, q_offset)
    if force_pallas and not q.is_cuda:
        raise ValueError(f"force_pallas: the flash kernel runs on CUDA "
                         f"tensors, q is on {q.device}")
    return flash_kernel(q, k, v, causal, q_offset, block_q, block_k,
                        q_per_kv)
