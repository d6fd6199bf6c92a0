"""Weight-only int8 quantization for serving — port of
``seldon_tpu/models/quantize.py``.

Scheme: symmetric per-OUTPUT-CHANNEL scales over axis -2 (the input
axis of an ``x @ W`` weight), so ``w ~ w_q.to(bf16) * scale``. Each
quantized weight ``name`` of a :class:`~seldon_tpu_torch.models.
transformer.Block` (and ``embed`` / ``lm_head`` of the model) becomes an
int8 buffer ``name`` beside an f32 buffer ``name_scale``;
``transformer._w`` dequantizes at use. Norm gains and the MoE router
stay full precision.

On the card the dequantized bf16 copy of a weight is materialized at
every use (``dequant`` is two eager ops); the JAX package has XLA fuse
the convert and multiply into the matmul's operand read. The algebra and
the rounding (one bf16 product) are the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

# Block leaves quantized per output channel. Norm gains and the MoE router
# stay full precision.
_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def true_div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as one IEEE division on every device. On CUDA, PyTorch
    divides by a Python number as a product with its reciprocal, which
    can land one ulp away from the quotient that ``jnp``, and PyTorch on
    the CPU, compute; a divisor tensor keeps the division."""
    return t / torch.full_like(t, c)


def _quantize_leaf(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 w_q, f32 scale broadcastable against w): the scale is
    ``max(|w|) / 127`` over axis -2, floored at 1e-12; codes are
    ``clip(round(w / scale), -127, 127)`` with ``torch.round``'s
    half-to-even, as ``jnp.round``. The f32 work tensor is updated in
    place (an 8B model's ``lm_head`` is 2 GB in f32)."""
    wf = w.float()
    scale = torch.clamp(true_div(wf.abs().amax(dim=-2, keepdim=True), 127.0),
                        min=1e-12)
    if wf.data_ptr() == w.data_ptr():
        wf = wf.clone()
    w_q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return w_q, scale


def is_quantized(params: nn.Module) -> bool:
    return getattr(params, "embed_scale", None) is not None


def set_quantized(module: nn.Module, name: str, w_q: torch.Tensor,
                  scale: torch.Tensor) -> None:
    """Replace ``module.name`` (a parameter or a buffer) by the int8
    buffer ``w_q`` and set the buffer ``name_scale``.

    A 2-D projection weight is stored column-major: the same logical
    ``[in, out]`` tensor with strides ``(1, in)``. cuBLASLt's int8 GEMM
    behind ``torch._int_mm`` runs its tensor-core kernel for a
    column-major second operand and a much slower compatibility kernel
    for a row-major one (chip_smoke.py times both layouts; PERF.md)."""
    if name in _BLOCK_WEIGHTS and w_q.dim() == 2:
        w_q = w_q.t().contiguous().t()
    module._parameters.pop(name, None)
    module._buffers.pop(name, None)
    module.register_buffer(name, w_q)
    module.register_buffer(f"{name}_scale", scale)


@torch.no_grad()
def quantize_params(params: nn.Module) -> nn.Module:
    """int8-quantize the matmul weights of a transformer (blocks, embed
    and lm_head) IN PLACE and return it; each quantized weight gets its
    ``*_scale`` buffer. The JAX twin returns a new tree; a second copy of
    a multi-gigabyte model is not affordable here, so the bf16 leaves are
    dropped as they are replaced. Idempotent: re-quantizing an int8 model
    would compute scale = max(|int8|)/127 ~ 1 and drop the real
    per-channel scales."""
    if is_quantized(params):
        return params
    for bp in params.blocks:
        for name in _BLOCK_WEIGHTS:
            w = getattr(bp, name, None)
            if w is None:
                continue
            set_quantized(bp, name, *_quantize_leaf(w))
    # Embed rows are gathered then (tied logits) multiplied: the scale
    # over axis -2 of [V, D] is per COLUMN, a plain broadcast for both.
    set_quantized(params, "embed", *_quantize_leaf(params.embed))
    if params.lm_head is not None:
        set_quantized(params, "lm_head", *_quantize_leaf(params.lm_head))
    return params


def dequant(w: torch.Tensor, scale: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """Dequantize at use: ``w.to(dtype) * scale.to(dtype)``, one product
    rounded to ``dtype`` as in JAX."""
    if scale is None:
        return w if w.dtype == dtype else w.to(dtype)
    return w.to(dtype) * scale.to(dtype)
