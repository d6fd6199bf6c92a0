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

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from seldon_tpu_torch.device import DeviceLike, resolve_device

# Block leaves quantized per output channel. Norm gains and the MoE router
# stay full precision.
_BLOCK_WEIGHTS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def true_div(t: torch.Tensor, c: float) -> torch.Tensor:
    """``t / c`` as one IEEE division on every device. On CUDA, PyTorch
    divides by a Python number as a product with its reciprocal, which
    can land one ulp away from the quotient that ``jnp``, and PyTorch on
    the CPU, compute; a divisor tensor keeps the division."""
    return t / torch.full_like(t, c)


def _quantize_leaf(w: torch.Tensor, consume: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (int8 w_q, f32 scale broadcastable against w): the scale is
    ``max(|w|) / 127`` over axis -2, floored at 1e-12; codes are
    ``clip(round(w / scale), -127, 127)`` with ``torch.round``'s
    half-to-even, as ``jnp.round``. ``max(|w|)`` is taken as ``max(max w,
    -min w)`` (the same number, without an |w| copy) and the f32 work
    tensor is updated in place (an 8B model's ``lm_head`` is 2 GB in
    f32): a copy of ``w``, or, under ``consume``, an f32 ``w`` itself,
    which the caller then drops."""
    wf = w.float()
    peak = torch.maximum(wf.amax(dim=-2, keepdim=True),
                         wf.amin(dim=-2, keepdim=True).neg_())
    scale = torch.clamp(true_div(peak, 127.0), min=1e-12)
    if wf.data_ptr() == w.data_ptr() and not consume:
        wf = wf.clone()
    w_q = wf.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return w_q, scale


def is_quantized(params: nn.Module) -> bool:
    return getattr(params, "embed_scale", None) is not None


def _stored(name: str, w_q: torch.Tensor) -> torch.Tensor:
    """The int8 codes of leaf ``name`` as the port stores them: a 2-D
    block projection column-major (see :func:`set_quantized`), anything
    else as it is."""
    if name in _BLOCK_WEIGHTS and w_q.dim() == 2:
        return w_q.t().contiguous().t()
    return w_q


def set_quantized(module: nn.Module, name: str, w_q: torch.Tensor,
                  scale: torch.Tensor) -> None:
    """Replace ``module.name`` (a parameter or a buffer) by the int8
    buffer ``w_q`` and set the buffer ``name_scale``.

    A 2-D projection weight is stored column-major: the same logical
    ``[in, out]`` tensor with strides ``(1, in)``. cuBLASLt's int8 GEMM
    behind ``torch._int_mm`` runs its tensor-core kernel for a
    column-major second operand and a much slower compatibility kernel
    for a row-major one (chip_smoke.py times both layouts; PERF.md)."""
    w_q = _stored(name, w_q)
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


@torch.no_grad()
def init_params_int8(cfg, generator: torch.Generator,
                     device: DeviceLike = None) -> nn.Module:
    """A random ALREADY-int8 model (port of ``seldon_tpu/models/
    quantize.py:init_params_int8``) without the model ever held in its
    compute dtype: ``transformer.draw_leaves`` draws each leaf in f32 on
    ``device`` (``generator`` must live there) and each matmul weight's
    draw is quantized in place into its int8 codes and f32 scale
    (:func:`_quantize_leaf`, the scheme of :func:`quantize_params`), then
    dropped. Peak device memory is the int8 tree plus the largest single
    f32 draw (llama3-8b: its 2.1 GB embedding). As in JAX, the f32 draw
    itself is quantized, not a rounding of it to the compute dtype, and
    the MoE router stays an unrounded f32 draw. The draws are torch's:
    they differ from ``jax.random``'s for the same seed, as JAX's own
    differ from its ``init_params``'."""
    from seldon_tpu_torch.models import tp_sharding, transformer

    cfg = transformer.check_supported(cfg)
    device = resolve_device(device)
    quantized = _BLOCK_WEIGHTS + ("embed", "lm_head")
    held: Dict[tuple, torch.Tensor] = {}

    def keep(path, name, w):
        if name in quantized:
            w_q, scale = _quantize_leaf(w, consume=True)
            held[(path, name)] = _stored(name, w_q)
            held[(path, f"{name}_scale")] = scale
        else:  # norms (one tensor for both of a layer's) and the router
            held[(path, name)] = w.clone()

    transformer.draw_leaves(cfg, generator, device, keep, round_router=False)
    return tp_sharding.build_shard(
        cfg, lambda path, name, spec: held.pop((path, name), None))


def dequant(w: torch.Tensor, scale: Optional[torch.Tensor],
            dtype: torch.dtype) -> torch.Tensor:
    """Dequantize at use: ``w.to(dtype) * scale.to(dtype)``, one product
    rounded to ``dtype`` (the compute dtype: bf16, or f32, where the
    product of an int8 code and an f32 scale is exact) as in JAX."""
    if scale is None:
        return w if w.dtype == dtype else w.to(dtype)
    return w.to(dtype) * scale.to(dtype)
