"""Carry the JAX package's weights into the port.

The caller turns the JAX params pytree into numpy (``np.asarray`` on
every leaf — bf16 leaves then carry numpy's ``bfloat16`` extension
dtype) and hands the nested dict over; nothing here imports JAX or
``ml_dtypes``: bf16 crosses as its raw 16-bit pattern. A tree from the
JAX ``quantize_params`` (int8 leaves beside f32 ``*_scale`` leaves)
converts bit for bit into the port's int8 buffers and scales, and MoE
trees carry their router and ``[E, ...]`` expert weights.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.quantize import set_quantized
from seldon_tpu_torch.models.transformer import Transformer

_BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
               "w_gate", "w_up", "w_down")


def _to_torch(arr: np.ndarray, want: torch.dtype) -> torch.Tensor:
    """numpy leaf -> CPU tensor of dtype ``want``. bf16 arrays (numpy's
    ``bfloat16`` extension dtype, or their ``uint16`` bit view) are
    reinterpreted bit for bit; other dtypes must already match."""
    arr = np.array(arr)  # an owned, writable, contiguous copy
    if arr.dtype.name in ("bfloat16", "uint16"):
        if want != torch.bfloat16:
            raise TypeError(f"bf16 leaf cannot fill a {want} parameter")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(arr)
    if t.dtype != want:
        raise TypeError(f"leaf dtype {t.dtype} does not match {want}")
    return t


@torch.no_grad()
def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                      device: DeviceLike = None) -> Transformer:
    """The JAX params pytree (numpy leaves, blocks stacked on a leading
    ``[L, ...]`` axis) as the port's :class:`Transformer`, one
    :class:`Block` per layer slice, on ``device``. A leaf with a
    ``*_scale`` sibling is int8 and becomes an int8 buffer with its f32
    scale."""
    device = resolve_device(device)
    model = Transformer(cfg, device)

    def check(src: torch.Tensor, shape) -> torch.Tensor:
        if tuple(src.shape) != tuple(shape):
            raise ValueError(
                f"shape {tuple(src.shape)} does not match {tuple(shape)}"
            )
        return src

    def fill(module, key: str, container: Dict[str, Any], layer=None):
        pick = (lambda a: a) if layer is None else (lambda a: a[layer])
        p = getattr(module, key)
        scale = container.get(f"{key}_scale")
        if scale is None:
            p.copy_(check(_to_torch(pick(np.asarray(container[key])),
                                    p.dtype), p.shape))
            return
        w_q = check(_to_torch(pick(np.asarray(container[key])), torch.int8),
                    p.shape)
        sc = _to_torch(pick(np.asarray(scale)), torch.float32)
        set_quantized(module, key, w_q.to(device), sc.to(device))

    blocks = tree["blocks"]
    keys = _BLOCK_KEYS + (("router",) if cfg.n_experts else ())
    for key in keys:
        stacked = np.asarray(blocks[key])
        if stacked.shape[0] != cfg.n_layers:
            raise ValueError(
                f"blocks[{key!r}] stacks {stacked.shape[0]} layers, "
                f"config has {cfg.n_layers}"
            )
        for layer, bp in enumerate(model.blocks):
            fill(bp, key, blocks, layer)
    fill(model, "embed", tree)
    fill(model, "final_norm", tree)
    if model.lm_head is not None:
        fill(model, "lm_head", tree)
    return model
