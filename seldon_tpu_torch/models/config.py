"""Model configuration for the transformer family.

Field-for-field copy of ``seldon_tpu/models/config.py`` (the port never
imports the JAX package; tests/test_torch_config.py fails if the two
drift apart). Presets: `tiny` (CPU tests), `bench-1b`, `llama3-8b` (the
serving target of the port's chip smoke), `llama3-70b`. MoE, int8
weights and W8A8 run (``models/quantize.py``, ``transformer.moe_block``);
``transformer.check_supported`` rejects only a compute dtype other than
bfloat16 or float32. Ring attention needs a mesh, which the port does
not have: ``"ring"`` runs the ``"xla"`` attention, as the JAX package
does without a mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 128256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14336
    max_seq_len: int = 8192
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # MoE (0 experts = dense). Not carried by this slice of the port.
    n_experts: int = 0
    n_experts_per_token: int = 2
    eos_token_id: int = 128001
    pad_token_id: int = 0
    # "xla" = einsum attention (default); "flash" = the blockwise kernel
    # on the full-sequence path; "ring" = sequence-parallel attention.
    # The ragged wave reads none of them; forward and prefill do.
    attn_impl: str = "xla"
    # "bf16" (compute dtype) or "int8": per-(token, head) symmetric
    # quantization of KV slots with bf16 scales.
    kv_cache_dtype: str = "bf16"
    # "bf16" or "int8": weight-only quantization (per-output-channel
    # scales). int8 is not carried by this slice of the port.
    weight_dtype: str = "bf16"
    # "bf16" or "int8": matmul activation dtype (W8A8, only with int8
    # weights). int8 is not carried by this slice of the port.
    act_dtype: str = "bf16"
    # RoPE frequency scaling (long-context checkpoints). Flat scalar
    # fields rather than a dict so the frozen config stays hashable.
    # rope_scaling_type: None (no scaling), "linear" (inv_freq / factor),
    # or "llama3" (HF _compute_llama3_parameters: wavelengths past the
    # original context window are divided by `factor`, with a smooth
    # ramp between the low/high frequency knees). Llama-3.1/3.2
    # checkpoints declare rope_type=llama3 — ignoring it would produce
    # subtly wrong logits at every position.
    rope_scaling_type: Optional[str] = None
    rope_scaling_factor: float = 1.0
    rope_scaling_low_freq_factor: float = 1.0
    rope_scaling_high_freq_factor: float = 4.0
    rope_scaling_original_max_position: int = 8192

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    def validate(self) -> "ModelConfig":
        assert self.d_model % self.n_heads == 0, "d_model must divide by n_heads"
        assert self.n_heads % self.n_kv_heads == 0, "n_heads must divide by n_kv_heads"
        assert self.attn_impl in ("xla", "flash", "ring"), (
            f"unknown attn_impl {self.attn_impl!r}"
        )
        assert self.kv_cache_dtype in ("bf16", "int8"), (
            f"unknown kv_cache_dtype {self.kv_cache_dtype!r}"
        )
        assert self.weight_dtype in ("bf16", "int8"), (
            f"unknown weight_dtype {self.weight_dtype!r}"
        )
        assert self.act_dtype in ("bf16", "int8"), (
            f"unknown act_dtype {self.act_dtype!r}"
        )
        assert self.rope_scaling_type in (None, "linear", "llama3"), (
            f"unknown rope_scaling_type {self.rope_scaling_type!r}"
        )
        if self.n_experts:
            assert self.n_experts_per_token <= self.n_experts
        return self


PRESETS = {
    # CPU-testable config: every dim divides an 8-way mesh.
    "tiny": ModelConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        max_seq_len=128,
        rope_theta=10000.0,
        eos_token_id=1,
    ),
    "tiny-moe": ModelConfig(
        vocab_size=256,
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        max_seq_len=128,
        rope_theta=10000.0,
        eos_token_id=1,
        n_experts=4,
        n_experts_per_token=2,
    ),
    # ~1.1B params.
    "bench-1b": ModelConfig(
        vocab_size=32000,
        d_model=2048,
        n_layers=16,
        n_heads=16,
        n_kv_heads=8,
        d_ff=5632,
        max_seq_len=2048,
        rope_theta=10000.0,
        eos_token_id=2,
    ),
    # Llama-3-8B geometry: the port's serving target.
    "llama3-8b": ModelConfig(),
    "llama3-70b": ModelConfig(
        d_model=8192,
        n_layers=80,
        n_heads=64,
        n_kv_heads=8,
        d_ff=28672,
    ),
}


def get_config(name_or_cfg, **overrides) -> ModelConfig:
    if isinstance(name_or_cfg, ModelConfig):
        cfg = name_or_cfg
    else:
        cfg = PRESETS[name_or_cfg]
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg.validate()
