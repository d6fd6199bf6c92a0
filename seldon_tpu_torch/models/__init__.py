"""The port's model package; its public entry points mirror
``seldon_tpu/models/__init__.py``."""

from seldon_tpu_torch.models.config import ModelConfig, PRESETS, get_config
from seldon_tpu_torch.models.transformer import (
    init_params,
    forward,
    prefill,
    decode_step,
    init_cache,
)

__all__ = [
    "ModelConfig",
    "PRESETS",
    "get_config",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "init_cache",
]
