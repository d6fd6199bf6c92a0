"""Shared helpers of the tests that hold seldon_tpu_torch against the JAX
package: the same numpy inputs, made from a seed, go through both.

Tensors cross as numpy arrays; bf16 crosses bit for bit as its 16-bit
pattern, so the port never needs ml_dtypes."""

import numpy as np
import torch

import jax

from seldon_tpu.models import transformer as jtf
from seldon_tpu_torch.models import convert


def to_torch(x) -> torch.Tensor:
    """numpy / jax array -> CPU tensor of the same dtype (bf16 kept)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def f32(x) -> np.ndarray:
    """Any array or tensor as a float32 numpy array, for comparisons."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def bits(x) -> np.ndarray:
    """The raw bit pattern of a bf16 array or tensor (exact comparisons)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def params_pair(cfg, seed: int = 0):
    """(JAX params, the same weights as the port's Transformer on CPU)."""
    jparams = jtf.init_params(cfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, convert.params_from_numpy(tree, cfg, device="cpu")
