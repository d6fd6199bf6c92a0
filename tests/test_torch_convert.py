"""seldon_tpu_torch.models.convert carries the JAX params pytree into the
port bit for bit: bf16 crosses as its 16-bit pattern, f32 norms as
they are, the stacked [L, ...] blocks sliced per layer."""

import jax
import numpy as np
import pytest
import torch

from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models import convert
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from tests.torch_port_helpers import bits

TINY = PRESETS["tiny"]
BLOCK_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
              "w_gate", "w_up", "w_down")


def _tree(seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(TINY,
                                                    jax.random.key(seed)))


@pytest.mark.parametrize("as_uint16", [False, True])
def test_round_trip_bits_equal(as_uint16):
    tree = _tree()
    if as_uint16:  # callers may hand over the bit view themselves
        tree = jax.tree.map(
            lambda a: a.view(np.uint16) if a.dtype.name == "bfloat16" else a,
            tree)
    model = convert.params_from_numpy(tree, TPRESETS["tiny"], device="cpu")
    for key in BLOCK_KEYS:
        stacked = torch.stack([getattr(b, key) for b in model.blocks])
        want = tree["blocks"][key]
        if stacked.dtype == torch.bfloat16:
            np.testing.assert_array_equal(bits(stacked).view(np.uint16),
                                          want.view(np.uint16))
        else:
            np.testing.assert_array_equal(stacked.numpy(), want)
    for key in ("embed", "lm_head"):
        np.testing.assert_array_equal(
            bits(getattr(model, key)).view(np.uint16),
            tree[key].view(np.uint16))
    np.testing.assert_array_equal(model.final_norm.numpy(),
                                  tree["final_norm"])


def test_rejects_mismatched_trees():
    tree = _tree()
    bad = dict(tree, embed=tree["embed"][:, :8])
    with pytest.raises(ValueError, match="shape"):
        convert.params_from_numpy(bad, TPRESETS["tiny"], device="cpu")
    bad = dict(tree, final_norm=tree["final_norm"].astype(np.float64))
    with pytest.raises(TypeError):
        convert.params_from_numpy(bad, TPRESETS["tiny"], device="cpu")
