"""``quantize.init_params_int8`` (the layer-by-layer int8 init) against the
JAX package's ``init_params_int8``, on ``tiny`` and ``tiny-moe``, for bf16
and float32 models.

The draws are torch's (JAX's differ from its own ``init_params``' too), so
the JAX bits are not the oracle. Held instead:
 * the tree's keys, shapes and dtypes equal JAX's (``jax.eval_shape`` of
   its ``init_params_int8``; JAX's stacked ``[L, ...]`` leaves against the
   port's per-layer ones);
 * every quantized leaf's codes and scales are bit-equal to JAX's
   ``_quantize_leaf`` applied to the same f32 draw (carried as numpy), the
   MoE router is the f32 draw itself, norms are ones;
 * for a float32 model the tree equals ``quantize_params`` of
   ``init_params`` from the same seed, bit for bit (both quantize the same
   f32 draws), and it serves finite logits."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import quantize as jq
from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models import quantize as tq
from seldon_tpu_torch.models import transformer as ttf
from seldon_tpu_torch.models.config import ModelConfig as TModelConfig

SEED = 11


def _cfgs(preset, dtype):
    jcfg = dataclasses.replace(PRESETS[preset], dtype=dtype)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def _port_leaves(model):
    """(path, name) -> tensor of every parameter and buffer that is set."""
    out = {}
    for path, mod in [((), model)] + [((i,), bp) for i, bp in
                                      enumerate(model.blocks)]:
        for name, t in list(mod.named_parameters(recurse=False)) + list(
                mod.named_buffers(recurse=False)):
            if t is not None:
                out[(path, name)] = t
    return out


def _draws(tcfg):
    drawn = {}
    ttf.draw_leaves(tcfg, torch.Generator().manual_seed(SEED), "cpu",
                    lambda path, name, w: drawn.setdefault((path, name),
                                                           w.clone()),
                    round_router=False)
    return drawn


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_tree_matches_jax_shapes_and_quantized_draws(preset, dtype):
    jcfg, tcfg = _cfgs(preset, dtype)
    model = tq.init_params_int8(tcfg, torch.Generator().manual_seed(SEED),
                                "cpu")
    got = _port_leaves(model)
    shapes = jax.eval_shape(lambda k: jq.init_params_int8(jcfg, k),
                            jax.random.key(0))
    want = {}
    for name, s in shapes["blocks"].items():
        for i in range(jcfg.n_layers):
            want[((i,), name)] = (tuple(s.shape[1:]), np.dtype(s.dtype))
    for name, s in shapes.items():
        if name != "blocks":
            want[((), name)] = (tuple(s.shape), np.dtype(s.dtype))
    have = {k: (tuple(t.shape), np.dtype(str(t.dtype)[6:]))
            for k, t in got.items()}
    assert have == want
    assert tq.is_quantized(model)
    drawn = _draws(tcfg)
    for (path, name), t in got.items():
        if name.endswith("_scale"):
            continue
        draw = drawn[(path, name)].numpy()
        if t.dtype == torch.int8:
            codes, scale = jq._quantize_leaf(jnp.asarray(draw))
            np.testing.assert_array_equal(t.numpy(), np.asarray(codes),
                                          err_msg=f"{path}{name}")
            np.testing.assert_array_equal(
                got[(path, f"{name}_scale")].numpy().view(np.uint32),
                np.asarray(scale).view(np.uint32), err_msg=f"{path}{name}")
        else:  # norms at one, the router its unrounded f32 draw
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), draw)


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_f32_tree_equals_quantize_params_of_init_params(preset):
    _, tcfg = _cfgs(preset, "float32")
    model = tq.init_params_int8(tcfg, torch.Generator().manual_seed(SEED),
                                "cpu")
    ref = tq.quantize_params(ttf.init_params(
        tcfg, torch.Generator().manual_seed(SEED), "cpu"))
    got, want = _port_leaves(model), _port_leaves(ref)
    assert sorted(got) == sorted(want)
    for key, t in want.items():
        assert got[key].dtype == t.dtype, key
        assert got[key].stride() == t.stride(), key  # int8 column-major
        assert torch.equal(got[key], t), key
    logits = ttf.forward(model, torch.arange(3, 19)[None], tcfg)
    assert logits.dtype == torch.float32 and torch.isfinite(logits).all()
