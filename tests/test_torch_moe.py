"""MoE: seldon_tpu_torch.models.transformer.moe_block and the tiny-moe
model against the JAX package.

The router is f32 and ``torch.topk`` must pick JAX's experts in JAX's
order; the block's output, the model's logits (bf16 and int8 weights)
and the load-balance aux stay within RAGGED_LOGITS_ATOL of JAX's, and
the engine's greedy streams on tiny-moe equal the JAX engine's (near-ties
reported)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import quantize as jq
from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models import quantize as tq
from seldon_tpu_torch.models import transformer as ttf
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.ops.ragged_paged_attention import RAGGED_LOGITS_ATOL
from tests.torch_port_helpers import (assert_streams_match, engine_prompts,
                                      f32, params_pair, run_jax_engine,
                                      run_torch_engine, to_torch)

MOE = PRESETS["tiny-moe"]
TMOE = TPRESETS["tiny-moe"]


def _pair(weights, seed=0):
    jp, tp = params_pair(MOE, seed=seed)
    if weights == "int8":
        jp = jq.quantize_params(jp)
        tq.quantize_params(tp)
    return jp, tp


def _x(seed, shape=(2, 6, 64)):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.standard_normal(shape), jnp.float32).astype(
        jnp.bfloat16)


def test_moe_leaves_have_the_jax_shapes():
    jp, tp = _pair("bf16")
    bp = tp.blocks[0]
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(getattr(bp, name).shape) == jp["blocks"][name].shape[1:]
    assert bp.router.dtype == torch.float32
    jqp, tqp = _pair("int8")
    assert tuple(tqp.blocks[0].w_down_scale.shape) == \
        jqp["blocks"]["w_down_scale"].shape[1:]
    assert tqp.blocks[0].router.dtype == torch.float32  # never quantized


def test_router_top_k_picks_the_jax_experts():
    jp, tp = _pair("bf16", seed=1)
    x = _x(2, (3, 40, 64))
    bp = jax.tree.map(lambda a: a[0], jp["blocks"])
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), bp["router"])
    _, want = jax.lax.top_k(logits, MOE.n_experts_per_token)
    got = torch.topk(to_torch(x).float() @ tp.blocks[0].router,
                     MOE.n_experts_per_token, dim=-1).indices
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_moe_block_matches_jax(weights):
    jp, tp = _pair(weights, seed=2)
    x = _x(3)
    bp = jax.tree.map(lambda a: a[1], jp["blocks"])
    want, want_aux = jtf.moe_block(x, bp, MOE)
    got, got_aux = ttf.moe_block(to_torch(x), tp.blocks[1], TMOE)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), rtol=2.0 ** -7,
                               atol=1e-3)
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=1e-5)


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_forward_on_tiny_moe_within_atol(weights):
    jp, tp = _pair(weights, seed=4)
    toks = jnp.asarray(np.random.default_rng(5).integers(
        2, MOE.vocab_size, (2, 10)), jnp.int32)
    want, want_aux = jtf.forward(jp, toks, MOE, return_aux=True)
    got, got_aux = ttf.forward(tp, to_torch(toks), TMOE, return_aux=True)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=0,
                               atol=RAGGED_LOGITS_ATOL)
    np.testing.assert_allclose(float(got_aux["moe_lb_loss"]),
                               float(want_aux["moe_lb_loss"]), rtol=1e-4)


def test_prefill_and_decode_on_tiny_moe_within_atol():
    jp, tp = _pair("bf16", seed=6)
    toks = jnp.asarray(np.random.default_rng(7).integers(
        2, MOE.vocab_size, (2, 8)), jnp.int32)
    lens = jnp.asarray([8, 5], jnp.int32)
    jc = jtf.init_cache(MOE, 2, 16)
    want, jc = jtf.prefill(jp, toks, lens, jc, MOE)
    tc = ttf.init_cache(TMOE, 2, 16, device="cpu")
    got, tc = ttf.prefill(tp, to_torch(toks), to_torch(lens), tc, TMOE)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=0,
                               atol=RAGGED_LOGITS_ATOL)
    nxt = jnp.argmax(want, axis=-1).astype(jnp.int32)
    want, _ = jtf.decode_step(jp, nxt, lens, jc, MOE)
    got, _ = ttf.decode_step(tp, to_torch(nxt), to_torch(lens), tc, TMOE)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=0,
                               atol=RAGGED_LOGITS_ATOL)


@pytest.mark.parametrize("kernel", ["masked", "sparse", "pallas"])
def test_engine_greedy_streams_on_tiny_moe_match_jax_engine(kernel):
    jp, tp = _pair("bf16", seed=0)
    prompts = engine_prompts(MOE)
    knobs = dict(temperature=0.0, max_new_tokens=6)
    want = run_jax_engine(jp, MOE, prompts, knobs)
    got, _ = run_torch_engine(tp, TMOE, prompts, knobs, kernel)
    assert all(len(s) == 6 for s in want)
    assert_streams_match(got, want, jp, MOE, prompts, f"moe/{kernel}")
