"""int8 weights and W8A8: seldon_tpu_torch.models.quantize and the W8A8
branch of models.transformer against the JAX package.

Integer outputs are bit-equal: weight codes and scales
(``_quantize_leaf``, ``quantize_params``, a converted JAX tree), the bf16
``dequant`` product, activation codes and scales (``_quantize_act``), the
s8 x s8 -> s32 products of ``_qdot`` and its bf16 outputs. Logits of int8
and W8A8 models stay within RAGGED_LOGITS_ATOL of JAX's, and the
engine's greedy streams equal the JAX engine's (near-ties reported)."""

import dataclasses

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
from seldon_tpu_torch.models.convert import params_from_numpy
from seldon_tpu_torch.ops.ragged_paged_attention import RAGGED_LOGITS_ATOL
from seldon_tpu_torch.servers.torchserver import TorchServer
from tests.torch_port_helpers import (assert_streams_match, bits,
                                      engine_prompts, f32, params_pair,
                                      run_jax_engine, run_torch_engine,
                                      to_torch)

TINY = PRESETS["tiny"]
W8 = dataclasses.replace(TINY, weight_dtype="int8")
W8A8 = dataclasses.replace(TINY, weight_dtype="int8", act_dtype="int8")
LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _weight(rng, shape, zero_col=True):
    w = rng.standard_normal(shape) * 0.02
    if zero_col:
        w[..., 3] = 0.0  # an all-zero channel: the scale's 1e-12 floor
    return jnp.asarray(w, jnp.float32).astype(jnp.bfloat16)


@pytest.mark.parametrize("shape", [(64, 96), (4, 64, 128)])
def test_quantize_leaf_matches_jax(shape):
    w = _weight(np.random.default_rng(0), shape)
    want_q, want_s = jq._quantize_leaf(w)
    got_q, got_s = tq._quantize_leaf(to_torch(w))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert tuple(got_s.shape) == want_s.shape
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))


def test_quantize_params_matches_jax_and_is_idempotent():
    jp, tp = params_pair(TINY, seed=1)
    want = jq.quantize_params(jp)
    assert not tq.is_quantized(tp)
    got = tq.quantize_params(tp)
    assert got is tp and tq.is_quantized(tp)
    for layer, bp in enumerate(tp.blocks):
        for name in LEAVES:
            np.testing.assert_array_equal(
                getattr(bp, name).numpy(),
                np.asarray(want["blocks"][name][layer]))
            np.testing.assert_array_equal(
                getattr(bp, f"{name}_scale").numpy(),
                np.asarray(want["blocks"][f"{name}_scale"][layer]))
    for name in ("embed", "lm_head"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(want[name]))
        np.testing.assert_array_equal(getattr(tp, f"{name}_scale").numpy(),
                                      np.asarray(want[f"{name}_scale"]))
    # Int8 weights are buffers, not parameters; norms stay parameters.
    names = {n for n, _ in tp.named_parameters()}
    assert "blocks.0.wq" not in names and "blocks.0.attn_norm" in names
    snapshot = tp.blocks[0].wq_scale.clone()
    assert tq.quantize_params(tp) is tp
    assert torch.equal(tp.blocks[0].wq_scale, snapshot)
    assert jq.quantize_params(want) is want  # the twin's idempotence


def test_dequant_matches_jax_bit_for_bit():
    w = _weight(np.random.default_rng(2), (64, 96))
    wq, sc = jq._quantize_leaf(w)
    want = jq.dequant(wq, sc, jnp.bfloat16)
    got = tq.dequant(to_torch(wq), to_torch(sc), torch.bfloat16)
    np.testing.assert_array_equal(bits(got), bits(want))
    assert tq.dequant(to_torch(w), None, torch.bfloat16).dtype == \
        torch.bfloat16


def test_convert_carries_a_quantized_tree_bit_for_bit():
    jp, _ = params_pair(TINY, seed=3)
    tree = jax.tree.map(np.asarray, jq.quantize_params(jp))
    model = params_from_numpy(tree, W8, device="cpu")
    assert tq.is_quantized(model)
    for layer, bp in enumerate(model.blocks):
        for name in LEAVES:
            np.testing.assert_array_equal(getattr(bp, name).numpy(),
                                          tree["blocks"][name][layer])
            np.testing.assert_array_equal(
                getattr(bp, f"{name}_scale").numpy(),
                tree["blocks"][f"{name}_scale"][layer])
    np.testing.assert_array_equal(model.embed_scale.numpy(),
                                  tree["embed_scale"])


def test_quantize_act_matches_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 64)) * rng.uniform(0.01, 5, (3, 7, 1))
    x[1, 2] = 0.0  # an all-zero row: the scale's 1e-8 floor
    x = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    want_q, want_s = jtf._quantize_act(x)
    got_q, got_s = ttf._quantize_act(to_torch(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(want_s).view(np.int32))


@pytest.mark.parametrize("name", ["wq", "wk", "w_gate", "w_down"])
def test_qdot_w8a8_products_and_outputs_match_jax(name):
    jp, tp = params_pair(TINY, seed=5)
    jqp = jq.quantize_params(jp)
    tq.quantize_params(tp)
    jbp = jax.tree.map(lambda a: a[1], jqp["blocks"])
    tbp = tp.blocks[1]
    width = TINY.d_ff if name == "w_down" else TINY.d_model
    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.standard_normal((2, 5, width)),
                    jnp.float32).astype(jnp.bfloat16)
    # The s32 product, bit for bit.
    xq, xs = jtf._quantize_act(x)
    want_y = jax.lax.dot_general(
        xq, jbp[name], (((2,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    got_y = ttf._int_mm(to_torch(xq).reshape(10, width), getattr(tbp, name))
    assert got_y.dtype == torch.int32
    np.testing.assert_array_equal(got_y.reshape(2, 5, -1).numpy(),
                                  np.asarray(want_y))
    # The bf16 output of the whole W8A8 branch, bit for bit.
    before = ttf.int_mm_launches
    want = jtf._qdot(x, jbp, name, W8A8)
    got = ttf._qdot(to_torch(x), tbp, name, W8A8)
    assert ttf.int_mm_launches == before + 1
    np.testing.assert_array_equal(bits(got), bits(want))
    # Weight-only int8: the dequantized bf16 product, within bf16 rounding.
    want = jtf._qdot(x, jbp, name, W8)
    got = ttf._qdot(to_torch(x), tbp, name, W8)
    assert ttf.int_mm_launches == before + 1
    np.testing.assert_allclose(f32(got), f32(want), rtol=2.0 ** -7,
                               atol=1e-3)


@pytest.mark.parametrize("rows", [1, 16, 17, 40])
def test_int_mm_pads_short_row_counts_exactly(rows):
    rng = np.random.default_rng(rows)
    xq = rng.integers(-127, 128, (rows, 24)).astype(np.int8)
    w = rng.integers(-127, 128, (24, 16)).astype(np.int8)
    got = ttf._int_mm(torch.from_numpy(xq), torch.from_numpy(w))
    assert tuple(got.shape) == (rows, 16)
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  xq.astype(np.int64) @ w.astype(np.int64))


@pytest.mark.parametrize("cfg", [W8, W8A8], ids=["int8", "w8a8"])
def test_forward_with_int8_weights_within_atol(cfg):
    jp, tp = params_pair(TINY, seed=7)
    jqp = jq.quantize_params(jp)
    tq.quantize_params(tp)
    toks = jnp.asarray(np.random.default_rng(8).integers(
        2, TINY.vocab_size, (2, 12)), jnp.int32)
    want = jtf.forward(jqp, toks, cfg)
    got = ttf.forward(tp, to_torch(toks), cfg)
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=0,
                               atol=RAGGED_LOGITS_ATOL)


@pytest.mark.parametrize("cfg", [W8, W8A8], ids=["int8", "w8a8"])
@pytest.mark.parametrize("kernel", ["masked", "sparse", "pallas"])
def test_engine_greedy_streams_match_jax_engine(cfg, kernel):
    jp, tp = params_pair(TINY, seed=0)
    jqp = jq.quantize_params(jp)
    tq.quantize_params(tp)
    prompts = engine_prompts(TINY)
    knobs = dict(temperature=0.0, max_new_tokens=6)
    want = run_jax_engine(jqp, cfg, prompts, knobs)
    got, eng = run_torch_engine(tp, cfg, prompts, knobs, kernel)
    assert all(len(s) == 6 for s in want)
    assert_streams_match(got, want, jqp, cfg, prompts,
                         f"{kernel}/{cfg.act_dtype}")


def test_server_quantizes_at_load_and_serves_w8a8(monkeypatch):
    monkeypatch.setenv("WEIGHT_DTYPE", "int8")
    monkeypatch.setenv("ACT_DTYPE", "int8")
    srv = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                      prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                      device="cpu")
    assert (srv.weight_dtype, srv.act_dtype) == ("int8", "int8")
    before = ttf.int_mm_launches
    try:
        out = srv.generate({"prompt": "int8", "max_new_tokens": 3,
                            "temperature": 0.0})
    finally:
        srv.stop()
    assert srv.cfg.weight_dtype == "int8" and srv.cfg.act_dtype == "int8"
    assert srv.params.blocks[0].wq.dtype == torch.int8
    assert srv.params.lm_head.dtype == torch.int8
    assert 1 <= len(out["token_ids"]) <= 3
    assert ttf.int_mm_launches > before
    # act_dtype alone does nothing without int8 weights (as in JAX).
    srv = TorchServer(preset="tiny", act_dtype="int8", weight_dtype="bf16",
                      device="cpu")
    srv._load_model()
    assert srv.cfg.act_dtype == "bf16"
    assert srv.params.blocks[0].wq.dtype == torch.bfloat16
