"""float32 models (ModelConfig.dtype = "float32") in the port against the
JAX package in f32, on ``tiny`` / ``tiny-moe`` with JAX's weights carried
across bit for bit (``convert.params_from_numpy``).

Tolerances (both sides compute in f32 on the CPU, with sums in other
orders):
 * logits: 1e-4 absolute (``F32_LOGITS_ATOL``);
 * B1's plain version against JAX's Pallas kernel in interpret mode, and
   B2's through ``forward(attn_impl="flash")`` against JAX's interpreted
   Pallas kernel: 1e-5 on the normalised output (m 1e-5, l 1e-5
   relative);
 * int8 cache codes: equal wherever the f32 k/v they quantize are
   bit-equal, else one code apart;
 * greedy streams equal, except where JAX's top-2 logit gap is below
   F32_LOGITS_ATOL (reported, not failed).
float16 models raise (float32 training: tests/test_torch_f32_train.py);
the HBM ledger counts an f32 tree's bytes as the JAX ledger does."""

import dataclasses
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from seldon_tpu.models import generate as jgen
from seldon_tpu.models import quantize as jq
from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu.ops import ragged_paged_attention as jrpa
from seldon_tpu_torch.models import generate as tgen
from seldon_tpu_torch.models import prng
from seldon_tpu_torch.models import quantize as tq
from seldon_tpu_torch.models import transformer as ttf
from seldon_tpu_torch.models.config import ModelConfig as TModelConfig
from seldon_tpu_torch.ops import flash_attention as tfa
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from tests.torch_port_helpers import f32, params_pair, to_torch

jfa = importlib.import_module("seldon_tpu.ops.flash_attention")

F32_LOGITS_ATOL = 1e-4
PARTIALS_TOL = 1e-5
WEIGHTS = {"f32": {}, "int8": dict(weight_dtype="int8"),
           "w8a8": dict(weight_dtype="int8", act_dtype="int8")}


def _cfgs(preset="tiny", **kw):
    """(JAX config, the port's config), float32, with the same fields."""
    jcfg = dataclasses.replace(PRESETS[preset], dtype="float32", **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def _pair(jcfg, seed, weights="f32"):
    """JAX's f32 params and the port's, quantized on both sides when the
    config's weights are int8."""
    jp, tp = params_pair(jcfg, seed=seed)
    if jcfg.weight_dtype == "int8":
        jp = jq.quantize_params(jp)
        tq.quantize_params(tp)
    return jp, tp


def _tokens(rng, B, S, vocab):
    return jnp.asarray(rng.integers(2, vocab, (B, S)), jnp.int32)


def _interpreted(fn, *args, **kw):
    """``fn`` with every ``pallas_call`` in interpret mode, as
    tests/test_ops.py runs the JAX package's kernels off the TPU."""
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp):
        return fn(*args, **kw)


def test_f32_model_leaves_and_convert_are_bit_equal():
    """The port's f32 model holds every leaf in f32 (norms and the MoE
    router too), and JAX's f32 tree crosses bit for bit."""
    jcfg, tcfg = _cfgs("tiny-moe")
    jp, tp = params_pair(jcfg, seed=1)
    tree = jax.tree.map(np.asarray, jp)
    for name, arr in tree["blocks"].items():
        assert arr.dtype == np.float32, name
        for i, bp in enumerate(tp.blocks):
            got = getattr(bp, name)
            assert got.dtype == torch.float32, name
            np.testing.assert_array_equal(got.numpy(), arr[i])
    np.testing.assert_array_equal(tp.embed.numpy(), tree["embed"])
    # The seeded init in f32: the draws are the f32 draws themselves.
    g = torch.Generator().manual_seed(3)
    model = ttf.init_params(tcfg, g, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    drawn = {}
    ttf.draw_leaves(tcfg, torch.Generator().manual_seed(3), "cpu",
                    lambda path, name, w: drawn.setdefault(
                        (path, name), w.clone()))
    assert torch.equal(model.blocks[1].router, drawn[((1,), "router")])
    assert torch.equal(model.embed, drawn[((), "embed")])


@pytest.mark.parametrize("weights", list(WEIGHTS))
@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_forward_matches_jax(preset, attn_impl, weights):
    """Teacher-forced logits; under "flash" JAX's B2 is its Pallas kernel
    in interpret mode and the port's its plain version (no launch on the
    CPU)."""
    jcfg, tcfg = _cfgs(preset, attn_impl=attn_impl, **WEIGHTS[weights])
    jp, tp = _pair(jcfg, seed=3)
    toks = _tokens(np.random.default_rng(0), 2, 40, jcfg.vocab_size)
    with mock.patch.object(jfa, "_on_tpu", lambda: True):
        want = _interpreted(jtf.forward, jp, toks, jcfg)
    launches = dict(tfa.entry_launches)
    got = ttf.forward(tp, to_torch(toks), tcfg)
    assert tfa.entry_launches == launches
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(f32(got), f32(want), rtol=0,
                               atol=F32_LOGITS_ATOL)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_step_match_jax(kv_dtype, attn_impl):
    """The dense cache in the compute dtype (f32) or int8 with bf16
    scales; prefill then one decode step."""
    jcfg, tcfg = _cfgs(attn_impl=attn_impl, kv_cache_dtype=kv_dtype)
    jp, tp = params_pair(jcfg, seed=5)
    rng = np.random.default_rng(2)
    T, S = 24, 12
    toks = _tokens(rng, 3, S, jcfg.vocab_size)
    plens = jnp.asarray([12, 7, 3], jnp.int32)
    want_l, want_c = jtf.prefill(jp, toks, plens, jtf.init_cache(jcfg, 3, T),
                                 jcfg)
    cache = ttf.init_cache(tcfg, 3, T, device="cpu")
    if kv_dtype == "bf16":
        assert cache["k"].dtype == torch.float32
    got_l, got_c = ttf.prefill(tp, to_torch(toks), to_torch(plens), cache,
                               tcfg)
    np.testing.assert_allclose(f32(got_l), f32(want_l), rtol=0,
                               atol=F32_LOGITS_ATOL)
    token = jnp.asarray([5, 9, 200], jnp.int32)
    want_l, want_c = jtf.decode_step(jp, token, plens, want_c, jcfg)
    got_l, got_c = ttf.decode_step(tp, to_torch(token), to_torch(plens),
                                   got_c, tcfg)
    np.testing.assert_allclose(f32(got_l), f32(want_l), rtol=0,
                               atol=F32_LOGITS_ATOL)
    for key in want_c:
        g, w = f32(got_c[key]), f32(want_c[key])
        if kv_dtype == "int8" and key in ("k", "v"):
            assert np.abs(g - w).max() <= 1 and np.mean(g == w) > 0.99
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)


def test_greedy_generate_matches_jax():
    """The whole-batch path (cold prefill + dense decode steps) in f32
    under "flash"."""
    jcfg, tcfg = _cfgs(attn_impl="flash")
    jp, tp = params_pair(jcfg, seed=7)
    rng = np.random.default_rng(3)
    B, S, T = 3, 16, 10
    toks = np.array(_tokens(rng, B, S, jcfg.vocab_size))
    plens = np.asarray([16, 11, 5], np.int32)
    for b in range(B):
        toks[b, plens[b]:] = jcfg.pad_token_id
    knobs = (jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.int32),
             jnp.ones(B, jnp.float32))
    want, _ = jgen.generate(jp, jnp.asarray(toks), jnp.asarray(plens),
                            jax.random.key(0), *knobs, jcfg, T)
    got, _ = tgen.generate(tp, torch.from_numpy(toks),
                           torch.from_numpy(plens), prng.key(torch.tensor(0)),
                           *(to_torch(k) for k in knobs), tcfg, T)
    want = np.asarray(want)
    for b in range(B):
        g, w = got[b].tolist(), want[b].tolist()
        k = next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
        if k is None:
            continue
        ctx = np.concatenate([toks[b, :plens[b]], want[b, :k]])
        row = np.asarray(jtf.forward(jp, jnp.asarray(ctx[None]), jcfg))[0, -1]
        gap = float(np.diff(np.sort(row)[-2:])[0])
        print(f"near-tie reported: row {b} token {k} top-2 gap {gap}")
        assert gap < F32_LOGITS_ATOL, (b, k, gap)


# -- B1 in f32 ----------------------------------------------------------------

BLOCK, NBS, B = 8, 6, 4
BOUNDS = np.array([0, 5, BLOCK, 37], np.int32)


def _f32_layer(kv_dtype, seed):
    """One pool layer of an f32 model: f32 K/V, or int8 codes with bf16
    scales quantized from f32 K/V; table tails at the trash block 0."""
    rng = np.random.default_rng(seed)
    hkv, dh = PRESETS["tiny"].n_kv_heads, PRESETS["tiny"].head_dim
    nb = B * NBS + 1
    raw_k = jnp.asarray(rng.standard_normal((nb, hkv, BLOCK, dh)),
                        jnp.float32)
    raw_v = jnp.asarray(rng.standard_normal((nb, hkv, BLOCK, dh)),
                        jnp.float32)
    if kv_dtype == "int8":
        kq, ks = jtf._quantize_kv(raw_k)
        vq, vs = jtf._quantize_kv(raw_v)
        layer = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        layer = {"k": raw_k, "v": raw_v}
    table = np.zeros((B, NBS), np.int32)
    for i, bnd in enumerate(BOUNDS):
        live = -(-int(bnd) // BLOCK)
        table[i, :live] = 1 + i * NBS + np.arange(live)
    return layer, jnp.asarray(table), rng


def _assert_partials(got, want):
    gm, gl, ga = (f32(x) for x in got)
    wm, wl, wa = (np.asarray(x, np.float32) for x in want)
    assert gm.shape == wm.shape and ga.shape == wa.shape
    np.testing.assert_allclose(gm, wm, rtol=0, atol=PARTIALS_TOL)
    np.testing.assert_allclose(gl, wl, rtol=PARTIALS_TOL, atol=0)
    np.testing.assert_allclose(ga / np.maximum(gl, 1e-30),
                               wa / np.maximum(wl, 1e-30), rtol=0,
                               atol=PARTIALS_TOL)


@pytest.mark.parametrize("sq", [1, 5])
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_b1_plain_version_matches_jax_pallas_interpret(kv_dtype, sq):
    """f32 queries against an f32 pool and against an int8 pool with bf16
    scales: the port's kernel wrapper (its plain version for CPU tensors,
    no launch) and ``partials_sparse`` against JAX's Pallas kernel in
    interpret mode; a bound = 0 row comes out exactly (NEG_INF, 0, 0)."""
    layer, table, rng = _f32_layer(kv_dtype, seed=11)
    g = PRESETS["tiny"].n_heads // PRESETS["tiny"].n_kv_heads
    q = jnp.asarray(rng.standard_normal(
        (B, sq, PRESETS["tiny"].n_kv_heads, g, PRESETS["tiny"].head_dim)),
        jnp.float32)
    bound = jnp.minimum(jnp.asarray(BOUNDS)[:, None] + jnp.arange(sq)[None],
                        NBS * BLOCK).astype(jnp.int32)
    bound = bound.at[0].set(0)
    want = jrpa.partials_pallas(q, layer, table, bound, interpret=True)
    args = (to_torch(q), {k: to_torch(v) for k, v in layer.items()},
            to_torch(table), to_torch(bound))
    before = dict(rpa.entry_launches)
    got = rpa.ragged_paged_partials(*args, mode="pallas")
    assert rpa.entry_launches == before
    assert all(t.dtype == torch.float32 for t in got)
    _assert_partials(got, want)
    _assert_partials(rpa.partials_sparse(*args), want)
    m, l, acc = got
    assert torch.all(m[0] == rpa.NEG_INF) and torch.all(l[0] == 0)
    assert torch.all(acc[0] == 0)


def test_b1_wrapper_routes_f32_and_refuses_what_it_cannot_take(monkeypatch):
    """For a CUDA tensor the wrapper picks the route of q's dtype or
    raises before any build: f32 q takes an f32 pool or int8 codes with
    bf16 scales, never a bf16 pool; float16 q has no route."""
    layer, table, rng = _f32_layer("f32", seed=4)
    q = torch.randn(B, 1, 2, 2, 16)

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    monkeypatch.setattr(rpa, "_kernel_lib", lambda *a: pytest.fail("built"))
    tl = {k: to_torch(v) for k, v in layer.items()}
    tt, tb = to_torch(table), torch.tensor(BOUNDS)[:, None].int()
    with pytest.raises(TypeError, match="dtype"):
        rpa.partials_kernel(q.half().as_subclass(FakeCuda), tl, tt, tb)
    bf16_pool = {k: v.bfloat16() for k, v in tl.items()}
    with pytest.raises(TypeError, match="dtype"):
        rpa.partials_kernel(q.as_subclass(FakeCuda), bf16_pool, tt, tb)
    with pytest.raises(ValueError, match="Dh"):
        rpa.partials_kernel(torch.randn(B, 1, 2, 2, 32).as_subclass(
            FakeCuda), {k: torch.zeros(NBS * B + 1, 2, BLOCK, 32)
                        for k in ("k", "v")}, tt, tb)
    assert set(rpa.SOURCES) == {torch.bfloat16, torch.float32}


# -- what f32 does not reach ---------------------------------------------------


def test_float16_raises():
    with pytest.raises(NotImplementedError, match="bfloat16 and float32"):
        ttf.check_supported(TModelConfig(**dataclasses.asdict(
            dataclasses.replace(PRESETS["tiny"], dtype="float16"))))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_hbm_ledger_counts_f32_bytes_as_jax(kv_dtype, monkeypatch):
    """The HBM ledger of an f32 engine (its weights and its KV pool in
    f32, or int8 with bf16 scales) holds the JAX engine's bytes for the
    same f32 model, and an f32 model's weights are twice a bf16 one's."""
    from seldon_tpu.servers import engine as jeng
    from seldon_tpu_torch.servers import engine as teng
    from tests.torch_port_helpers import ENGINE_ECFG

    monkeypatch.setenv("HBM_LEDGER", "1")
    jcfg, tcfg = _cfgs(kv_cache_dtype=kv_dtype)
    jp, tp = params_pair(jcfg, seed=0)
    want = jeng.InferenceEngine(jp, jcfg, jeng.EngineConfig(
        **ENGINE_ECFG)).debug_hbm()["categories"]
    got = teng.InferenceEngine(tp, tcfg, teng.EngineConfig(**ENGINE_ECFG),
                               device="cpu").debug_hbm()["categories"]
    for cat in ("weights", "kv_cache"):
        assert got[cat]["bytes"] == want[cat]["bytes"] > 0, cat
    _, bf = params_pair(PRESETS["tiny"], seed=0)
    assert got["weights"]["bytes"] == 2 * sum(
        t.numel() * t.element_size() for t in bf.parameters()
        if t.dtype == torch.bfloat16) + sum(
        t.numel() * t.element_size() for t in bf.parameters()
        if t.dtype == torch.float32)
