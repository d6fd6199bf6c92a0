"""seldon_tpu_torch.models.transformer against seldon_tpu.models.transformer.

Same numpy inputs (made from a seed) through both, at the `tiny` preset.
Tolerances: integer outputs (int8 KV codes) and pure data movement
(gather / scatter through block tables) are bit-equal; bf16 activations
may differ by one bf16 rounding step where the two frameworks sum or
fuse in another order (2 ulp of bf16 = 2**-7 relative); f32 logits stay
within the reference's own RAGGED_LOGITS_ATOL."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models import transformer as ttf
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.ops.ragged_paged_attention import RAGGED_LOGITS_ATOL
from tests.torch_port_helpers import bits, f32, params_pair, to_torch

TINY = PRESETS["tiny"]
TTINY = TPRESETS["tiny"]
BF16_RTOL = 2.0 ** -7


def _rand(rng, shape, dtype=jnp.bfloat16, scale=1.0):
    return jnp.asarray(rng.standard_normal(shape) * scale).astype(dtype)


def _close_bf16(got, want, atol=1e-2):
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_RTOL,
                               atol=atol)


def test_rms_norm_matches():
    rng = np.random.default_rng(0)
    x = _rand(rng, (3, 5, 64))
    w = jnp.asarray(rng.uniform(0.5, 1.5, (64,)), jnp.float32)
    want = jtf.rms_norm(x, w, 1e-5)
    got = ttf.rms_norm(to_torch(x), to_torch(w), 1e-5)
    assert got.dtype == torch.bfloat16
    _close_bf16(got, want, atol=0)


@pytest.mark.parametrize("scaling", [None, "linear", "llama3"])
def test_rope_matches(scaling):
    kw = {}
    if scaling == "linear":
        kw = dict(rope_scaling_type="linear", rope_scaling_factor=4.0)
    elif scaling == "llama3":
        kw = dict(rope_scaling_type="llama3", rope_scaling_factor=8.0,
                  rope_scaling_low_freq_factor=1.0,
                  rope_scaling_high_freq_factor=4.0,
                  rope_scaling_original_max_position=64,
                  d_model=256, n_heads=2, n_kv_heads=2)
    jcfg = dataclasses.replace(TINY, **kw)
    tcfg = dataclasses.replace(TTINY, **kw)
    jf = np.asarray(jtf.rope_frequencies(jcfg))
    tf = ttf.rope_frequencies(tcfg, "cpu").numpy()
    np.testing.assert_allclose(tf, jf, rtol=2e-7, atol=0)
    rng = np.random.default_rng(1)
    x = _rand(rng, (2, 7, 4, jcfg.head_dim))
    pos = jnp.asarray(rng.integers(0, 4000, (2, 7)), jnp.int32)
    want = jtf.apply_rope(x, pos, jnp.asarray(jf))
    got = ttf.apply_rope(to_torch(x), to_torch(pos), torch.from_numpy(tf))
    _close_bf16(got, want)


def test_rope_frequencies_has_no_default_device(monkeypatch):
    """Without a device it resolves like the entry points: the card, or
    an error naming device='cpu' when there is none; never the CPU on
    its own."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttf.rope_frequencies(TTINY)
    assert ttf.rope_frequencies(TTINY, "cpu").device.type == "cpu"


def test_qkv_and_mlp_match():
    jp, tp = params_pair(TINY)
    rng = np.random.default_rng(2)
    h = _rand(rng, (2, 6, TINY.d_model))
    pos = jnp.asarray(rng.integers(0, 100, (2, 6)), jnp.int32)
    inv = jtf.rope_frequencies(TINY)
    bp = jax.tree.map(lambda a: a[1], jp["blocks"])
    want = jtf._qkv(h, bp, TINY, pos, inv)
    got = ttf._qkv(to_torch(h), tp.blocks[1], TTINY, to_torch(pos),
                   ttf.rope_frequencies(TTINY, "cpu"))
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        _close_bf16(g, w)
    x = _rand(rng, (2, 6, TINY.d_model))
    want_x, _ = jtf._mlp_res(x, bp, TINY, None)
    got_x, aux = ttf._mlp_res(to_torch(x), tp.blocks[1], TTINY)
    assert aux is None  # dense: no MoE aux
    _close_bf16(got_x, want_x)


def test_gqa_attention_matches():
    rng = np.random.default_rng(3)
    B, Sq, Skv, H, Hkv, Dh = 2, 5, 9, 4, 2, 16
    q = _rand(rng, (B, Sq, H, Dh))
    k = _rand(rng, (B, Skv, Hkv, Dh))
    v = _rand(rng, (B, Skv, Hkv, Dh))
    mask = jnp.asarray(rng.random((B, Sq, Skv)) < 0.7)
    mask = mask.at[:, :, 0].set(True)
    want = jtf.gqa_attention(q, k, v, mask)
    got = ttf.gqa_attention(to_torch(q), to_torch(k), to_torch(v),
                            to_torch(mask))
    _close_bf16(got, want)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_gqa_attention_decode_matches(kv_dtype):
    rng = np.random.default_rng(4)
    B, T, H, Hkv, Dh = 3, 12, 4, 2, 16
    q = _rand(rng, (B, 1, H, Dh))
    raw_k = _rand(rng, (B, Hkv, T, Dh))
    raw_v = _rand(rng, (B, Hkv, T, Dh))
    kw = {}
    if kv_dtype == "int8":
        ck, ks = jtf._quantize_kv(raw_k)
        cv, vs = jtf._quantize_kv(raw_v)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        ck, cv = raw_k, raw_v
    kf = _rand(rng, (B, 1, Hkv, Dh))
    vf = _rand(rng, (B, 1, Hkv, Dh))
    pos = jnp.asarray([0, 5, 12], jnp.int32)
    mask = jnp.arange(T)[None, None, :] < pos[:, None, None]
    want = jtf.gqa_attention_decode(q, ck, cv, kf, vf, mask, **kw)
    got = ttf.gqa_attention_decode(
        to_torch(q), to_torch(ck), to_torch(cv), to_torch(kf), to_torch(vf),
        to_torch(mask), **{k_: to_torch(v_) for k_, v_ in kw.items()})
    _close_bf16(got, want)


def test_quantize_kv_codes_bit_equal():
    rng = np.random.default_rng(5)
    x = _rand(rng, (4, 3, 7, 16), scale=3.0)
    wq, ws = jtf._quantize_kv(x)
    gq, gs = ttf._quantize_kv(to_torch(x))
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    np.testing.assert_array_equal(bits(gs), bits(ws))


def _pool_pair(cfg_j, cfg_t, rng, nb=9, block=8):
    """Random-filled paged pools (JAX dict, torch dict) with equal bits."""
    pool = jtf.init_paged_cache(cfg_j, nb, block)
    filled = {}
    for key, arr in pool.items():
        if arr.dtype == jnp.int8:
            filled[key] = jnp.asarray(
                rng.integers(-127, 128, arr.shape), jnp.int8)
        elif key.endswith("scale"):
            filled[key] = jnp.asarray(
                rng.uniform(0.005, 0.02, arr.shape)).astype(jnp.bfloat16)
        else:
            filled[key] = _rand(rng, arr.shape)
    tpool = ttf.init_paged_cache(cfg_t, nb, block, device="cpu")
    for key in tpool:
        assert tuple(tpool[key].shape) == filled[key].shape
        assert tpool[key].dtype == to_torch(filled[key]).dtype
        tpool[key].copy_(to_torch(filled[key]))
    return filled, tpool


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_gather_view_and_scatter_bit_equal(kv_dtype):
    cfg_j = dataclasses.replace(TINY, kv_cache_dtype=kv_dtype)
    cfg_t = dataclasses.replace(TTINY, kv_cache_dtype=kv_dtype)
    rng = np.random.default_rng(6)
    jpool, tpool = _pool_pair(cfg_j, cfg_t, rng)
    table = jnp.asarray([[3, 1, 0, 0], [2, 5, 7, 0]], jnp.int32)
    tt = to_torch(table)
    layer0 = {k: v[0] for k, v in jpool.items()}
    want = jtf.paged_gather_kv(layer0, table)
    got = ttf.paged_gather_kv({k: v[0] for k, v in tpool.items()}, tt)
    for key in want:
        np.testing.assert_array_equal(f32(got[key]), f32(want[key]))
    want = jtf.paged_prefix_view(jpool, table, 3)
    got = ttf.paged_prefix_view(tpool, tt, 3)
    for key in want:
        np.testing.assert_array_equal(f32(got[key]), f32(want[key]))
    # Scatter: rows write positions 4..9 (crossing a block) and past the
    # window (32 = 4 blocks * 8) -> the trash block.
    S = 6
    spos = jnp.asarray([[4, 5, 6, 7, 8, 9], [28, 29, 30, 31, 32, 33]],
                       jnp.int32)
    L, Hkv, Dh = cfg_j.n_layers, cfg_j.n_kv_heads, cfg_j.head_dim
    if kv_dtype == "int8":
        kq, ks = jtf._quantize_kv(_rand(rng, (L, 2, Hkv, S, Dh)))
        vq, vs = jtf._quantize_kv(_rand(rng, (L, 2, Hkv, S, Dh)))
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {"k": _rand(rng, (L, 2, Hkv, S, Dh)),
                  "v": _rand(rng, (L, 2, Hkv, S, Dh))}
    want = jtf.paged_scatter_tokens(jpool, writes, table, spos)
    got = ttf.paged_scatter_tokens(
        tpool, {k: to_torch(v) for k, v in writes.items()}, tt,
        to_torch(spos))
    for key in want:
        # Block 0 (trash) takes colliding writes in either order.
        np.testing.assert_array_equal(f32(got[key])[:, 1:],
                                      f32(want[key])[:, 1:])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_with_prefix_matches(kv_dtype):
    cfg_j = dataclasses.replace(TINY, kv_cache_dtype=kv_dtype)
    cfg_t = dataclasses.replace(TTINY, kv_cache_dtype=kv_dtype)
    jp, tp = params_pair(cfg_j, seed=1)
    rng = np.random.default_rng(7)
    jpool, tpool = _pool_pair(cfg_j, cfg_t, rng)
    table = jnp.asarray([[3, 1, 4, 0], [2, 5, 7, 6]], jnp.int32)
    Sq = 8
    toks = jnp.asarray(rng.integers(2, 256, (2, Sq)), jnp.int32)
    prefix_lens = jnp.asarray([11, 0], jnp.int32)
    plens = jnp.asarray([17, 5], jnp.int32)
    view = jtf.paged_prefix_view(jpool, table, 4)
    want_l, want_kv = jtf.prefill_with_prefix(jp, toks, plens, view,
                                              prefix_lens, cfg_j)
    tview = ttf.paged_prefix_view(tpool, to_torch(table), 4)
    got_l, got_kv = ttf.prefill_with_prefix(
        tp, to_torch(toks), to_torch(plens), tview, to_torch(prefix_lens),
        cfg_t)
    np.testing.assert_allclose(f32(got_l), f32(want_l), rtol=0,
                               atol=RAGGED_LOGITS_ATOL)
    for key in ("k", "v"):
        _close_bf16(got_kv[key], want_kv[key])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_paged_decode_step_matches(kv_dtype):
    cfg_j = dataclasses.replace(TINY, kv_cache_dtype=kv_dtype)
    cfg_t = dataclasses.replace(TTINY, kv_cache_dtype=kv_dtype)
    jp, tp = params_pair(cfg_j, seed=2)
    rng = np.random.default_rng(8)
    jpool, tpool = _pool_pair(cfg_j, cfg_t, rng)
    table = jnp.asarray([[3, 1, 4, 0], [2, 5, 7, 6], [0, 0, 0, 0]],
                        jnp.int32)
    token = jnp.asarray([7, 9, 1], jnp.int32)
    pos = jnp.asarray([19, 31, 32], jnp.int32)  # row 2 past the window
    want_l, want_pool = jtf.paged_decode_step(jp, token, pos, jpool, table,
                                              cfg_j)
    got_l, got_pool = ttf.paged_decode_step(
        tp, to_torch(token), to_torch(pos), tpool, to_torch(table), cfg_t)
    np.testing.assert_allclose(f32(got_l), f32(want_l), rtol=0,
                               atol=RAGGED_LOGITS_ATOL)
    for key in want_pool:
        g, w = f32(got_pool[key])[:, 1:], f32(want_pool[key])[:, 1:]
        if kv_dtype == "int8" and key in ("k", "v"):
            # Codes of one-ulp-apart bf16 inputs may round one step apart.
            assert np.abs(g - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-2)


def test_model_builds_moe_and_int8_configs():
    """MoE, int8-weight and W8A8 configs build (they raised before they
    were ported); as in JAX the weights start bf16 and the config's
    weight_dtype is the server's cue to quantize them. A float32 model
    builds in f32 (norms f32 as always); float16 still raises."""
    moe = ttf.Transformer(TPRESETS["tiny-moe"], device="cpu")
    assert tuple(moe.blocks[0].w_gate.shape) == (4, 64, 128)
    w8a8 = dataclasses.replace(TTINY, weight_dtype="int8", act_dtype="int8")
    model = ttf.Transformer(w8a8, device="cpu")
    assert model.blocks[0].wq.dtype == torch.bfloat16
    assert model.blocks[0].wq_scale is None and model.embed_scale is None
    f32 = ttf.Transformer(dataclasses.replace(TTINY, dtype="float32"),
                          device="cpu")
    assert f32.embed.dtype == f32.blocks[0].wq.dtype == torch.float32
    assert f32.blocks[0].attn_norm.dtype == torch.float32
    with pytest.raises(NotImplementedError, match="bfloat16"):
        ttf.Transformer(dataclasses.replace(TTINY, dtype="float16"),
                        device="cpu")


def test_init_params_is_seeded_and_scaled():
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = ttf.init_params(TTINY, g1, device="cpu")
    b = ttf.init_params(TTINY, g2, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na
    assert torch.all(a.blocks[0].attn_norm == 1.0)
    std = a.blocks[0].wq.float().std().item()
    assert 0.015 < std < 0.025
