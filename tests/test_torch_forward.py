"""The scoring and whole-batch generation path of seldon_tpu_torch against
the JAX package, on the `tiny` preset with JAX's weights carried across
by ``convert.params_from_numpy``.

Tolerances:
 * logits, ``xla`` attention on both sides: RAGGED_LOGITS_ATOL (1e-2),
   bf16 activations rounded at the same points, summed in another order;
 * logits, ``flash`` on both sides: 2e-2. On the CPU the JAX package's
   flash dispatch runs its closed-form reference while the port runs the
   kernel's plain version (blockwise, the TPU kernel's rounding points);
   2e-2 is what tests/test_ops.py allows between JAX's own flash and xla
   paths;
 * int8 cache codes are equal wherever the bf16 k/v they quantize are
   bit-equal; the bf16 caches within one bf16 rounding step;
 * greedy streams equal, except at a position where JAX's top-2 logit
   gap is below RAGGED_LOGITS_ATOL: such a parting is reported, not
   failed (ROADMAP.md's contract);
 * per-row mean NLL within 2e-3 of the JAX server's scorer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import generate as jgen
from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models import generate as tgen
from seldon_tpu_torch.models import prng
from seldon_tpu_torch.models import transformer as ttf
from seldon_tpu_torch.models.config import ModelConfig as TModelConfig
from seldon_tpu_torch.ops import flash_attention as tfa
from seldon_tpu_torch.ops.ragged_paged_attention import RAGGED_LOGITS_ATOL
from seldon_tpu_torch.servers.torchserver import TorchServer, score_nll
from tests.torch_port_helpers import bits, f32, params_pair, to_torch

TINY = PRESETS["tiny"]
BF16_RTOL = 2.0 ** -7
LOGITS_ATOL = {"xla": RAGGED_LOGITS_ATOL, "flash": 2e-2}
NLL_ATOL = 2e-3


def _cfgs(**kw):
    """(JAX config, the port's config) with the same fields."""
    jcfg = dataclasses.replace(TINY, **kw)
    return jcfg, TModelConfig(**dataclasses.asdict(jcfg))


def _tokens(rng, B, S, vocab):
    return jnp.asarray(rng.integers(2, vocab, (B, S)), jnp.int32)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("tied", [False, True])
def test_forward_matches(attn_impl, tied):
    jcfg, tcfg = _cfgs(attn_impl=attn_impl, tie_embeddings=tied)
    jp, tp = params_pair(jcfg, seed=3)
    assert (tp.lm_head is None) == tied
    toks = _tokens(np.random.default_rng(0), 2, 40, jcfg.vocab_size)
    want = jtf.forward(jp, toks, jcfg)
    launches = tfa.launches
    got, aux = ttf.forward(tp, to_torch(toks), tcfg, return_aux=True)
    assert tfa.launches == launches  # CPU tensors: the plain version
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert float(aux["moe_lb_loss"]) == 0.0
    np.testing.assert_allclose(f32(got), f32(want), rtol=0,
                               atol=LOGITS_ATOL[attn_impl])


def test_ring_without_a_mesh_runs_xla():
    jcfg, tcfg = _cfgs(attn_impl="ring")
    _, tp = params_pair(jcfg, seed=4)
    toks = to_torch(_tokens(np.random.default_rng(1), 2, 24,
                            jcfg.vocab_size))
    xla = ttf.forward(tp, toks, dataclasses.replace(tcfg, attn_impl="xla"))
    assert torch.equal(ttf.forward(tp, toks, tcfg), xla)


def _prefill_pair(jcfg, tcfg, jp, tp, toks, plens, T):
    want_l, want_c = jtf.prefill(jp, toks, plens, jtf.init_cache(jcfg, 3, T),
                                 jcfg)
    cache = ttf.init_cache(tcfg, 3, T, device="cpu")
    got_l, got_c = ttf.prefill(tp, to_torch(toks), to_torch(plens), cache,
                               tcfg)
    assert got_c is cache  # updated in place
    return (want_l, want_c), (got_l, got_c)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_and_decode_step_match(attn_impl, kv_dtype):
    jcfg, tcfg = _cfgs(attn_impl=attn_impl, kv_cache_dtype=kv_dtype)
    jp, tp = params_pair(jcfg, seed=5)
    rng = np.random.default_rng(2)
    T, S = 24, 12
    toks = _tokens(rng, 3, S, jcfg.vocab_size)
    plens = jnp.asarray([12, 7, 3], jnp.int32)
    (want_l, want_c), (got_l, got_c) = _prefill_pair(jcfg, tcfg, jp, tp,
                                                     toks, plens, T)
    np.testing.assert_allclose(f32(got_l), f32(want_l), rtol=0,
                               atol=LOGITS_ATOL[attn_impl])
    if kv_dtype == "int8":
        # The bf16 k/v that were quantized: a bf16 cache's contents.
        jb, tb = _cfgs(attn_impl=attn_impl)
        (_, bf_want), (_, bf_got) = _prefill_pair(jb, tb, jp, tp, toks,
                                                  plens, T)
        for key in ("k", "v"):
            same = np.all(bits(bf_got[key]) == bits(bf_want[key]), axis=-1)
            codes_g = got_c[key].numpy()
            codes_w = np.asarray(want_c[key])
            assert same.mean() > 0.5
            np.testing.assert_array_equal(codes_g[same], codes_w[same])
            np.testing.assert_array_equal(bits(got_c[key + "_scale"])[same],
                                          bits(want_c[key + "_scale"])[same])
    else:
        for key in ("k", "v"):
            np.testing.assert_allclose(f32(got_c[key]), f32(want_c[key]),
                                       rtol=BF16_RTOL, atol=1e-2)
    token = jnp.asarray([5, 9, 200], jnp.int32)
    want_l, want_c = jtf.decode_step(jp, token, plens, want_c, jcfg)
    got_l, got_c = ttf.decode_step(tp, to_torch(token), to_torch(plens),
                                   got_c, tcfg)
    np.testing.assert_allclose(f32(got_l), f32(want_l), rtol=0,
                               atol=LOGITS_ATOL[attn_impl])
    rows = np.arange(3)
    for key in want_c:
        g = f32(got_c[key])[:, rows, :, np.asarray(plens)]
        w = f32(want_c[key])[:, rows, :, np.asarray(plens)]
        if kv_dtype == "int8" and key in ("k", "v"):
            # Codes of one-ulp-apart bf16 inputs may round one step apart.
            assert np.abs(g - w).max() <= 1
        else:
            np.testing.assert_allclose(g, w, rtol=BF16_RTOL, atol=1e-2)


def test_decode_step_past_the_cache_writes_nothing():
    jcfg, tcfg = _cfgs()
    _, tp = params_pair(jcfg, seed=6)
    cache = ttf.init_cache(tcfg, 2, 8, device="cpu")
    for key in cache:
        cache[key].normal_()
    before = {key: arr.clone() for key, arr in cache.items()}
    token = torch.tensor([3, 4], dtype=torch.int32)
    pos = torch.tensor([8, 5], dtype=torch.int32)  # row 0 past the end
    ttf.decode_step(tp, token, pos, cache, tcfg)
    for key in cache:
        assert torch.equal(cache[key][:, 0], before[key][:, 0])
        changed = cache[key][:, 1] != before[key][:, 1]
        # Column 5 is rewritten (a bf16 value may repeat by chance).
        assert changed[:, :, 5].float().mean() > 0.9
        assert not changed[:, :, :5].any() and not changed[:, :, 6:].any()


def _first_parting(got, want):
    return next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                None)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_greedy_generate_matches(attn_impl):
    jcfg, tcfg = _cfgs(attn_impl=attn_impl)
    jp, tp = params_pair(jcfg, seed=7)
    rng = np.random.default_rng(3)
    B, S, T = 4, 16, 12
    toks = np.array(_tokens(rng, B, S, jcfg.vocab_size))
    plens = np.asarray([16, 11, 5, 9], np.int32)
    for b in range(B):
        toks[b, plens[b]:] = jcfg.pad_token_id  # right-padded prompts
    knobs = (jnp.zeros(B, jnp.float32), jnp.zeros(B, jnp.int32),
             jnp.ones(B, jnp.float32))
    # EOS: a token JAX's greedy streams emit mid-stream, so rows freeze.
    probe, _ = jgen.generate(jp, jnp.asarray(toks), jnp.asarray(plens),
                             jax.random.key(0), *knobs, jcfg, T)
    eos = int(np.asarray(probe)[0, T // 2])
    jcfg, tcfg = _cfgs(attn_impl=attn_impl, eos_token_id=eos)
    want, want_lens = jgen.generate(jp, jnp.asarray(toks),
                                    jnp.asarray(plens), jax.random.key(0),
                                    *knobs, jcfg, T)
    got, got_lens = tgen.generate(tp, torch.from_numpy(toks),
                                  torch.from_numpy(plens),
                                  prng.key(torch.tensor(0)),
                                  *(to_torch(k) for k in knobs), tcfg, T)
    assert got.dtype == torch.int32 and got_lens.dtype == torch.int32
    want, want_lens = np.asarray(want), np.asarray(want_lens)
    assert (want == eos).any() and (want_lens < T).any()
    for b in range(B):
        k = _first_parting(got[b].tolist(), want[b].tolist())
        if k is None:
            assert int(got_lens[b]) == int(want_lens[b])
            continue
        # The context up to the parting token, through JAX's forward.
        ctx = np.concatenate([toks[b, :plens[b]], want[b, :k]])
        row = np.asarray(jtf.forward(jp, jnp.asarray(ctx[None]), jcfg))[0, -1]
        gap = float(np.diff(np.sort(row)[-2:])[0])
        print(f"{attn_impl} row {b}: parts at token {k}, JAX top-2 gap "
              f"{gap:.3g}")
        assert gap < RAGGED_LOGITS_ATOL, (b, k, gap)


def test_generate_freezes_rows_after_eos():
    _, tcfg = _cfgs()
    _, tp = params_pair(TINY, seed=8)
    B, T = 3, 10
    toks = torch.randint(2, 256, (B, 6), generator=torch.Generator()
                         .manual_seed(1)).int()
    knobs = (torch.full((B,), 0.9), torch.zeros(B, dtype=torch.int32),
             torch.ones(B))
    out, _ = tgen.generate(tp, toks, torch.full((B,), 6, dtype=torch.int32),
                           prng.key(torch.tensor(2)), *knobs, tcfg, T)
    eos = int(out[0, 3])
    tcfg = dataclasses.replace(tcfg, eos_token_id=eos)
    out, lens = tgen.generate(tp, toks, torch.full((B,), 6, dtype=torch.int32),
                              prng.key(torch.tensor(2)), *knobs, tcfg, T)
    again, _ = tgen.generate(tp, toks, torch.full((B,), 6, dtype=torch.int32),
                             prng.key(torch.tensor(2)), *knobs, tcfg, T)
    assert torch.equal(out, again)  # the key seeds the draws
    for b in range(B):
        row = out[b].tolist()
        if eos in row:
            j = row.index(eos)
            assert int(lens[b]) == j + 1
            assert all(t == tcfg.pad_token_id for t in row[j + 1:])
        else:
            assert int(lens[b]) == T
    assert int(lens[0]) <= 4


@pytest.mark.parametrize("B", [1, 3])
def test_flash_gets_contiguous_folds(monkeypatch, B):
    """The flash kernel takes only contiguous [B*H, S, Dh] tensors; the
    fold of a one-row batch (a bucketed admission of one prompt) is a
    strided view unless made contiguous."""
    _, tcfg = _cfgs(attn_impl="flash")
    _, tp = params_pair(TINY, seed=1)
    seen = []

    def checking(q, k, v, **kw):
        seen.append(all(t.is_contiguous() for t in (q, k, v)))
        return tfa.flash_blockwise(q, k, v, True, 0,
                                   q_per_kv=kw["q_per_kv"])

    monkeypatch.setattr(ttf, "flash_attention", checking)
    toks = torch.randint(2, 256, (B, 20), generator=torch.Generator()
                         .manual_seed(B))
    ttf.forward(tp, toks, tcfg)
    assert seen and all(seen)


@pytest.mark.parametrize("knobs", ["temperature", "top_k_top_p"])
def test_sampled_generate_matches_jax(knobs):
    """Sampled whole-batch generate from one key: the step keys and the
    per-row keys are JAX's ``split``s, so the tokens equal JAX's. A
    parting is a near-tie of the noisy, masked, temperature-scaled
    logits (the Gumbel values may differ by an ulp, ROADMAP.md C8, and
    the top-k edge moves with a logit difference that small, C5): it is
    reported, not hidden."""
    from seldon_tpu.models import sampling as jsm

    jcfg, tcfg = _cfgs()
    jp, tp = params_pair(jcfg, seed=9)
    rng = np.random.default_rng(4)
    B, S, T = 4, 12, 10
    toks = np.array(_tokens(rng, B, S, jcfg.vocab_size))
    plens = np.asarray([12, 7, 9, 3], np.int32)
    for b in range(B):
        toks[b, plens[b]:] = jcfg.pad_token_id
    top_k = 20 if knobs == "top_k_top_p" else 0
    top_p = 0.9 if knobs == "top_k_top_p" else 1.0
    jknobs = (jnp.full(B, 0.8, jnp.float32), jnp.full(B, top_k, jnp.int32),
              jnp.full(B, top_p, jnp.float32))
    want, want_lens = jgen.generate(jp, jnp.asarray(toks),
                                    jnp.asarray(plens), jax.random.key(5),
                                    *jknobs, jcfg, T)
    got, got_lens = tgen.generate(tp, torch.from_numpy(toks),
                                  torch.from_numpy(plens), 5,
                                  *(to_torch(k) for k in jknobs), tcfg, T)
    want = np.asarray(want)
    step_keys = jax.random.split(jax.random.key(5), T)
    equal = 0
    for b in range(B):
        k = _first_parting(got[b].tolist(), want[b].tolist())
        if k is None:
            equal += 1
            assert int(got_lens[b]) == int(np.asarray(want_lens)[b])
            continue
        ctx = np.concatenate([toks[b, :plens[b]], want[b, :k]])
        row = jtf.forward(jp, jnp.asarray(ctx[None]), jcfg)[0, -1:] / 0.8
        edge = np.inf
        if top_k:
            desc = np.sort(np.asarray(row[0]))[::-1]
            edge = float(desc[top_k - 1] - desc[top_k])
        row = jsm._mask_top_k_top_p(row, jnp.asarray([top_k], jnp.int32),
                                    jnp.asarray([top_p], jnp.float32))
        key = jax.random.split(step_keys[k], B)[b]
        noisy = np.asarray(row[0] + jax.random.gumbel(
            key, (jcfg.vocab_size,), jnp.float32))
        gap = float(np.diff(np.sort(noisy)[-2:])[0])
        print(f"sampled generate row {b}: parts at token {k}, noisy top-2 "
              f"gap {gap:.3g}, top-k edge gap {edge:.3g}")
        assert min(gap, edge) < RAGGED_LOGITS_ATOL, (b, k, gap, edge)
    assert equal >= B - 1, equal


@pytest.fixture(scope="module")
def jax_scorer():
    """The JAX server's own scorer (``_score`` behind ``predict``) and
    its config."""
    from seldon_tpu.servers.jaxserver import JAXServer

    srv = JAXServer(preset="tiny", max_slots=2, max_seq_len=64)
    srv.load()
    srv.engine.stop()
    return srv._score_fn, srv.cfg


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
def test_score_nll_matches_the_jax_scorer(jax_scorer, attn_impl):
    score_fn, cfg = jax_scorer
    jp, tp = params_pair(cfg, seed=9)
    tcfg = TModelConfig(**dataclasses.asdict(cfg))
    tcfg = dataclasses.replace(tcfg, attn_impl=attn_impl)
    toks = _tokens(np.random.default_rng(4), 3, 48, cfg.vocab_size)
    want = np.asarray(score_fn(jp, toks))
    got = score_nll(tp, to_torch(toks), tcfg)
    assert got.dtype == torch.float32 and got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=NLL_ATOL)


def test_torchserver_predict_on_the_cpu():
    srv = TorchServer(preset="tiny", device="cpu")
    X = np.random.default_rng(5).integers(0, 256, (3, 20))
    nll = srv.predict(X, names=[])
    assert nll.shape == (3,) and np.isfinite(nll).all()
    one = srv.predict(X[1], names=[])
    assert one.shape == (1,)
    np.testing.assert_allclose(one[0], nll[1], rtol=1e-6)
    assert srv.engine is None  # scoring needs the weights only
    want = score_nll(srv.params, torch.from_numpy(X).int(), srv.cfg)
    np.testing.assert_array_equal(nll, want.numpy())
