"""Speculative decoding in seldon_tpu_torch against the JAX package and
against the port's own spec-off engine, on the ``tiny`` preset.

 * The verify wave: the masked leg against JAX's ``verify_wave`` on the
   same pool, tables and drafts (rows that accept all, some and none of
   their drafts, one row near a block boundary, an armed row outside the
   wave and an idle one; stale values in the pool past every row's
   position, as rejected drafts leave them): tokens, valid columns,
   state and the pool's writes. The sparse leg and the kernel leg (its
   plain version on the CPU) against the masked leg: logits within
   RAGGED_LOGITS_ATOL, finite for the rows outside the wave (bound 0),
   greedy tokens equal.
 * The drafters: ``draft_tokens`` against JAX's; ``NGramDrafter`` and
   ``ModelDrafter`` against JAX's on seeded histories, bit for bit.
 * The engine: spec-on streams equal spec-off streams inside the port,
   greedy and sampled, in the paged, chunked and prefix modes, bf16 and
   int8 KV, and equal the JAX engine's spec-off bucketed streams (JAX's
   own spec legs are not used as an oracle, ROADMAP.md). A self-draft
   (the target's own weights as the draft model) accepts every draft
   and compresses the decode dispatches; rejection at position 0 leaks
   no block; full acceptance crosses block boundaries; EOS inside an
   accepted prefix ends the row there; accepted + rejected = drafted and
   emitted + rejected = (k + 1) x wave rows hold exactly.
Every case runs for bf16 models (bf16 or int8 KV) and float32 models (f32
or int8 KV); the f32 streams against JAX's part only at top-2 gaps below
1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import spec_decode as jsd
from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu.servers import spec_decode as jsh
from seldon_tpu_torch.models import spec_decode as tsd
from seldon_tpu_torch.models import transformer as ttf
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops.ragged_paged_attention import RAGGED_LOGITS_ATOL
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import spec_decode as tsh
from tests.torch_port_helpers import (assert_streams_match, f32, params_pair,
                                      run_jax_engine, to_torch)

B, BLOCK, NBS, K = 5, 8, 8, 4
SMAX = BLOCK * NBS


# The fixtures' model kinds: bf16 with a bf16 or int8 pool, and float32
# models with an f32 or int8 pool (ModelConfig.dtype = "float32").
KINDS = {"bf16": ("bfloat16", "bf16"), "int8": ("bfloat16", "int8"),
         "f32": ("float32", "bf16"), "f32-int8": ("float32", "int8")}
# The near-tie bound of stream comparisons for f32 models: their logits
# agree with JAX's to 1e-4 (tests/test_torch_f32_model.py).
F32_ATOL = 1e-4


def _cfgs(kind):
    dtype, kv = KINDS[kind]
    return (dataclasses.replace(PRESETS["tiny"], dtype=dtype,
                                kv_cache_dtype=kv),
            dataclasses.replace(TPRESETS["tiny"], dtype=dtype,
                                kv_cache_dtype=kv))


def _t(x):
    t = to_torch(x)
    return t.to(torch.int64) if np.asarray(x).dtype == np.uint32 else t


def _torch_state(state):
    st = {k: _t(v) for k, v in state.items() if k != "cache"}
    st["cache"] = {k: to_torch(v) for k, v in state["cache"].items()}
    return st


@pytest.fixture(scope="module", params=list(KINDS))
def wave(request):
    """A verify wave's inputs: rows 0-2 in the wave at positions 20, 29
    (its drafts cross into the next block) and 11; row 3 armed but outside
    the wave; row 4 idle. Every pool block holds random values first, so
    positions past a row's ``pos`` are stale; each row's first ``pos``
    positions hold its prompt's KV. Row 0's drafts are the target's own
    greedy continuation (all accepted), row 1's first draft only, row 2's
    none."""
    cfg, tcfg = _cfgs(request.param)
    jp, tp = params_pair(cfg, seed=0)
    rng = np.random.default_rng(3)
    pool = jtf.init_paged_cache(cfg, B * NBS + 1, BLOCK)
    pool = {k: (jnp.asarray(rng.integers(-100, 100, v.shape), v.dtype)
                if v.dtype == jnp.int8 else
                jnp.asarray(rng.standard_normal(v.shape) * 0.5, v.dtype))
            for k, v in pool.items()}
    if request.param == "int8":
        for key in ("k_scale", "v_scale"):
            pool[key] = jnp.abs(pool[key]) * 0.02 + 1e-3
    table = np.stack([1 + i * NBS + np.arange(NBS)
                      for i in range(B)]).astype(np.int32)
    pos = np.asarray([20, 29, 11, 15, 0], np.int32)
    last = np.zeros((B,), np.int32)
    for row in range(4):
        n = int(pos[row])
        tks = jnp.asarray(rng.integers(3, cfg.vocab_size, (1, n)), jnp.int32)
        cache = jtf.init_cache(cfg, 1, SMAX)
        logits, cache = jtf.prefill(jp, tks, jnp.asarray([n], jnp.int32),
                                    cache, cfg)
        pool = jtf.paged_scatter_tokens(
            pool, {k: cache[k][:, :, :, :n] for k in cache},
            jnp.asarray(table[row:row + 1]), jnp.arange(n)[None, :])
        last[row] = int(jnp.argmax(logits[0]))
    state = {
        "cache": pool,
        "last_tok": jnp.asarray(last),
        "pos": jnp.asarray(pos),
        "active": jnp.asarray([True, True, True, True, False]),
        "temp": jnp.zeros((B,), jnp.float32),
        "top_k": jnp.zeros((B,), jnp.int32),
        "top_p": jnp.ones((B,), jnp.float32),
        "seeds": jnp.asarray([3, 4, 5, 6, 7], jnp.uint32),
        "remaining": jnp.asarray([9, 9, 9, 9, 0], jnp.int32),
    }
    wave_mask = np.asarray([True, True, True, False, False])
    jtable = jnp.asarray(table)
    drafts = rng.integers(3, cfg.vocab_size, (B, K)).astype(np.int32)
    # Make row 0's drafts the target's own tokens, one wave at a time.
    for i in range(K):
        _, toks, _ = jsd.verify_wave(jp, state, jtable, jnp.asarray(drafts),
                                     jnp.asarray(wave_mask), cfg)
        drafts[0, i] = int(np.asarray(toks)[i, 0])
        if i == 0:
            drafts[1, 0] = int(np.asarray(toks)[0, 1])
    drafts[2, 0] = (int(np.asarray(toks)[0, 2]) + 1) % cfg.vocab_size
    st2, toks, valid = jsd.verify_wave(jp, state, jtable, jnp.asarray(drafts),
                                       jnp.asarray(wave_mask), cfg)
    n_valid = np.asarray(valid).sum(axis=0)
    assert n_valid[:3].tolist() == [K + 1, 2, 1], n_valid
    return dict(cfg=cfg, tcfg=tcfg, jp=jp, tp=tp, state=state, table=table,
                drafts=drafts, wave=wave_mask, want=(st2, toks, valid))


def test_verify_wave_masked_leg_matches_jax(wave):
    w = wave
    st = _torch_state(w["state"])
    pool_before = {k: v.clone() for k, v in st["cache"].items()}
    st2, toks, valid = tsd.verify_wave(
        w["tp"], st, torch.from_numpy(w["table"]),
        torch.from_numpy(w["drafts"]), torch.from_numpy(w["wave"]),
        w["tcfg"], kernel="masked")
    jst, jtoks, jvalid = w["want"]
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))
    for key in ("last_tok", "pos", "active", "remaining"):
        np.testing.assert_array_equal(st2[key].numpy(), np.asarray(jst[key]),
                                      err_msg=key)
    # The pool writes: every wave row's k + 1 positions (the rows outside
    # the wave write only the trash block); nothing else moves.
    for key, arr in jst["cache"].items():
        g, r = f32(st2["cache"][key]), np.asarray(arr, np.float32)
        if key in ("k", "v") and w["cfg"].kv_cache_dtype == "int8":
            assert np.abs(g - r)[:, 1:].max() <= 2, key
        else:
            np.testing.assert_allclose(g[:, 1:], r[:, 1:], rtol=2.0 ** -7,
                                       atol=1e-2, err_msg=key)
        moved = (f32(st2["cache"][key]) != f32(pool_before[key]))[:, 1:]
        blocks = set(np.nonzero(moved.any(axis=tuple(
            i for i in range(moved.ndim) if i != 1)))[0] + 1)
        written = {int(w["table"][r, p // BLOCK]) for r in range(3)
                   for p in range(int(w["state"]["pos"][r]),
                                  int(w["state"]["pos"][r]) + K + 1)}
        assert blocks <= written, (key, blocks - written)


def _legs(w, leg):
    """Logits [B, k+1, V] of one leg's layer loop on the wave's inputs,
    and its KV writes."""
    st = _torch_state(w["state"])
    table = torch.from_numpy(w["table"])
    inputs = torch.cat([st["last_tok"][:, None],
                        torch.from_numpy(w["drafts"])], dim=1)
    positions = st["pos"][:, None] + torch.arange(K + 1)[None, :]
    x = ttf._embed_rows(w["tp"], inputs)
    inv_freq = ttf.rope_frequencies(w["tcfg"], "cpu")
    if leg == "masked":
        mask = torch.arange(SMAX)[None, None, :] < positions[:, :, None]
        x, fresh = tsd._run_blocks_verify(w["tp"], x, w["tcfg"], positions,
                                          inv_freq, mask, st["cache"], table)
    else:
        bound = torch.where(torch.from_numpy(w["wave"]), st["pos"],
                            0).int()
        x, fresh = tsd._run_blocks_verify_sparse(
            w["tp"], x, w["tcfg"], positions, inv_freq, st["cache"], table,
            bound, mode=leg,
            n_live=-(-int(w["state"]["pos"].max()) // BLOCK))
    return ttf._logits(w["tp"], x, w["tcfg"]), fresh


@pytest.mark.parametrize("leg", ["sparse", "pallas", "reference"])
def test_verify_legs_within_atol_of_the_masked_leg(wave, leg):
    w = wave
    ref, ref_fresh = _legs(w, "masked")
    got, fresh = _legs(w, leg)
    assert torch.isfinite(got).all()
    live = torch.from_numpy(w["wave"])
    err = (got - ref)[live].abs().max().item()
    assert err <= RAGGED_LOGITS_ATOL, err
    # The wave rows' writes (the others' go to the trash block).
    for key in ref_fresh:
        g, r = f32(fresh[key][:, live]), f32(ref_fresh[key][:, live])
        if key in ("k", "v") and w["cfg"].kv_cache_dtype == "int8":
            assert np.abs(g - r).max() <= 2, key
        else:
            np.testing.assert_allclose(g, r, rtol=2.0 ** -7, atol=1e-2)
    # Greedy tokens of the wave rows, except at a reported near-tie.
    a, b = got.argmax(-1)[live], ref.argmax(-1)[live]
    for i, j in zip(*np.nonzero((a != b).numpy())):
        top2 = torch.topk(ref[live][i, j], 2).values
        gap = float(top2[0] - top2[1])
        assert gap < RAGGED_LOGITS_ATOL, (leg, i, j, gap)
        print(f"near-tie reported: {leg} row {i} column {j} gap {gap:.3g}")


@pytest.mark.parametrize("leg", ["sparse", "pallas"])
def test_verify_wave_legs_emit_the_masked_tokens(wave, leg):
    w = wave
    outs = {}
    for name in ("masked", leg):
        st2, toks, valid = tsd.verify_wave(
            w["tp"], _torch_state(w["state"]), torch.from_numpy(w["table"]),
            torch.from_numpy(w["drafts"]), torch.from_numpy(w["wave"]),
            w["tcfg"], kernel=name,
            n_live=None if name == "masked" else 4)
        outs[name] = (toks, valid, st2["pos"])
    for a, b in zip(outs[leg], outs["masked"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_verify_block_budget_sends_long_waves_to_the_masked_leg(wave):
    """``block_budget`` on the CPU: a wave whose longest row needs more
    blocks than the budget runs the masked leg (the JAX ``lax.cond``)."""
    w = wave
    calls = []
    orig = tsd._run_blocks_verify

    def spy(*a, **kw):
        calls.append(1)
        return orig(*a, **kw)

    tsd._run_blocks_verify = spy
    try:
        for budget, masked in ((2, True), (8, False)):
            calls.clear()
            tsd.verify_wave(w["tp"], _torch_state(w["state"]),
                            torch.from_numpy(w["table"]),
                            torch.from_numpy(w["drafts"]),
                            torch.from_numpy(w["wave"]), w["tcfg"],
                            kernel="pallas", block_budget=budget)
            assert bool(calls) == masked, budget
    finally:
        tsd._run_blocks_verify = orig


def test_draft_tokens_match_jax():
    cfg, tcfg = _cfgs("bf16")
    jp, tp = params_pair(cfg, seed=1)
    rng = np.random.default_rng(5)
    W = 16
    window = rng.integers(3, cfg.vocab_size, (4, W)).astype(np.int32)
    wlens = np.asarray([16, 9, 1, 12], np.int32)
    for r, n in enumerate(wlens):
        window[r, n:] = cfg.pad_token_id
    for k in (1, 2, 4):
        want = jsd.draft_tokens(jp, jnp.asarray(window), jnp.asarray(wlens),
                                cfg, k)
        got = tsd.draft_tokens(tp, torch.from_numpy(window),
                               torch.from_numpy(wlens), tcfg, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ngram_drafter_matches_jax():
    rng = np.random.default_rng(6)
    jd, td = jsh.NGramDrafter(), tsh.NGramDrafter()
    for _ in range(200):
        prompt = rng.integers(0, 6, rng.integers(1, 30)).tolist()
        gen = rng.integers(0, 6, rng.integers(0, 300)).tolist()
        k = int(rng.choice([1, 2, 4]))
        assert td.draft(prompt, gen, k) == jd.draft(prompt, gen, k)


def test_model_drafter_matches_jax():
    cfg, tcfg = _cfgs("bf16")
    jp, tp = params_pair(cfg, seed=2)
    rows = [(0, list(range(3, 40))), (2, [7, 8, 9]), (3, list(range(90)))]
    jits = {k: jax.jit(lambda w, l, k=k: jsd.draft_tokens(jp, w, l, cfg, k))
            for k in (1, 2)}
    jd = jsh.make_drafter(jits, 16, cfg.pad_token_id)
    td = tsh.make_drafter((tp, tcfg), 16, tcfg.pad_token_id)
    assert td.uses_model and isinstance(tsh.make_drafter(None, 16, 0),
                                         tsh.NGramDrafter)
    for k in (1, 2):
        np.testing.assert_array_equal(td.draft_batch(rows, k, 4),
                                      jd.draft_batch(rows, k, 4))


# ---------------------------------------------------------------------------
# The engine
# ---------------------------------------------------------------------------

PROMPT = list(range(100, 124))  # 24 tokens: 3 kv blocks exactly
MIXED = [list(range(2, 26)), list(range(30, 33)), list(range(40, 57)),
         [5, 9], list(range(60, 73))]
PAGED = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
             paged_kv=True, kv_block=8, prefix_block=8)
SPEC = dict(PAGED, spec_decode=True, spec_k=4)
MODES = {"paged": {}, "chunked": dict(chunked_prefill=True, prefill_chunk=8),
         "prefix": dict(prefix_cache=True)}
GREEDY = dict(temperature=0.0, max_new_tokens=12)
SAMPLED = dict(temperature=0.9, top_k=8, top_p=0.95, max_new_tokens=12)


def _knobs(i):
    return GREEDY if i % 2 == 0 else SAMPLED


def _serve(params, cfg, ecfg, prompts, drafter=None, draft=None, passes=1):
    """Streams of `prompts` (request i seeded i, greedy or sampled by
    parity) through one engine, with the engine's stats and leak audit."""
    from tests.torch_port_helpers import drain

    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(**ecfg),
                               device="cpu", draft=draft)
    if drafter is not None:
        eng._drafter = drafter
    eng.start()
    try:
        out = []
        for _ in range(passes):
            qs = [eng.submit(p, SamplingParams(seed=i, **_knobs(i)))
                  for i, p in enumerate(prompts)]
            out.append([drain(q) for q in qs])
        eng.drain(timeout=60)
        leaks = eng.debug_lifecycle_check()
        snap = eng.stats.snapshot()
    finally:
        eng.stop()
    assert leaks == {}, leaks
    return out[-1] if passes == 1 else out, snap, eng


@pytest.fixture(scope="module", params=list(KINDS))
def weights(request):
    cfg, tcfg = _cfgs(request.param)
    jp, tp = params_pair(cfg, seed=0)
    return cfg, tcfg, jp, tp


@pytest.mark.parametrize("kernel", ["masked", "pallas"])
@pytest.mark.parametrize("mode", list(MODES))
def test_spec_on_equals_spec_off(weights, mode, kernel):
    """Greedy and sampled requests in one burst: spec-on streams are the
    spec-off engine's token for token (the prefix mode serves the burst
    twice, the second time warm)."""
    _, tcfg, _, tp = weights
    passes = 2 if mode == "prefix" else 1
    off, _, _ = _serve(tp, tcfg, dict(PAGED, **MODES[mode]), MIXED,
                       passes=passes)
    on, snap, _ = _serve(tp, tcfg, dict(SPEC, ragged_kernel=kernel,
                                        **MODES[mode]), MIXED, passes=passes)
    assert on == off
    assert snap["spec_verify_waves"] >= 1
    if mode == "prefix":
        # Every prompt longer than one prefix block hits when warm.
        assert snap["zero_copy_admissions"] == sum(len(p) > 8 for p in MIXED)


def test_spec_on_equals_the_jax_spec_off_engine(weights):
    cfg, tcfg, jp, tp = weights
    for knobs in (GREEDY, SAMPLED):
        want = run_jax_engine(jp, cfg, MIXED, knobs, PAGED)
        from tests.torch_port_helpers import run_torch_engine

        got, _ = run_torch_engine(tp, tcfg, MIXED, knobs, "pallas",
                                  dict(SPEC))
        assert_streams_match(got, want, jp, cfg, MIXED,
                             f"spec/{cfg.dtype}/{cfg.kv_cache_dtype}",
                             knobs=knobs,
                             atol=F32_ATOL if cfg.dtype == "float32"
                             else None)


class _Oracle:
    """A perfect drafter: the spec-off greedy continuation."""

    uses_model = False

    def __init__(self, want):
        self._want = list(want)

    def draft(self, prompt, gen, k):
        out = list(self._want[len(gen):len(gen) + k])
        return out + [self._want[-1]] * (k - len(out))


class _AntiOracle(_Oracle):
    """Always wrong: every wave rejects at position 0."""

    def __init__(self, want, vocab):
        super().__init__(want)
        self._vocab = vocab

    def draft(self, prompt, gen, k):
        return [(t + 1) % self._vocab
                for t in super().draft(prompt, gen, k)]


def _one(tp, tcfg, ecfg, drafter=None, draft=None):
    out, snap, eng = _serve(tp, tcfg, ecfg, [PROMPT], drafter=drafter,
                            draft=draft)
    return out[0], snap, eng


def test_self_draft_perfect_greedy_acceptance(weights):
    """The target's own weights as the draft model: every greedy draft is
    the continuation, so 11 decoded tokens take ceil(11 / 5) = 3 waves."""
    _, tcfg, _, tp = weights
    want, off, _ = _one(tp, tcfg, PAGED)
    got, snap, _ = _one(tp, tcfg, dict(SPEC, spec_draft="tiny"),
                        draft=(tp, tcfg))
    assert got == want
    assert snap["decode_dispatches"] <= 3 < off["decode_steps"]
    assert snap["spec_acceptance_rate"] >= 0.5
    assert snap["decode_dispatches"] / snap["tokens_out"] < 1.0


def test_rejection_at_position_zero_is_leak_free(weights):
    _, tcfg, _, tp = weights
    want, _, _ = _one(tp, tcfg, PAGED)
    got, snap, _ = _one(tp, tcfg, SPEC,
                        drafter=_AntiOracle(want, tcfg.vocab_size))
    assert got == want
    assert snap["decode_dispatches"] == len(want) - 1
    assert snap["spec_accepted_tokens"] == 0


def test_full_k_acceptance_crosses_block_boundaries(weights):
    """Full-k waves march the write position across kv blocks (24 + 12
    crosses position 32 with kv_block 8); every grown block comes back."""
    _, tcfg, _, tp = weights
    want, _, _ = _one(tp, tcfg, PAGED)
    got, snap, eng = _one(tp, tcfg, SPEC, drafter=_Oracle(want))
    assert got == want
    pool = eng._allocator.snapshot()
    assert pool["free"] == pool["total"], pool
    assert snap["decode_dispatches"] <= 3


def test_eos_mid_accepted_prefix(weights):
    """EOS inside an accepted run ends the row there: the drafts go on
    past it, match, and count rejected."""
    _, tcfg, _, tp = weights
    base, _, _ = _one(tp, tcfg, PAGED)
    # The third decoded token: the first wave (k = 4) carries it with two
    # matching drafts behind it.
    eos_cfg = dataclasses.replace(tcfg, eos_token_id=int(base[3]))
    want, _, _ = _one(tp, eos_cfg, PAGED)
    assert len(want) < len(base)
    got, snap, _ = _one(tp, eos_cfg, SPEC, drafter=_Oracle(base))
    assert got == want
    assert snap["spec_rejected_tokens"] > 0


def test_conservation_and_acceptance_identities(weights, monkeypatch):
    """Per wave: accepted + rejected = drafted and emitted + rejected =
    (k + 1) x wave rows, exactly; the totals re-sum in the stats."""
    _, tcfg, _, tp = weights
    waves = []
    orig = teng.InferenceEngine._spec_post_process

    def spy(self, chunk_data, roster):
        info = self._spec_wave
        before = (self._spec_drafted, self._spec_accepted)
        orig(self, chunk_data, roster)
        if info is not None and chunk_data is not None and info[2]:
            k, wave, n_wave = info
            emitted = int(chunk_data[1].sum(axis=0)[wave].sum())
            waves.append((k, n_wave, emitted,
                          self._spec_drafted - before[0],
                          self._spec_accepted - before[1]))

    monkeypatch.setattr(teng.InferenceEngine, "_spec_post_process", spy)
    _, snap, _ = _serve(tp, tcfg, SPEC, MIXED)
    assert waves
    rejected = 0
    for k, n_wave, emitted, drafted, accepted in waves:
        rej = (k + 1) * n_wave - emitted
        assert accepted + rej == drafted == k * n_wave
        assert emitted + rej == (k + 1) * n_wave
        rejected += rej
    assert snap["spec_drafted_tokens"] == sum(w[3] for w in waves)
    assert snap["spec_accepted_tokens"] == sum(w[4] for w in waves)
    assert snap["spec_rejected_tokens"] == rejected
    assert (snap["spec_accepted_tokens"] + snap["spec_rejected_tokens"]
            == snap["spec_drafted_tokens"])
    assert snap["spec_verify_waves"] == len(waves)
