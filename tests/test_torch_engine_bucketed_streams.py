"""The port's bucketed and dense engines against the JAX package's,
whole engine, on the ``tiny`` preset (bf16 and int8 KV).

One mixed burst — prompts of several prompt buckets, more requests than
slots, half greedy and half sampled (temperature, top-k, top-p) — through
the JAX engine and the port's on the same weights, in each mode of the
bucketed family: the dense slab (the JAX engine's default), the paged
pool, paged with chunked prefill, the dense slab with chunked prefill,
and the dense and paged prefix caches (a cold burst, then the same burst
warm). The JAX engine runs with a copying ``jnp.asarray`` (ROADMAP.md
C3). Streams must be equal under ``assert_streams_match``'s contract
(a parting only at a near-tie of the reference, reported). Inside the
port the bucketed streams must equal its own ragged engine's on the
kernel leg, and both scheduler loops give the same streams. Each run's
leak audit is clean."""

import dataclasses

import numpy as np
import pytest

from seldon_tpu.models.config import PRESETS
from seldon_tpu.models.sampling import SamplingParams as JSamplingParams
from seldon_tpu.servers import engine as jeng
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import engine as teng
from tests.torch_port_helpers import (_copying, assert_streams_match, drain,
                                      engine_prompts, params_pair)

NEW = 8
GREEDY = dict(temperature=0.0)
SAMPLED = dict(temperature=0.8, top_k=20, top_p=0.95)
BASE = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32),
            max_admit=4, decode_chunk=4, min_chunk=2, prefix_block=8,
            kv_block=8)
MODES = {
    "dense": dict(),
    "paged": dict(paged_kv=True),
    "paged-chunked": dict(paged_kv=True, chunked_prefill=True,
                          prefill_chunk=16),
    "dense-chunked": dict(chunked_prefill=True, prefill_chunk=8),
    "dense-prefix": dict(prefix_cache=True),
    "paged-prefix": dict(paged_kv=True, prefix_cache=True),
}


def _knobs(i):
    return GREEDY if i % 2 == 0 else SAMPLED


def _prompts(cfg, mode):
    """The burst; under the prefix cache every prompt shares a 16-token
    head, so the warm pass hits the trie."""
    prompts = engine_prompts(cfg)
    if "prefix" in mode:
        head = list(range(40, 56))
        prompts = [head + p[:14] for p in prompts]
    return prompts


def _burst(submit, drain_fn, prompts):
    qs = [submit(p, i) for i, p in enumerate(prompts)]
    return [drain_fn(q) for q in qs]


def _run_jax(params, cfg, ecfg, prompts, passes):
    import jax.numpy as jnp

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(params, cfg, jeng.EngineConfig(**ecfg))
        eng.start()
        try:
            return [_burst(lambda p, i: eng.submit(p, JSamplingParams(
                seed=i, max_new_tokens=NEW, **_knobs(i))), drain, prompts)
                for _ in range(passes)]
        finally:
            eng.stop()


def _run_torch(params, cfg, ecfg, prompts, passes):
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(**ecfg),
                               device="cpu")
    eng.start()
    try:
        out = [_burst(lambda p, i: eng.submit(p, SamplingParams(
            seed=i, max_new_tokens=NEW, **_knobs(i))), drain, prompts)
            for _ in range(passes)]
    finally:
        eng.stop()
    assert eng.debug_lifecycle_check() == {}
    return out, eng.stats.snapshot()


def _assert_match(got, want, jparams, cfg, prompts, what):
    """The greedy and the sampled requests, each under its contract."""
    for knobs, rows in ((GREEDY, range(0, len(prompts), 2)),
                        (SAMPLED, range(1, len(prompts), 2))):
        rows = list(rows)
        assert_streams_match([got[r] for r in rows], [want[r] for r in rows],
                             jparams, cfg, [prompts[r] for r in rows], what,
                             knobs=knobs, seeds=rows)


@pytest.fixture(scope="module", params=["bf16", "int8"])
def weights(request):
    cfg = dataclasses.replace(PRESETS["tiny"], kv_cache_dtype=request.param)
    tcfg = dataclasses.replace(TPRESETS["tiny"],
                               kv_cache_dtype=request.param)
    jparams, tparams = params_pair(cfg, seed=0)
    return cfg, tcfg, jparams, tparams


@pytest.mark.parametrize("mode", list(MODES))
def test_bucketed_streams_match_jax_engine(weights, mode):
    cfg, tcfg, jparams, tparams = weights
    ecfg = dict(BASE, **MODES[mode])
    prompts = _prompts(cfg, mode)
    passes = 2 if "prefix" in mode else 1
    want = _run_jax(jparams, cfg, ecfg, prompts, passes)
    got, snap = _run_torch(tparams, tcfg, ecfg, prompts, passes)
    for k in range(passes):
        assert all(want[k])
        _assert_match(got[k], want[k], jparams, cfg, prompts,
                      f"{mode}/{cfg.kv_cache_dtype}/pass {k}")
    assert snap["completed"] == passes * len(prompts)
    if "prefix" in mode:
        assert snap["prefix_hits"] >= len(prompts)
    if mode == "dense-prefix":
        assert snap["prefix_seed_copies"] > 0
    if mode == "paged-prefix":
        assert snap["zero_copy_admissions"] >= len(prompts)
    if "chunked" not in mode:
        assert snap["admit_dispatches"] >= 1
        assert snap["cold_admit_dispatches"] <= snap["admit_dispatches"]


@pytest.mark.parametrize("mode", ["dense", "paged-chunked"])
def test_bucketed_streams_equal_the_ragged_engine(weights, mode):
    """Inside the port: the bucketed engine and the ragged wave on the
    kernel leg (its plain version here) give the same streams, and the
    synchronous loop the same as the fetcher thread's."""
    cfg, tcfg, jparams, tparams = weights
    prompts = _prompts(cfg, mode)
    ecfg = dict(BASE, **MODES[mode])
    (bucketed,), _ = _run_torch(tparams, tcfg, ecfg, prompts, 1)
    (sync,), _ = _run_torch(tparams, tcfg, dict(ecfg, async_fetch=False),
                            prompts, 1)
    assert sync == bucketed
    ragged_cfg = dict(BASE, paged_kv=True, chunked_prefill=True,
                      prefill_chunk=16, ragged=True, ragged_kernel="pallas")
    (ragged,), _ = _run_torch(tparams, tcfg, ragged_cfg, prompts, 1)
    _assert_match(ragged, bucketed, jparams, cfg, prompts,
                  f"ragged vs {mode}/{cfg.kv_cache_dtype}")


def test_default_engine_serves():
    """``InferenceEngine(params, cfg, EngineConfig(), device="cpu")``: the
    JAX engine's defaults (the dense slab, 32 slots x 2048 positions)."""
    _, tparams = params_pair(PRESETS["tiny"], seed=0)
    cfg = TPRESETS["tiny"]
    eng = teng.InferenceEngine(tparams, cfg, teng.EngineConfig(),
                               device="cpu")
    assert not eng._paged and not eng._ragged
    assert eng._state["cache"]["k"].shape[1:4] == (32, cfg.n_kv_heads, 2048)
    eng.start()
    try:
        out = eng.generate_blocking(list(range(3, 40)),
                                    SamplingParams(temperature=0.0,
                                                   max_new_tokens=6))
    finally:
        eng.stop()
    assert len(out["token_ids"]) == 6
    assert eng.debug_lifecycle_check() == {}
    assert np.isfinite(out["ttft_ms"])
