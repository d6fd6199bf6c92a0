"""seldon_tpu_torch.servers.engine against seldon_tpu.servers.engine.

The same weights and a mixed burst of prompts (several chunks, single
chunk, shorter than a block) through the JAX engine (``ragged=True``,
its masked leg — the reference's bit-exact default) and the port's
engine on its masked, sparse and kernel legs (``device="cpu"``; the
kernel leg runs the kernel's plain version there). Greedy streams must
be equal; where one diverges, the reference's top-2 logit gap at that
position must be below RAGGED_LOGITS_ATOL (a near-tie), and it is
reported. Inside the port the sparse leg's streams equal the masked
leg's exactly."""

import dataclasses

import numpy as np
import pytest
import torch

from seldon_tpu.models.config import PRESETS
from seldon_tpu.servers import block_pool as jbp
from seldon_tpu.servers import engine as jeng
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import block_pool as tbp
from seldon_tpu_torch.servers import engine as teng
from tests.torch_port_helpers import (ENGINE_ECFG as ECFG,
                                      ENGINE_LENGTHS as LENGTHS,
                                      assert_streams_match, engine_prompts,
                                      params_pair, run_jax_engine,
                                      run_torch_engine)

NEW = 6
GREEDY = dict(temperature=0.0, max_new_tokens=NEW)


def _cfgs(kv_dtype):
    return (dataclasses.replace(PRESETS["tiny"], kv_cache_dtype=kv_dtype),
            dataclasses.replace(TPRESETS["tiny"], kv_cache_dtype=kv_dtype))


def _run_jax(params, cfg, prompts, **ecfg):
    """The reference streams (the JAX engine with a copying
    ``jnp.asarray``: on the CPU ``jnp.asarray`` may alias the engine's
    live host block table, ROADMAP.md C3)."""
    return run_jax_engine(params, cfg, prompts, GREEDY, dict(ECFG, **ecfg))


def _run_torch(params, cfg, prompts, kernel, async_fetch=True, **ecfg):
    return run_torch_engine(params, cfg, prompts, GREEDY, kernel,
                            dict(ECFG, **ecfg), async_fetch=async_fetch)


def _assert_streams(got, want, jparams, cfg, prompts, what):
    """Equal streams, or divergence at a near-tie of the reference."""
    assert_streams_match(got, want, jparams, cfg, prompts, what)


@pytest.fixture(scope="module", params=["bf16", "int8"])
def reference(request):
    cfg_j, cfg_t = _cfgs(request.param)
    jparams, tparams = params_pair(cfg_j, seed=0)
    prompts = engine_prompts(cfg_j)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jparams=jparams, tparams=tparams,
                prompts=prompts, want=_run_jax(jparams, cfg_j, prompts))


@pytest.mark.parametrize("kernel", ["masked", "pallas", "sparse"])
def test_greedy_streams_match_jax_engine(reference, kernel):
    """The default scheduler loop, with the fetcher thread (async_fetch)."""
    r = reference
    got, eng = _run_torch(r["tparams"], r["cfg_t"], r["prompts"], kernel)
    assert all(len(s) == NEW for s in r["want"])
    _assert_streams(got, r["want"], r["jparams"], r["cfg_j"], r["prompts"],
                    f"{kernel}/{r['cfg_t'].kv_cache_dtype}")
    snap = eng.stats.snapshot()
    assert snap["completed"] == len(LENGTHS)
    assert snap["tokens_out"] == NEW * len(LENGTHS)
    # The kernel and sparse legs skip the prefill leg on decode-only waves.
    if kernel != "masked":
        assert snap["prefill_waves"] < snap["decode_dispatches"]
    else:
        assert snap["prefill_waves"] == snap["decode_dispatches"]


def test_sync_loop_streams_match_jax_engine(reference):
    """async_fetch=False: the scheduler reads wave N after dispatching
    wave N+1 (_loop_sync_ragged)."""
    r = reference
    got, eng = _run_torch(r["tparams"], r["cfg_t"], r["prompts"], "pallas",
                          async_fetch=False)
    assert eng._fetcher is None
    _assert_streams(got, r["want"], r["jparams"], r["cfg_j"], r["prompts"],
                    f"sync/{r['cfg_t'].kv_cache_dtype}")
    assert eng.stats.snapshot()["tokens_out"] == NEW * len(LENGTHS)


def test_engine_config_fields_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jeng.EngineConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(teng.EngineConfig)}
    assert tf == jf
    for bad in (dict(ragged=True), dict(max_admit=3),
                dict(ragged_kernel="flash"), dict(paged_kv=True, kv_block=3)):
        with pytest.raises(ValueError):
            jeng.EngineConfig(**bad)
        with pytest.raises(ValueError):
            teng.EngineConfig(**bad)


@pytest.mark.parametrize("opts,item", [
    (dict(ragged=False), "A7"),
    (dict(prefix_cache=True), "A5"),
    (dict(tp=2), "A11"),
    (dict(heal=True), "A10"),
    (dict(max_admit=2), "A7"),
    (dict(decode_chunk=4), "A7"),
    (dict(min_chunk=2), "A7"),
    (dict(adaptive_chunk=False), "A7"),
])
def test_unported_options_raise(opts, item):
    _, tparams = params_pair(PRESETS["tiny"], seed=0)
    kw = dict(ECFG, **opts)
    if not kw["ragged"]:
        kw.update(ragged=False)
    with pytest.raises(NotImplementedError, match=item):
        teng.InferenceEngine(tparams, TPRESETS["tiny"],
                             teng.EngineConfig(**kw), device="cpu")


def test_sparse_streams_equal_the_masked_leg_exactly(reference):
    """Inside the port the masked-matched walk gives the masked leg's
    greedy streams token for token, both scheduler loops."""
    r = reference
    masked, _ = _run_torch(r["tparams"], r["cfg_t"], r["prompts"], "masked")
    for async_fetch in (True, False):
        got, _ = _run_torch(r["tparams"], r["cfg_t"], r["prompts"],
                            "sparse", async_fetch=async_fetch)
        assert got == masked


def test_sparse_leg_with_a_block_budget_matches_jax_engine():
    """``ragged_block_budget`` with the sparse leg: waves over the budget
    run the masked head, as in the JAX engine with the same budget."""
    cfg_j, cfg_t = _cfgs("bf16")
    jparams, tparams = params_pair(cfg_j, seed=0)
    prompts = engine_prompts(cfg_j)
    want = _run_jax(jparams, cfg_j, prompts, ragged_kernel="sparse",
                    ragged_block_budget=2)
    got, _ = _run_torch(tparams, cfg_t, prompts, "sparse",
                        ragged_block_budget=2)
    _assert_streams(got, want, jparams, cfg_j, prompts, "sparse/budget")


@pytest.mark.parametrize("kernel,refused", [("sparse", False),
                                            ("pallas", True)])
def test_block_budget_validation_on_the_card(monkeypatch, kernel, refused):
    """An engine on a CUDA device takes a budget with the sparse leg and
    refuses it with the kernel leg (checked before the weights' device,
    so no card is needed: the sparse engine then stops at the CPU
    weights)."""
    _, tparams = params_pair(PRESETS["tiny"], seed=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    ecfg = teng.EngineConfig(**ECFG, ragged_kernel=kernel,
                             ragged_block_budget=4)
    want = NotImplementedError if refused else ValueError
    match = "B1" if refused else "params live on"
    with pytest.raises(want, match=match):
        teng.InferenceEngine(tparams, TPRESETS["tiny"], ecfg,
                             device="cuda:0")


def test_cancel_and_deadline_reap_cleanly():
    _, tparams = params_pair(PRESETS["tiny"], seed=0)
    eng = teng.InferenceEngine(tparams, TPRESETS["tiny"],
                               teng.EngineConfig(**ECFG), device="cpu")
    eng.start()
    try:
        prompts = engine_prompts(PRESETS["tiny"])
        long_q = eng.submit(prompts[1], SamplingParams(
            temperature=0.0, max_new_tokens=30))
        late = eng.submit(prompts[0], SamplingParams(
            temperature=0.0, max_new_tokens=30, deadline_ms=1))
        assert eng.cancel(long_q.rid)
        items = {"long": [], "late": []}
        for name, q in (("long", long_q), ("late", late)):
            while True:
                item = q.get(timeout=60)
                if item is None:
                    break
                items[name].append(item)
        kinds = {n: [i.get("kind") for i in v if "error" in i]
                 for n, v in items.items()}
        assert kinds == {"long": ["cancelled"], "late": ["deadline"]}
        ok = eng.generate_blocking(prompts[2], SamplingParams(
            temperature=0.0, max_new_tokens=4))
        assert len(ok["token_ids"]) == 4
    finally:
        eng.stop()
    assert eng.debug_lifecycle_check() == {}
    snap = eng.stats.snapshot()
    assert snap["cancelled_total"] == 1
    assert snap["deadline_expired_total"] == 1


def test_block_allocator_copy_matches_jax():
    rng = np.random.default_rng(0)
    a, b = jbp.BlockAllocator(9), tbp.BlockAllocator(9)
    held = []
    for _ in range(200):
        op = rng.integers(0, 3)
        if op == 0:
            got = (a.alloc(), b.alloc())
            assert got[0] == got[1]
            if got[0] is not None:
                held.append(got[0])
        elif op == 1 and held:
            bid = held[rng.integers(0, len(held))]
            a.ref(bid)
            b.ref(bid)
            held.append(bid)
        elif held:
            bid = held.pop(rng.integers(0, len(held)))
            a.unref(bid)
            b.unref(bid)
        assert a.snapshot() == b.snapshot()
    with pytest.raises(RuntimeError):
        b.unref(0)


def test_submit_validates_like_jax():
    _, tparams = params_pair(PRESETS["tiny"], seed=0)
    eng = teng.InferenceEngine(tparams, TPRESETS["tiny"],
                               teng.EngineConfig(**ECFG), device="cpu")
    with pytest.raises(ValueError, match="empty"):
        eng.submit([])
    with pytest.raises(ValueError, match="max bucket"):
        eng.submit([5] * 40)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.submit([5] * 30, SamplingParams(max_new_tokens=40))
    with pytest.raises(ValueError, match="token ids"):
        eng.submit([5, 999])
    eng.stop()
    with pytest.raises(teng.EngineDraining):
        eng.submit([5], SamplingParams(max_new_tokens=4))
