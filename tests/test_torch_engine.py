"""seldon_tpu_torch.servers.engine against seldon_tpu.servers.engine.

The same weights and a mixed burst of prompts (several chunks, single
chunk, shorter than a block) through the JAX engine (``ragged=True``,
its masked leg — the reference's bit-exact default) and the port's
engine on its masked and kernel legs (``device="cpu"``; the kernel leg
runs the kernel's plain version there). Greedy streams must be equal;
where one diverges, the reference's top-2 logit gap at that position
must be below RAGGED_LOGITS_ATOL (a near-tie), and it is reported."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu.models.sampling import SamplingParams as JSamplingParams
from seldon_tpu.servers import block_pool as jbp
from seldon_tpu.servers import engine as jeng
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops.ragged_paged_attention import RAGGED_LOGITS_ATOL
from seldon_tpu_torch.servers import block_pool as tbp
from seldon_tpu_torch.servers import engine as teng
from tests.torch_port_helpers import params_pair

ECFG = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32),
            paged_kv=True, kv_block=8,
            kv_pool_blocks=4 * 8 + 1, chunked_prefill=True,
            prefill_chunk=16, prefix_block=8, ragged=True)
LENGTHS = [12, 26, 7, 30, 16, 3]
NEW = 6


def _cfgs(kv_dtype):
    return (dataclasses.replace(PRESETS["tiny"], kv_cache_dtype=kv_dtype),
            dataclasses.replace(TPRESETS["tiny"], kv_cache_dtype=kv_dtype))


def _prompts(cfg):
    rng = np.random.default_rng(29)
    return [rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
            for n in LENGTHS]


def _drain(q):
    toks = []
    while True:
        item = q.get(timeout=120)
        if item is None:
            return toks
        assert "error" not in item, item
        toks.extend(item["tokens"])


def _copying(asarray):
    def copied(x, *args, **kwargs):
        return asarray(x.copy() if isinstance(x, np.ndarray) else x,
                       *args, **kwargs)
    return copied


def _run_jax(params, cfg, prompts):
    """The reference streams. On the CPU ``jnp.asarray`` of a numpy array
    may alias it, and the JAX engine goes on writing its host block table
    while a dispatched wave that reads it may not have run yet; under CPU
    contention the engine then returns other greedy streams than it does
    unloaded (ROADMAP.md C3). It runs here with an ``asarray`` that copies
    numpy input first, which changes no value it computes."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(params, cfg, jeng.EngineConfig(**ECFG))
        eng.start()
        try:
            qs = [eng.submit(p, JSamplingParams(temperature=0.0,
                                                max_new_tokens=NEW, seed=i))
                  for i, p in enumerate(prompts)]
            return [_drain(q) for q in qs]
        finally:
            eng.stop()


def _run_torch(params, cfg, prompts, kernel, async_fetch=True):
    eng = teng.InferenceEngine(
        params, cfg, teng.EngineConfig(**ECFG, ragged_kernel=kernel,
                                       async_fetch=async_fetch),
        device="cpu")
    eng.start()
    try:
        qs = [eng.submit(p, SamplingParams(temperature=0.0,
                                           max_new_tokens=NEW, seed=i))
              for i, p in enumerate(prompts)]
        streams = [_drain(q) for q in qs]
    finally:
        eng.stop()
    assert eng.debug_lifecycle_check() == {}
    return streams, eng


def _assert_streams(got, want, jparams, cfg, prompts, what):
    """Equal streams, or divergence at a near-tie of the reference."""
    for r, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        ctx = jnp.asarray([prompts[r] + w[:i]], jnp.int32)
        logits = np.asarray(jtf.forward(jparams, ctx, cfg)[0, -1],
                            np.float32)
        top2 = np.sort(logits)[-2:]
        gap = float(top2[1] - top2[0])
        assert gap < RAGGED_LOGITS_ATOL, (what, r, i, g, w, gap)
        print(f"near-tie reported: {what} stream {r} token {i} gap {gap}")


@pytest.fixture(scope="module", params=["bf16", "int8"])
def reference(request):
    cfg_j, cfg_t = _cfgs(request.param)
    jparams, tparams = params_pair(cfg_j, seed=0)
    prompts = _prompts(cfg_j)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jparams=jparams, tparams=tparams,
                prompts=prompts, want=_run_jax(jparams, cfg_j, prompts))


@pytest.mark.parametrize("kernel", ["masked", "pallas"])
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
    # The kernel leg skips the prefill leg on decode-only waves.
    if kernel == "pallas":
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
    (dict(ragged_kernel="sparse"), "A1"),
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


def test_cancel_and_deadline_reap_cleanly():
    _, tparams = params_pair(PRESETS["tiny"], seed=0)
    eng = teng.InferenceEngine(tparams, TPRESETS["tiny"],
                               teng.EngineConfig(**ECFG), device="cpu")
    eng.start()
    try:
        prompts = _prompts(PRESETS["tiny"])
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
