"""seldon_tpu_torch.servers.prefix_cache and the ragged engine's prefix
path against the JAX package.

 * The tries: the cases of tests/test_prefix_cache.py as twins over both
   packages, and one seeded sequence of operations (lookups, inserts,
   plans, releases, evictions, flushes) through both packages'
   ``PagedPrefixIndex`` and ``PrefixIndex``: every handle, block list,
   eviction count, ``block_refs`` and snapshot is equal.
 * The engine: the same weights and requests through the JAX ragged
   engine and the port's with ``prefix_cache=True`` (bf16 and int8
   pools): cold then warm, a copy-on-write tail (prefix_block 8 <
   kv_block 16), a shared-prefix burst, and eviction under a small pool.
   Both run their synchronous scheduler loop and each phase's requests
   are queued under the engine's bookkeeping lock, so both schedule the
   same waves; the block table of every wave, the streams, the prefix
   counters and the trie's block refs are equal, and the port's leak
   audit is clean.
 * Inside the port, a warm hit at a prefix that is a multiple of the
   chunk reproduces the cold run's logits bit for bit on the kernel
   leg's plain version.
 * The copy-on-write copy equals the JAX engine's ``_cow_copy_impl`` bit
   for bit, and the copied block's bytes equal its source's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models.config import PRESETS
from seldon_tpu.models.sampling import SamplingParams as JSamplingParams
from seldon_tpu.servers import block_pool as jbp
from seldon_tpu.servers import engine as jeng
from seldon_tpu.servers import prefix_cache as jpc
from seldon_tpu_torch.models import ragged_attention as tra
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import block_pool as tbp
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import prefix_cache as tpc
from seldon_tpu_torch.servers.torchserver import TorchServer
from tests.torch_port_helpers import (_copying, assert_streams_match, bits,
                                      drain, params_pair)

PKGS = {"jax": (jpc, jbp), "torch": (tpc, tbp)}


def _span_fn(pkg):
    """get_span for the dense trie: block KV whose values name the span
    start (k = s, v = s + 100), as the package's own array type."""
    def get_span(s, e, L=2, H=2, D=4):
        k = np.full((L, H, e - s, D), float(s), np.float32)
        v = np.full((L, H, e - s, D), float(s + 100), np.float32)
        if pkg == "jax":
            return {"k": jnp.asarray(k), "v": jnp.asarray(v)}
        return {"k": torch.from_numpy(k), "v": torch.from_numpy(v)}
    return get_span


# ---------------------------------------------------------------------------
# The dense trie: tests/test_prefix_cache.py's cases, twinned
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_trie_lookup_empty(pkg):
    idx = PKGS[pkg][0].PrefixIndex(block=4)
    h = idx.lookup([1, 2, 3, 4, 5])
    assert h.match_len == 0 and h.nodes == []


@pytest.mark.parametrize("pkg", PKGS)
def test_trie_insert_then_lookup_block_aligned(pkg):
    idx = PKGS[pkg][0].PrefixIndex(block=4)
    toks = list(range(10))
    idx.insert(toks, _span_fn(pkg))
    assert idx.n_nodes == 2
    h = idx.lookup(toks)
    assert h.match_len == 8 and len(h.nodes) == 2
    h2 = idx.lookup(toks, max_len=7)
    assert h2.match_len == 4
    h3 = idx.lookup([0, 1, 2, 3, 99, 98, 97, 96])
    assert h3.match_len == 4
    for h_ in (h, h2, h3):
        idx.release(h_)


@pytest.mark.parametrize("pkg", PKGS)
def test_trie_gather_concat_and_pad(pkg):
    idx = PKGS[pkg][0].PrefixIndex(block=4)
    idx.insert(list(range(8)), _span_fn(pkg))
    h = idx.lookup(list(range(8)))
    out = idx.gather(h, pad_to=12)
    assert tuple(out["k"].shape) == (2, 2, 12, 4)
    assert float(out["k"][0, 0, 0, 0]) == 0.0
    assert float(out["k"][0, 0, 4, 0]) == 4.0
    assert float(out["k"][0, 0, 11, 0]) == 0.0
    assert float(out["v"][0, 0, 5, 0]) == 104.0
    idx.release(h)


@pytest.mark.parametrize("pkg", PKGS)
def test_trie_pinned_path_survives_eviction(pkg):
    idx = PKGS[pkg][0].PrefixIndex(block=4, byte_budget=0)
    get_span = _span_fn(pkg)
    toks_a = list(range(8))
    h = idx.lookup(toks_a)
    evicted = idx.insert(toks_a, get_span, handle=h)
    assert evicted == 0 and idx.n_nodes == 2
    evicted2 = idx.insert([50, 51, 52, 53], get_span)
    assert evicted2 >= 1
    h_mid = idx.lookup(toks_a)
    assert h_mid.match_len == 8
    idx.release(h_mid)
    idx.release(h)
    idx.insert([60, 61, 62, 63], get_span)
    assert idx.lookup(toks_a).match_len == 0
    assert idx.evictions >= 3


@pytest.mark.parametrize("pkg", PKGS)
def test_trie_eviction_is_leaf_first(pkg):
    idx = PKGS[pkg][0].PrefixIndex(block=2, byte_budget=1 << 60)
    get_span = _span_fn(pkg)
    idx.insert([1, 2, 3, 4, 5, 6], get_span)
    idx.byte_budget = idx.bytes - 1
    idx.insert([9, 9], get_span)
    h = idx.lookup([1, 2, 3, 4, 5, 6])
    assert 0 < h.match_len < 6
    assert h.match_len % 2 == 0
    idx.release(h)


@pytest.mark.parametrize("pkg", PKGS)
def test_trie_release_idempotent(pkg):
    idx = PKGS[pkg][0].PrefixIndex(block=2)
    idx.insert([1, 2, 3, 4], _span_fn(pkg))
    h = idx.lookup([1, 2, 3, 4])
    assert h.nodes[0].refs == 1
    idx.release(h)
    idx.release(h)
    assert h.nodes[0].refs == 0


@pytest.mark.parametrize("pkg", PKGS)
def test_trie_shared_prefix_dedups_nodes(pkg):
    idx = PKGS[pkg][0].PrefixIndex(block=4)
    get_span = _span_fn(pkg)
    idx.insert(list(range(8)), get_span)
    idx.insert([0, 1, 2, 3, 70, 71, 72, 73], get_span)
    assert idx.n_nodes == 3


# ---------------------------------------------------------------------------
# One seeded sequence of operations through both packages' tries
# ---------------------------------------------------------------------------


def _prompts(rng, n, alphabet=3, max_len=40):
    """Prompts over a tiny alphabet with a shared head, so that paths
    share prefixes and diverge at every depth."""
    head = rng.integers(0, alphabet, size=16).tolist()
    out = []
    for _ in range(n):
        cut = int(rng.integers(0, 17))
        tail = rng.integers(0, alphabet,
                            size=int(rng.integers(1, max_len - cut))).tolist()
        out.append(head[:cut] + tail)
    return out


def _paged_ops(pkg, seed):
    """Drive one package's PagedPrefixIndex as the engine does — lookup
    and pin, plan, take a table of pool blocks, insert over it, drop the
    request's own refs at completion, release — with evict_for under
    pool pressure and a flush at the end. Returns the log."""
    pc, bp = PKGS[pkg]
    rng = np.random.default_rng(seed)
    alloc = bp.BlockAllocator(24)
    idx = pc.PagedPrefixIndex(block=4, kv_block=8, allocator=alloc)
    log, live = [], []
    for toks in _prompts(rng, 40):
        h = idx.lookup(toks, max_len=len(toks) - 1)
        srcs, partial = idx.plan(h)
        log.append(("lookup", h.match_len, [nd.block for nd in h.nodes],
                    srcs, partial))
        need = -(-len(toks) // 8)
        ev = idx.evict_for(need + 2)
        table = alloc.alloc_many(need)
        log.append(("evict_for", need + 2, ev, alloc.free_count,
                    table is None))
        if table is None:
            idx.release(h)
            continue
        idx.insert(toks, lambda j: table[(j * 4) // 8], handle=h)
        live.append((h, table))
        if len(live) > 2 or rng.random() < 0.5:
            h_done, t_done = live.pop(int(rng.integers(0, len(live))))
            idx.release(h_done)
            for bid in t_done:
                alloc.unref(bid)
        log.append(("state", sorted(idx.block_refs().items()),
                    idx.snapshot(), alloc.snapshot()))
    for h, table in live:
        idx.release(h)
        for bid in table:
            alloc.unref(bid)
    log.append(("flush", idx.flush(), idx.snapshot(), alloc.snapshot()))
    idx.clear()
    log.append(("clear", idx.snapshot()))
    return log


def _dense_ops(pkg, seed):
    """The same discipline through the dense PrefixIndex under a byte
    budget: gathers are logged as numpy."""
    pc, _ = PKGS[pkg]
    rng = np.random.default_rng(seed)
    idx = pc.PrefixIndex(block=4, byte_budget=6 * 256)
    get_span = _span_fn(pkg)
    log, live = [], []
    for toks in _prompts(rng, 30):
        h = idx.lookup(toks, max_len=len(toks) - 1)
        entry = ("lookup", h.match_len, len(h.nodes))
        if h.match_len:
            out = idx.gather(h, pad_to=48)
            entry += ({k: np.asarray(v).tolist() for k, v in out.items()},)
        log.append(entry)
        log.append(("insert", idx.insert(toks, get_span, handle=h)))
        live.append(h)
        if len(live) > 2 or rng.random() < 0.5:
            idx.release(live.pop(int(rng.integers(0, len(live)))))
        log.append(("state", idx.snapshot()))
    for h in live:
        idx.release(h)
    log.append(("flush", idx.flush(), idx.snapshot()))
    return log


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_trie_ops_equal_jax(seed):
    want, got = _paged_ops("jax", seed), _paged_ops("torch", seed)
    assert got == want
    # The sequence does what it is meant to exercise.
    kinds = {(e[0], bool(e[2])) for e in want if e[0] == "evict_for"}
    assert ("evict_for", True) in kinds
    assert any(e[0] == "lookup" and e[4] is not None for e in want)
    assert any(e[0] == "lookup" and e[3] for e in want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_trie_ops_equal_jax(seed):
    want, got = _dense_ops("jax", seed), _dense_ops("torch", seed)
    assert got == want
    assert want[-2][1]["evictions"] > 0
    assert any(e[0] == "lookup" and e[1] for e in want)


def _positions(L, H, S, D):
    """A prompt's KV whose values name the token: k = t, v = t + 100
    ([L, H, S, D] f32)."""
    t = torch.arange(S, dtype=torch.float32)[None, None, :, None]
    return {"k": t.expand(L, H, S, D).clone(),
            "v": (t + 100).expand(L, H, S, D).clone()}


@pytest.mark.parametrize("seed", [0, 1])
def test_dense_trie_under_tp_mirrors_tp1(seed):
    """Rank 0's trie of a 2-way group (spans of its one head of two,
    charged at byte_scale 2) takes tp = 1's decisions (matches, bytes,
    evictions) on the same operations, and a worker's KVStore fed its
    puts and drops holds the trie's node ids; a StoreGather resolves on
    either to the tp = 1 gather's heads of that rank."""
    rng = np.random.default_rng(seed)
    ops = []
    full = tpc.PrefixIndex(block=4, byte_budget=6 * 256)
    half = tpc.PrefixIndex(block=4, byte_budget=6 * 256, byte_scale=2,
                           on_drop=lambda ids: ops.extend(
                               ("drop", i) for i in ids))
    store, live = tpc.KVStore(), []
    for toks in _prompts(rng, 30):
        hf = full.lookup(toks, max_len=len(toks) - 1)
        hh = half.lookup(toks, max_len=len(toks) - 1)
        assert (hh.match_len, len(hh.nodes)) == (hf.match_len,
                                                 len(hf.nodes))
        if hh.match_len:
            g = tpc.StoreGather(rows=(tuple(nd.id for nd in hh.nodes),),
                                pad_to=48, stack=False)
            want = full.gather(hf, 48)
            for got in (half.resolve(g), store.resolve(g)):
                for k in want:
                    assert torch.equal(got[k], want[k][:, 1:])
        kv = _positions(2, 2, len(toks), 4)
        writes = {k: v[:, None, 1:] for k, v in kv.items()}  # [L, 1, 1, S, D]
        full.insert(toks, lambda s, e: {k: v[:, :, s:e].clone()
                                        for k, v in kv.items()}, handle=hf)
        half.insert(toks, lambda s, e: {k: v[:, 0, :, s:e].clone()
                                        for k, v in writes.items()},
                    handle=hh,
                    on_new=lambda nid, s, e: ops.append(("put", nid, 0, s, e)))
        store.apply(ops, writes)
        ops.clear()
        assert half.snapshot() == full.snapshot()
        assert store.shapes() == half.spans()
        live.append((hf, hh))
        if len(live) > 2 or rng.random() < 0.5:
            for idx, h in zip((full, half), live.pop(
                    int(rng.integers(0, len(live))))):
                idx.release(h)
    assert full.evictions > 0
    for hf, hh in live:
        full.release(hf)
        half.release(hh)
    assert half.flush() == full.flush() > 0
    store.apply(ops, None)
    assert store.spans == {} and half.spans() == {}


def test_kv_store_refuses_what_it_does_not_hold():
    store = tpc.KVStore()
    writes = _positions(1, 1, 8, 2)
    writes = {k: v[:, None] for k, v in writes.items()}
    with pytest.raises(RuntimeError, match="no family output"):
        store.apply([("put", 0, 0, 0, 4)], None)
    store.apply([("put", 0, 0, 0, 4)], writes)
    with pytest.raises(RuntimeError, match="already held"):
        store.apply([("put", 0, 0, 4, 8)], writes)
    with pytest.raises(RuntimeError, match="not held"):
        store.apply([("drop", 1)], None)
    assert store.shapes() == {0: {"k": (1, 1, 4, 2), "v": (1, 1, 4, 2)}}


def test_paged_trie_rejects_misaligned_blocks():
    for pc, bp in PKGS.values():
        with pytest.raises(ValueError, match="multiple of the prefix"):
            pc.PagedPrefixIndex(block=8, kv_block=12,
                                allocator=bp.BlockAllocator(4))


# ---------------------------------------------------------------------------
# The engine: JAX's ragged engine and the port's, with the prefix cache
# ---------------------------------------------------------------------------

RAGGED = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
              paged_kv=True, chunked_prefill=True, prefill_chunk=8,
              prefix_block=8, kv_block=8, ragged=True, prefix_cache=True,
              async_fetch=False)
# prefix_block 8 < kv_block 16: a match that ends inside a pool block
# copies it (copy-on-write).
COW = dict(RAGGED, kv_block=16, prefill_chunk=16, prompt_buckets=(16, 32))
NEW = 6
COUNTERS = ("prefix_hits", "prefix_tokens_saved", "zero_copy_admissions",
            "cow_copies", "prefix_evictions", "prefix_seed_copies",
            "pool_stalls", "preemptions", "completed", "tokens_out",
            "decode_dispatches")


def _case(name):
    """(engine config, phases of prompts, expected counters). Each phase's
    requests are queued at once; the phases run one after another."""
    rng = np.random.default_rng(11)

    def toks(n):
        return rng.integers(3, 256, size=n).tolist()

    if name == "cold_warm":
        p = toks(20)  # warm: 2 whole blocks of 8 shared
        return RAGGED, [[p], [p]], dict(prefix_hits=1, prefix_tokens_saved=16,
                                        zero_copy_admissions=1, cow_copies=0)
    if name == "cow":
        p = toks(26)  # warm: 24 matched = 1 block of 16 + a copied half
        return COW, [[p], [p]], dict(prefix_hits=1, prefix_tokens_saved=24,
                                     zero_copy_admissions=1, cow_copies=1)
    if name == "burst":
        system = toks(16)
        return RAGGED, [[system + toks(5)],
                        [system + toks(n) for n in (3, 9, 12, 7)]], dict(
            prefix_hits=4, prefix_tokens_saved=64, zero_copy_admissions=4,
            cow_copies=0)
    if name == "evict":
        a, b = toks(16), toks(16)
        # 4 usable blocks: B's reservation evicts A's retained prefix, and
        # A's second visit finds nothing.
        return dict(RAGGED, kv_pool_blocks=5), [[a], [b], [a]], dict(
            prefix_hits=0, prefix_tokens_saved=0, zero_copy_admissions=0)
    raise KeyError(name)


CASES = ("cold_warm", "cow", "burst", "evict")


def _run_phases(eng, phases, sampling, submit):
    """Queue each phase's requests under the engine's bookkeeping lock
    (the scheduler sees all of them in one wave), then wait for them."""
    streams, seed = [], 0
    eng.start()
    try:
        for phase in phases:
            with eng._book:
                qs = []
                for p in phase:
                    qs.append(submit(p, sampling(seed)))
                    seed += 1
            streams.extend(drain(q) for q in qs)
    finally:
        eng.stop()
    return streams


def _run_jax(params, cfg, ecfg, phases):
    tables = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(params, cfg, jeng.EngineConfig(**ecfg))
        wave = eng._jit_ragged

        def recorded(*args, **kwargs):
            tables.append(np.asarray(args[2]).copy())
            return wave(*args, **kwargs)

        eng._jit_ragged = recorded
        streams = _run_phases(
            eng, phases,
            lambda s: JSamplingParams(seed=s, temperature=0.0,
                                      max_new_tokens=NEW),
            eng.submit)
    return dict(streams=streams, tables=tables,
                stats=eng.stats.snapshot(),
                refs=eng._paged_prefix.block_refs(),
                trie=eng._paged_prefix.snapshot(),
                table_host=eng._table_host.copy())


def _run_torch(params, cfg, ecfg, phases, kernel):
    tables = []
    wave = tra.ragged_wave

    def recorded(*args, **kwargs):
        tables.append(args[2].numpy().copy())
        return wave(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tra, "ragged_wave", recorded)
        eng = teng.InferenceEngine(
            params, cfg, teng.EngineConfig(**ecfg, ragged_kernel=kernel),
            device="cpu")
        streams = _run_phases(
            eng, phases,
            lambda s: SamplingParams(seed=s, temperature=0.0,
                                     max_new_tokens=NEW),
            eng.submit)
    out = dict(streams=streams, tables=tables, stats=eng.stats.snapshot(),
               refs=eng._paged_prefix.block_refs(),
               trie=eng._paged_prefix.snapshot(),
               table_host=eng.table_host_snapshot())
    out["leaks"] = eng.debug_lifecycle_check()
    return out


@pytest.fixture(scope="module", params=["bf16", "int8"])
def weights(request):
    cfg_j = dataclasses.replace(PRESETS["tiny"], kv_cache_dtype=request.param)
    cfg_t = dataclasses.replace(TPRESETS["tiny"],
                                kv_cache_dtype=request.param)
    jparams, tparams = params_pair(cfg_j, seed=0)
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, jparams=jparams, tparams=tparams,
                jax={})


@pytest.mark.parametrize("kernel", ["pallas", "masked"])
@pytest.mark.parametrize("case", CASES)
def test_prefix_engine_matches_jax(weights, case, kernel):
    w = weights
    ecfg, phases, expect = _case(case)
    if case not in w["jax"]:
        w["jax"][case] = _run_jax(w["jparams"], w["cfg_j"], ecfg, phases)
    want = w["jax"][case]
    got = _run_torch(w["tparams"], w["cfg_t"], ecfg, phases, kernel)
    prompts = [p for phase in phases for p in phase]
    what = f"{case}/{kernel}/{w['cfg_t'].kv_cache_dtype}"
    assert_streams_match(got["streams"], want["streams"], w["jparams"],
                         w["cfg_j"], prompts, what)
    # The same waves over the same block tables, wave by wave. Tables,
    # refs and the trie follow the prompts and the streams' lengths (all
    # NEW, asserted below), not the sampled ids, so they are held equal
    # even where a near-tie parted a stream.
    assert len(got["tables"]) == len(want["tables"]), what
    for i, (a, b) in enumerate(zip(got["tables"], want["tables"])):
        np.testing.assert_array_equal(a, b, err_msg=f"{what} wave {i}")
    assert got["refs"] == want["refs"], what
    assert got["trie"] == want["trie"], what
    np.testing.assert_array_equal(got["table_host"], want["table_host"])
    for key in COUNTERS:
        assert got["stats"][key] == want["stats"][key], (what, key)
    for key, value in expect.items():
        assert got["stats"][key] == value, (what, key)
    assert got["stats"]["prefix_seed_copies"] == 0
    if case == "evict":
        assert got["stats"]["prefix_evictions"] >= 1
    assert got["leaks"] == {}
    assert all(len(s) == NEW for s in got["streams"])


# ---------------------------------------------------------------------------
# Inside the port: warm logits bit-equal to cold ones
# ---------------------------------------------------------------------------


class _LogitTap:
    """Record the logits row the wave's sampler sees, keyed by (seed,
    position)."""

    def __init__(self, mp):
        self.rows = {}
        orig = tra.sample_per_row

        def tapped(logits, seeds, positions, *rest):
            for i, (sd, ps) in enumerate(zip(seeds.tolist(),
                                             positions.tolist())):
                self.rows[(sd, ps)] = logits[i].clone()
            return orig(logits, seeds, positions, *rest)

        mp.setattr(tra, "sample_per_row", tapped)


@pytest.mark.parametrize("kernel", ["pallas", "sparse"])
@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("split", ["aligned", "cow"])
def test_warm_logits_against_cold(split, kv, kernel):
    """aligned: a prefix of 16 tokens, a multiple of the chunk (8): the
    warm request's first chunk starts where the cold run's third does,
    every row splits pool and fresh columns at the same place, and the
    logits of every sampled position are bit-equal. cow: a 24-token match
    under kv_block 16 ends inside a pool block, which the warm admission
    copies; its chunks split elsewhere than the cold run's, so its logits
    are held to RAGGED_LOGITS_ATOL (a copy that missed would leave the
    block's 8 matched positions at zero)."""
    from seldon_tpu_torch.ops.ragged_paged_attention import (
        RAGGED_LOGITS_ATOL)

    cfg_j = dataclasses.replace(PRESETS["tiny"], kv_cache_dtype=kv)
    cfg = dataclasses.replace(TPRESETS["tiny"], kv_cache_dtype=kv)
    _, params = params_pair(cfg_j, seed=3)
    rng = np.random.default_rng(5)
    n_sys, base = (16, RAGGED) if split == "aligned" else (24, COW)
    system = rng.integers(3, 256, size=n_sys).tolist()
    prime = system + rng.integers(3, 256, size=5).tolist()
    target = system + rng.integers(3, 256, size=7).tolist()
    greedy = dict(temperature=0.0, max_new_tokens=NEW)

    def serve(prefix_cache, prompts, seeds):
        ecfg = dict(base, prefix_cache=prefix_cache, async_fetch=True,
                    ragged_kernel=kernel)
        with pytest.MonkeyPatch.context() as mp:
            tap = _LogitTap(mp)
            eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(**ecfg),
                                       device="cpu")
            eng.warmup()
            eng.start()
            try:
                out = [eng.generate_blocking(p, SamplingParams(
                    seed=sd, **greedy))["token_ids"]
                    for p, sd in zip(prompts, seeds)]
            finally:
                eng.stop()
        assert eng.debug_lifecycle_check() == {}
        return out, tap.rows, eng.stats.snapshot()

    cold, cold_rows, _ = serve(False, [target], [8])
    warm, warm_rows, snap = serve(True, [prime, target], [7, 8])
    assert snap["prefix_hits"] == 1 and snap["prefix_tokens_saved"] == n_sys
    assert snap["cow_copies"] == (split == "cow")
    keys = [(8, len(target) + j) for j in range(len(cold[0]))]
    if split == "aligned":
        assert warm[1] == cold[0]
        for key in keys:
            assert torch.equal(warm_rows[key], cold_rows[key]), key
        return
    k = next((j for j, (a, b) in enumerate(zip(warm[1], cold[0]))
              if a != b), len(keys) - 1)
    for key in keys[:k + 1]:  # positions that share their context
        diff = float((warm_rows[key] - cold_rows[key]).abs().max())
        assert diff < RAGGED_LOGITS_ATOL, (key, diff)


# ---------------------------------------------------------------------------
# Copy-on-write: the port's copy against JAX's
# ---------------------------------------------------------------------------


def _pool(kv, seed, L=2, NB=6, H=2, blk=8, D=4):
    rng = np.random.default_rng(seed)
    shape = (L, NB, H, blk, D)
    if kv == "int8":
        pool = {"k": rng.integers(-127, 128, shape, dtype=np.int8),
                "v": rng.integers(-127, 128, shape, dtype=np.int8),
                "k_scale": rng.standard_normal(shape[:-1]).astype(np.float32),
                "v_scale": rng.standard_normal(shape[:-1]).astype(np.float32)}
    else:
        pool = {"k": rng.standard_normal(shape).astype(np.float32),
                "v": rng.standard_normal(shape).astype(np.float32)}
    j = {k: (jnp.asarray(a, jnp.bfloat16) if a.dtype == np.float32
             else jnp.asarray(a)) for k, a in pool.items()}
    t = {k: (torch.from_numpy(np.asarray(v).view(np.int16).copy()).view(
        torch.bfloat16) if v.dtype == jnp.bfloat16
        else torch.from_numpy(np.asarray(v).copy())) for k, v in j.items()}
    return j, t


@pytest.mark.parametrize("src,dst", [(3, 5), (5, 1), (2, 2), (0, 4)])
@pytest.mark.parametrize("kv", ["int8", "bf16"])
def test_cow_copy_equals_jax(kv, src, dst):
    jpool, tpool = _pool(kv, seed=src * 10 + dst)
    before = {k: bits(v) if v.dtype == torch.bfloat16 else v.numpy().copy()
              for k, v in tpool.items()}
    want = jeng.InferenceEngine._cow_copy_impl(
        {"cache": jpool}, jnp.int32(src), jnp.int32(dst))["cache"]
    state = {"cache": tpool}
    got = teng.InferenceEngine._cow_copy_impl(state, src, dst)["cache"]
    assert got is tpool  # in place
    for key in tpool:
        g = bits(got[key]) if got[key].dtype == torch.bfloat16 \
            else got[key].numpy()
        w = bits(want[key]) if want[key].dtype == jnp.bfloat16 \
            else np.asarray(want[key])
        np.testing.assert_array_equal(g, w, err_msg=key)
        # The copied block carries its source's bytes; no other moves.
        np.testing.assert_array_equal(g[:, dst], before[key][:, src])
        others = [b for b in range(g.shape[1]) if b != dst]
        np.testing.assert_array_equal(g[:, others], before[key][:, others])


# ---------------------------------------------------------------------------
# The server's switch
# ---------------------------------------------------------------------------


def test_torchserver_prefix_cache_env(monkeypatch):
    monkeypatch.setenv("PREFIX_CACHE", "1")
    srv = TorchServer(preset="tiny", max_slots=4, max_seq_len=128,
                      prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                      warmup=1, device="cpu")
    prompt = list(np.random.default_rng(2).integers(3, 256, size=40))
    req = {"prompt_token_ids": [int(t) for t in prompt],
           "max_new_tokens": 5, "temperature": 0.0}
    try:
        a = srv.generate(req)
        b = srv.generate(req)
        keys = {m["key"]: m["value"] for m in srv.metrics()}
    finally:
        srv.stop()
    assert srv.engine.ecfg.prefix_cache
    assert a["token_ids"] == b["token_ids"]
    assert keys["torchserver_prefix_hits"] == 1.0
    assert keys["torchserver_prefix_tokens_saved"] == 32.0
    assert keys["torchserver_zero_copy_admissions"] == 1.0
    assert srv.engine.debug_lifecycle_check() == {}
