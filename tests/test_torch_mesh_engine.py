"""Exact tensor parallelism on two gloo CPU ranks (``servers/mesh_engine``,
``models/tp_sharding``, the engine's tp threading), held bit for bit to
the port's tp=1 engine and, on one fixed schedule, to the JAX engine.

Every case of the file runs on ONE spawned group (a module-scoped
fixture: spawning a rank costs seconds): rank 0 is this process, rank 1
a worker. The JAX package's cases (``tests/test_mesh_engine.py``: its
MODES, PROMPTS and GEOM) in the port's form:
 * greedy tp=2 streams AND the logits of every wave bit-equal to tp=1's
   across dense, paged, chunked, ragged (its masked and sparse legs) and
   spec (its masked and kernel verify legs), on a fixed schedule
   (every request queued before ``start()``, the synchronous loop);
 * the same for int8 KV on ragged, W8A8 on dense, the W8A8 128 bucket,
   float32 models (f32 or int8 KV) on dense, ragged and spec, and
   sampled streams; every worker's per-slot state (its sampled
   tokens included) equal to rank 0's after each run;
 * the refusals: validate, flash or ring under tp, tp disagreement,
   EngineConfig(tp=0), and tp beyond the budget with no device list;
 * one sealed lattice with zero live retraces, /debug/hbm per device,
   mesh_info and the roof per chip; a healed dispatch fault whose
   rebuild and replays reach the worker;
 * tp=2 streams equal to the JAX engine's tp=1 on one fixed schedule,
   under the near-tie rule (the JAX tp=2 engine is not an oracle:
   ROADMAP.md, "Oracle hazard");
 * the dense engine's prefix cache under tp (bucketed and chunked): tp=2
   streams, every wave's logits, hits, tokens saved and evictions equal
   to tp=1's under a byte budget that evicts, every worker's prefix
   store equal to rank 0's trie (``check_replicas``), a store that
   drifts raising, and the port's tp=1 against the JAX engine's tp=1 on
   the same fixed schedule;
 * the GEMM settings: the worker's report at spawn, and a worker whose
   settings differ from rank 0's making ``MeshEngine`` raise;
 * a killed worker fails requests with an error, within the group's
   timeout (last: it ends the group)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from seldon_tpu.models.config import get_config as jget_config
from seldon_tpu.models.sampling import SamplingParams as JSamplingParams
from seldon_tpu.servers import engine as jeng
from seldon_tpu_torch import device as tdevice
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.quantize import quantize_params
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import mesh_engine
from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine
from torch_port_helpers import (_copying, assert_streams_match, bits, drain,
                                one_intra_op_thread, params_pair,
                                run_jax_engine)

GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
SAMPLED = SamplingParams(temperature=0.9, top_k=8, top_p=0.95,
                         max_new_tokens=8, seed=7)
# Mixed lengths: admission groups carry real bucket + group padding.
PROMPTS = [list(range(2, 2 + n)) for n in (5, 12, 24, 7)]

GEOM = dict(max_slots=4, max_seq_len=64)
MODES = {
    "dense": {},
    "paged": dict(paged_kv=True, kv_block=16, kv_pool_blocks=12,
                  prompt_buckets=(16, 32)),
    "chunked": dict(chunked_prefill=True, prefill_chunk=8, prefix_block=8),
    "ragged": dict(paged_kv=True, chunked_prefill=True, prefill_chunk=8,
                   prefix_block=8, kv_block=8, ragged=True),
    "spec": dict(spec_decode=True, spec_k=2, paged_kv=True, kv_block=8,
                 prefix_block=8),
}
# The sparse ragged leg, and the spec engine's kernel verify leg (B1's
# plain version on the CPU).
MODES["ragged-sparse"] = dict(MODES["ragged"], ragged_kernel="sparse")
MODES["spec-kernel"] = dict(MODES["spec"], ragged_kernel="pallas")
BIG = dict(max_slots=4, max_seq_len=128, prompt_buckets=(32, 128),
           paged_kv=True, kv_block=16, kv_pool_blocks=33,
           chunked_prefill=True, prefill_chunk=32, prefix_block=16,
           ragged=True)
TIMEOUT_S = 60.0
# The dense prefix cache: prompts behind one 32-token head (4 blocks of
# 8), three times as many requests as slots, so later admissions hit the
# trie and find unpinned nodes to evict; the
# budget holds 6 of tiny's 8-token spans (2 layers x 2 KV heads x 16 x
# bf16, k and v: 2048 B), so insertions evict.
PREFIX_HEAD = list(range(40, 72))
PREFIX_GEOM = dict(max_slots=2, max_seq_len=64)
PREFIX_PROMPTS = [PREFIX_HEAD + list(range(100 + 16 * i, 100 + 16 * i + n))
                  for i, n in enumerate((13, 20, 11, 17, 22, 15))]
DENSE_PREFIX = {
    "bucketed": dict(prefix_cache=True, prefix_block=8,
                     prefix_cache_bytes=6 * 2048, max_admit=2,
                     prompt_buckets=(32, 64)),
    "chunked": dict(prefix_cache=True, prefix_block=8,
                    prefix_cache_bytes=6 * 2048, chunked_prefill=True,
                    prefill_chunk=8, prompt_buckets=(32, 64)),
}
PREFIX_STATS = ("prefix_hits", "prefix_tokens_saved", "prefix_evictions",
                "prefix_seed_copies")


@pytest.fixture(scope="module")
def group():
    """Two CPU ranks over gloo: this process and one spawned worker."""
    with pytest.MonkeyPatch.context() as mp:
        # The worker's intra-op pool, as one_intra_op_thread sets rank 0's.
        mp.setenv("OMP_NUM_THREADS", "1")
        g = mesh_engine.spawn_group(
            mesh_engine.build_tp_mesh(2, ["cpu", "cpu"]), TIMEOUT_S)
    yield g
    g.close()


def _params(cfg, seed=0):
    params = transformer.init_params(cfg, torch.Generator().manual_seed(seed),
                                     "cpu")
    if cfg.weight_dtype == "int8":
        params = quantize_params(params)
    return params


def _run(params, cfg, tp, group=None, sp=GREEDY, prompts=PROMPTS,
         geom=GEOM, snaps=None, **ekw):
    """(streams, the logits of every wave in dispatch order) of
    ``prompts`` on a fixed schedule: every request queued before start(),
    the synchronous loop. ``snaps`` (a list) gets the engine's stats."""
    ekw = dict(geom, async_fetch=False, **ekw)
    ekw.setdefault("prompt_buckets", (8, 32))
    rows = []
    logits_fn = transformer._logits

    def tap(*a, **k):
        out = logits_fn(*a, **k)
        rows.append(out.detach().clone())
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "_logits", tap)
        if tp > 1:
            eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**ekw),
                                         tp=tp, group=group)
        else:
            eng = InferenceEngine(params, cfg, EngineConfig(**ekw),
                                  device="cpu")
        qs = [eng.submit(p, sp) for p in prompts]
        eng.start()
        try:
            outs = [drain(q) for q in qs]
            if tp > 1:
                eng.check_replicas()
        finally:
            eng.stop()
    assert eng.debug_lifecycle_check() == {}
    if snaps is not None:
        snaps.append(eng.stats.snapshot())
    return outs, rows


def _assert_same(want, got, what):
    (ws, wl), (gs, gl) = want, got
    assert gs == ws, f"tp=2 streams diverged from tp=1 under {what}"
    assert all(len(t) > 0 for t in ws)
    assert len(gl) == len(wl), what
    for i, (a, b) in enumerate(zip(wl, gl)):
        assert a.shape == b.shape, (what, i)
        assert torch.equal(a, b), f"{what}: wave {i} logits differ"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_greedy_bit_identical_tp2_vs_tp1(group, mode):
    cfg = get_config("tiny")
    params = _params(cfg)
    _assert_same(_run(params, cfg, 1, **MODES[mode]),
                 _run(params, cfg, 2, group, **MODES[mode]), mode)


def test_greedy_bit_identical_int8_kv_ragged(group):
    cfg = dataclasses.replace(get_config("tiny"), kv_cache_dtype="int8")
    params = _params(cfg)
    _assert_same(_run(params, cfg, 1, **MODES["ragged"]),
                 _run(params, cfg, 2, group, **MODES["ragged"]),
                 "int8 KV")


def test_greedy_bit_identical_w8a8_dense(group):
    # Sharded int8 weights carry per-output-channel scales that ride
    # their output slice; the per-token activation scale is a max over
    # the unsharded feature axis.
    cfg = dataclasses.replace(get_config("tiny"), weight_dtype="int8",
                              act_dtype="int8")
    params = _params(cfg)
    _assert_same(_run(params, cfg, 1), _run(params, cfg, 2, group), "W8A8")


def test_greedy_bit_identical_w8a8_big_bucket(group):
    # The JAX regression geometry (its 128-bucket W8A8 drift): int8 KV,
    # W8A8, the 128 bucket, 16 new tokens.
    cfg = dataclasses.replace(get_config("tiny"), weight_dtype="int8",
                              act_dtype="int8", kv_cache_dtype="int8")
    params = _params(cfg)
    prompts = [list(range(2, 2 + n)) for n in (24, 48, 96, 16)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=16)
    _assert_same(_run(params, cfg, 1, sp=sp, prompts=prompts, geom=BIG),
                 _run(params, cfg, 2, group, sp=sp, prompts=prompts,
                      geom=BIG), "W8A8 at the 128 bucket")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["dense", "ragged", "spec"])
def test_greedy_bit_identical_f32_tp2_vs_tp1(group, mode, kv):
    """A float32 model (f32 or int8 KV): tp=2 streams and every wave's
    logits bit-equal to tp=1's, its f32 shards sent to the worker."""
    cfg = dataclasses.replace(get_config("tiny"), dtype="float32",
                              kv_cache_dtype=kv)
    params = _params(cfg)
    assert params.blocks[0].wq.dtype == torch.float32
    _assert_same(_run(params, cfg, 1, **MODES[mode]),
                 _run(params, cfg, 2, group, **MODES[mode]),
                 f"f32/{mode}/{kv}")


def test_sampled_bit_identical_tp2_vs_tp1(group):
    # Logits replicate across the group, so the seeded sampler draws the
    # same tokens on every rank (check_replicas) and as tp=1.
    cfg = get_config("tiny")
    params = _params(cfg)
    _assert_same(_run(params, cfg, 1, sp=SAMPLED),
                 _run(params, cfg, 2, group, sp=SAMPLED), "sampled")


def test_validate_and_refusals(group, monkeypatch):
    cfg = get_config("tiny")
    params = _params(cfg)
    for tp in (3, 4):
        with pytest.raises(ValueError, match="n_kv_heads"):
            mesh_engine.MeshEngine(params, cfg, EngineConfig(**GEOM), tp=tp,
                                   group=group)
    for impl in ("flash", "ring"):
        bad = dataclasses.replace(cfg, attn_impl=impl)
        with pytest.raises(ValueError, match="not supported"):
            mesh_engine.MeshEngine(params, bad, EngineConfig(tp=2, **GEOM),
                                   tp=2, group=group)
    with pytest.raises(ValueError, match="disagrees"):
        mesh_engine.MeshEngine(params, cfg, EngineConfig(tp=2, **GEOM),
                               tp=4, group=group)
    for tp in (0, -2):
        with pytest.raises(ValueError):
            EngineConfig(tp=tp, **GEOM)
    # No device list and no card: the budget refuses before any rank
    # starts.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValueError, match="MESH_DEVICES"):
        mesh_engine.MeshEngine(params, cfg, EngineConfig(**GEOM), tp=2)
    # The group still serves after every refusal.
    assert _run(params, cfg, 2, group)[0] == _run(params, cfg, 1)[0]


def test_tp_group_seals_one_lattice_zero_retraces(group, monkeypatch):
    monkeypatch.setenv("COMPILE_LEDGER", "1")
    cfg = get_config("tiny")
    eng = mesh_engine.MeshEngine(
        _params(cfg), cfg, EngineConfig(prompt_buckets=(8, 32), **GEOM),
        tp=2, group=group)
    eng.warmup()
    eng.start()
    try:
        for q in [eng.submit(p, GREEDY) for p in PROMPTS]:
            drain(q)
        snap = eng.debug_compile()
    finally:
        eng.stop()
    assert snap["tp"] == 2 and snap["mesh_devices"] == 2
    assert snap["warmup_complete"] is True
    assert snap["live_retrace_count"] == 0, snap["live_retraces"]
    assert snap["declared_variants"] >= snap["dispatched_variants"]


def test_hbm_reports_per_device_bytes_and_mesh_info(group, monkeypatch):
    monkeypatch.setenv("HBM_LEDGER", "1")
    cfg = get_config("tiny")
    params = _params(cfg)
    ekw = dict(prompt_buckets=(8, 32), **GEOM)
    ref = InferenceEngine(params, cfg, EngineConfig(**ekw), device="cpu")
    try:
        ref_snap = ref.debug_hbm()
    finally:
        ref.stop()
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**ekw), tp=2,
                                 group=group)
    try:
        snap = eng.debug_hbm()
        info = eng.mesh_info()
    finally:
        eng.stop()
    ref_w = ref_snap["categories"]["weights"]["bytes"]
    assert snap["devices"] == 2
    w = snap["categories"]["weights"]
    assert w["bytes"] == 2 * w["bytes_per_device"]
    assert ref_w // 2 < w["bytes_per_device"] < ref_w
    # Replicated leaves whole, sharded ones halved: the exact split.
    sharded = sum(getattr(bp, n).numel() * getattr(bp, n).element_size()
                  for bp in params.blocks
                  for n in ("wq", "wk", "wv", "w_gate", "w_up"))
    assert w["bytes_per_device"] == ref_w - sharded // 2
    kv, ref_kv = snap["categories"]["kv_cache"], \
        ref_snap["categories"]["kv_cache"]
    assert kv["bytes"] == ref_kv["bytes"]
    assert kv["bytes_per_device"] == kv["bytes"] // 2
    assert snap["total_bytes_per_device"] < snap["total_bytes"]
    assert info["tp"] == 2 and info["axis"] == "tp"
    assert info["devices"] == ["cpu", "cpu"] and info["route"] == "gloo"
    assert info["weight_bytes_per_device"] == w["bytes_per_device"]


def test_roof_prices_per_chip_under_tp(group, monkeypatch):
    monkeypatch.setenv("ROOF_LEDGER", "1")
    cfg = get_config("tiny")
    eng = mesh_engine.MeshEngine(
        _params(cfg), cfg, EngineConfig(prompt_buckets=(8, 32), **GEOM),
        tp=2, group=group)
    eng.start()
    try:
        for q in [eng.submit(p, GREEDY) for p in PROMPTS]:
            drain(q)
        snap = eng.debug_roof()
    finally:
        eng.stop()
    assert snap["tp"] == 2
    assert snap["boundaries"] > 0
    assert snap["conservation"]["breaches"] == 0


def test_tp2_streams_match_jax_engine_tp1(group):
    """The port's tp=2 against the JAX engine's tp=1 on one fixed
    schedule (the JAX weights converted), under the near-tie rule."""
    jcfg = jget_config("tiny")
    jparams, tparams = params_pair(jcfg, seed=0)
    ecfg = dict(GEOM, **MODES["ragged"], prompt_buckets=(8, 32),
                async_fetch=False)
    want = run_jax_engine(jparams, jcfg, PROMPTS, {"temperature": 0.0,
                                                   "max_new_tokens": 8},
                          ecfg=ecfg)
    got, _ = _run(tparams, get_config("tiny"), 2, group,
                  sp=SamplingParams(temperature=0.0, max_new_tokens=8,
                                    seed=0), **MODES["ragged"])
    # run_jax_engine seeds request i with i; greedy ignores the seed.
    assert_streams_match(got, want, jparams, jcfg, PROMPTS, "tp2-vs-jax")


def test_ranks_hold_their_shards(group):
    """The worker's weights are rank 1's cut of the model, bit for bit,
    and its KV pool carries Hkv / 2 heads."""
    cfg = get_config("tiny")
    params = _params(cfg)
    eng = mesh_engine.MeshEngine(params, cfg,
                                 EngineConfig(**GEOM, **MODES["ragged"]),
                                 tp=2, group=group)
    try:
        got = group.run(f"{__name__}:_worker_leaves")[0]
        hkv = cfg.n_kv_heads // 2
        assert got["pool_heads"] == hkv
        assert eng._state["cache"]["k"].shape[2] == hkv
        F, W = cfg.d_ff, cfg.n_heads * cfg.head_dim
        for i, bp in enumerate(params.blocks):
            np.testing.assert_array_equal(got["wq"][i],
                                          bits(bp.wq[:, W // 2:]))
            np.testing.assert_array_equal(got["w_up"][i],
                                          bits(bp.w_up[:, F // 2:]))
            np.testing.assert_array_equal(got["wo"][i], bits(bp.wo))
    finally:
        eng.stop()


def _worker_leaves(worker):
    """Run on the worker: its sharded and replicated leaves' bits."""
    return {
        "pool_heads": worker.state["cache"]["k"].shape[2],
        **{n: [bits(getattr(bp, n)) for bp in worker.params.blocks]
           for n in ("wq", "w_up", "wo")},
    }


def test_heal_rebuild_goes_through_the_group(group):
    """A dispatch fault under supervised recovery at tp = 2: the rebuild
    of the device state and the replays reach the worker too, so the
    healed streams equal tp = 1's clean ones and every worker's slot
    state equals rank 0's afterwards."""
    from seldon_tpu_torch.servers.chaos import ChaosConfig, ChaosMonkey

    cfg = get_config("tiny")
    params = _params(cfg)
    want, _ = _run(params, cfg, 1, **MODES["ragged"])
    eng = mesh_engine.MeshEngine(
        params, cfg, EngineConfig(**GEOM, **MODES["ragged"], heal=True,
                                  prompt_buckets=(8, 32), async_fetch=False),
        tp=2, group=group)
    mk = ChaosMonkey(ChaosConfig(seed=0, dispatch_fail=1.0))
    orig, calls = mk.on_dispatch, []

    def fifth(*args):  # one fault, at the fifth dispatch
        calls.append(args)
        if len(calls) == 5:
            eng._chaos = None
            return orig(*args)

    mk.on_dispatch = fifth
    eng._chaos = mk
    qs = [eng.submit(p, GREEDY) for p in PROMPTS]
    eng.start()
    try:
        got = [drain(q) for q in qs]
        health = eng.debug_health()
        eng.check_replicas()
    finally:
        eng.stop()
    assert health["recoveries"] >= 1, "the one-shot fault never fired"
    assert got == want


@pytest.mark.parametrize("mode", sorted(DENSE_PREFIX))
def test_dense_prefix_cache_tp2_vs_tp1(group, mode):
    """The dense engine's prefix cache at tp = 2: the trie on rank 0, each
    worker's spans of its heads in its store. Streams and every wave's
    logits bit-equal to tp = 1's, the trie's counters equal (the byte
    budget charged at the global bytes), and every worker's store equal
    to rank 0's trie by node id and shard shape (``check_replicas``)."""
    cfg = get_config("tiny")
    params = _params(cfg)
    snaps = []
    want = _run(params, cfg, 1, prompts=PREFIX_PROMPTS, geom=PREFIX_GEOM,
                snaps=snaps, **DENSE_PREFIX[mode])
    got = _run(params, cfg, 2, group, prompts=PREFIX_PROMPTS,
               geom=PREFIX_GEOM, snaps=snaps, **DENSE_PREFIX[mode])
    _assert_same(want, got, f"dense prefix {mode}")
    one, two = snaps
    assert one["prefix_hits"] > 0 and one["prefix_evictions"] > 0, one
    assert {k: two[k] for k in PREFIX_STATS} == \
        {k: one[k] for k in PREFIX_STATS}


def test_dense_prefix_store_mirrors_the_trie(group):
    """Inside a tp = 2 run the worker's store holds exactly the trie's
    node ids, at Hkv / 2 heads per span; a store that drifts (a node
    dropped behind rank 0's back) makes ``check_replicas`` raise."""
    cfg = get_config("tiny")
    ekw = dict(PREFIX_GEOM, async_fetch=False, **DENSE_PREFIX["bucketed"])
    eng = mesh_engine.MeshEngine(_params(cfg), cfg, EngineConfig(**ekw),
                                 tp=2, group=group)
    qs = [eng.submit(p, GREEDY) for p in PREFIX_PROMPTS]
    eng.start()
    try:
        for q in qs:
            drain(q)
        eng.check_replicas()
        spans = eng._prefix.spans()
        assert spans and group.store_spans() == [spans]
        assert all(s["k"][1] == cfg.n_kv_heads // 2 for s in spans.values())
        victim = min(spans)
        group.store([("drop", victim)])
        with pytest.raises(RuntimeError, match="prefix store"):
            eng.check_replicas()
    finally:
        eng.stop()


def test_dense_prefix_tp1_matches_jax_engine(group):
    """The port's tp = 1 dense prefix engine (the tp = 2 engine's
    reference above) against the JAX engine's tp = 1 on the same fixed
    schedule: streams under the near-tie rule, and the trie's hits,
    tokens saved and evictions equal."""
    import jax.numpy as jnp

    jcfg = jget_config("tiny")
    jparams, tparams = params_pair(jcfg, seed=0)
    ekw = dict(PREFIX_GEOM, async_fetch=False, **DENSE_PREFIX["bucketed"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        jng = jeng.InferenceEngine(jparams, jcfg, jeng.EngineConfig(**ekw))
        qs = [jng.submit(p, JSamplingParams(temperature=0.0,
                                            max_new_tokens=8))
              for p in PREFIX_PROMPTS]
        jng.start()
        try:
            want = [drain(q) for q in qs]
        finally:
            jng.stop()
    jsnap = jng.stats.snapshot()
    snaps = []
    got, _ = _run(tparams, get_config("tiny"), 1, prompts=PREFIX_PROMPTS,
                  geom=PREFIX_GEOM, snaps=snaps, **DENSE_PREFIX["bucketed"])
    assert_streams_match(got, want, jparams, jcfg, PREFIX_PROMPTS,
                         "dense-prefix tp1 vs jax")
    assert {k: snaps[0][k] for k in PREFIX_STATS[:3]} == \
        {k: jsnap[k] for k in PREFIX_STATS[:3]}


def test_workers_report_gemm_settings(group):
    """Every worker set its GEMMs up before joining the group and
    reported them at spawn; they equal this process's
    (``device.configure_gemms``)."""
    mine = tdevice.configure_gemms()
    assert group.gemms == [mine]
    assert group.gemm_settings() == [mine]
    assert mine["bf16_reduced_precision_reduction"] is \
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction


def _reduction(worker, allow):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allow


def test_worker_with_other_gemm_settings_raises(group):
    """A worker whose GEMM settings differ from rank 0's would reduce its
    shard of a projection in another order: MeshEngine refuses it."""
    cfg = get_config("tiny")
    mine = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    group.run(f"{__name__}:_reduction", not mine)
    try:
        with pytest.raises(RuntimeError, match="rank 1 runs GEMMs"):
            mesh_engine.MeshEngine(_params(cfg), cfg, EngineConfig(**GEOM),
                                   tp=2, group=group)
    finally:
        group.run(f"{__name__}:_reduction", mine)
    assert _run(_params(cfg), cfg, 2, group)[0] == \
        _run(_params(cfg), cfg, 1)[0]


def test_killed_worker_fails_requests_within_timeout(group):
    """Rank 1 killed under a live engine: the next dispatch raises on rank
    0, so the request ends with an error item, well inside the group's
    timeout. Ends the group (the fixture's teardown closes it)."""
    cfg = get_config("tiny")
    eng = mesh_engine.MeshEngine(_params(cfg), cfg,
                                 EngineConfig(**GEOM, **MODES["ragged"]),
                                 tp=2, group=group)
    eng.start()
    try:
        drain(eng.submit(PROMPTS[0], GREEDY))  # the group serves
        group.kill(1)
        t0 = time.perf_counter()
        q = eng.submit(PROMPTS[1], GREEDY)
        items = []
        while True:
            item = q.get(timeout=TIMEOUT_S)
            if item is None:
                break
            items.append(item)
        took = time.perf_counter() - t0
    finally:
        eng.stop()
    errors = [i for i in items if "error" in i]
    assert errors and "rank 1" in errors[0]["error"], items
    assert took < TIMEOUT_S
