"""The serving rank groups' full mesh plan on the CPU
(``TorchServer._serving_mesh`` / ``_mesh_for``, ``servers/mesh_engine``
on a plan of dp x sp x tp ranks, ``servers/dp_replicas``), held to the
JAX package.

 * The plan: for n = 1..16 devices, tp in {0, 1, 2}, mesh_sp in
   {0, 2, 4}, "xla" and "ring" attention, on tiny and llama3-8b, the
   port's ``_serving_mesh`` on n cards (their count and list replaced)
   gives the axis sizes of the JAX server's ``_serving_mesh`` on
   ``jax.devices()[:n]`` (of the 8 forced host devices; past 8 the
   plan JAX hands ``make_mesh``), or both raise.
 * dp2 x tp2 on tiny (2 KV heads: ``MeshPlan.auto(4)``), one
   module-scoped group of four gloo ranks: on the ragged kernel leg and
   the dense default, greedy streams equal to tp = 1's, the port's
   held to the JAX ``InferenceEngine`` on ``make_mesh(MeshPlan(dp=2,
   tp=2), jax.devices()[:4])`` with Megatron-placed params (its Pallas
   leg runs there in interpret mode) under ``assert_streams_match``'s
   contract, ``check_replicas`` (every worker's slots and weights);
   ``max_slots % dp`` raises (the prefix caches under dp:
   ``tests/test_torch_dp_prefix.py``); each
   replica's B1 calls follow its own wave legs; the HBM ledger and the
   roof per device; a server on four CPU ranks with ``tp=0`` serves the
   auto plan, never one device.
 * tp = 4 on tiny with 4 KV heads (the auto plan on four ranks): streams
   and every wave's logits bit-equal to tp = 1's.
 * sp2 x tp2 with the "ring" config: the ring score within 2e-2 of
   JAX's ``forward`` with ``ring_mesh`` on ``MeshPlan(sp=2, tp=2)`` over
   four host devices (the tolerance of JAX's own sharded-forward test),
   and one context-parallel admission's first token equal to the
   one-device admission's, through the engine and through a server
   whose ``_mesh_for`` plans it."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import get_config as jget_config
from seldon_tpu.parallel import MeshPlan as JMeshPlan
from seldon_tpu.parallel import make_mesh as jmake_mesh
from seldon_tpu.parallel.sharding import param_pspecs, shard_tree
from seldon_tpu.servers import jaxserver
from seldon_tpu.servers import mesh_engine as jme
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.parallel import ring_attention as ra
from seldon_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from seldon_tpu_torch.servers import mesh_engine, torchserver
from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine
from seldon_tpu_torch.servers.mesh_engine import MeshEngine
from torch_port_helpers import (_copying, assert_streams_match, drain,
                                params_pair)
from torch_port_helpers import one_intra_op_thread  # noqa: F401

TIMEOUT_S = 60.0
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)
PROMPTS = [list(range(2, 2 + n)) for n in (5, 12, 24, 7)]
GEOM = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
            async_fetch=False)
MODES = {
    "ragged": dict(paged_kv=True, chunked_prefill=True, prefill_chunk=8,
                   prefix_block=8, kv_block=8, ragged=True,
                   ragged_kernel="pallas"),
    "dense": {},
}
# Every other engine family under dp: each replica runs its cut.
DP_MODES = dict(
    MODES,
    paged=dict(paged_kv=True, kv_block=16, kv_pool_blocks=12,
               prompt_buckets=(16, 32)),
    chunked=dict(chunked_prefill=True, prefill_chunk=8, prefix_block=8),
    sparse=dict(MODES["ragged"], ragged_kernel="sparse"),
    spec=dict(spec_decode=True, spec_k=2, paged_kv=True, kv_block=8,
              prefix_block=8, ragged_kernel="pallas"))


def _spawn(plan):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        return mesh_engine.spawn_group(
            make_mesh(plan, ["cpu"] * plan.n_devices), TIMEOUT_S)


class _Groups:
    """The module's one live group of four ranks: a process is rank 0 of
    one group at a time, so a test of another plan lays the same ranks
    out on it (``MeshGroup.replan``)."""

    def __init__(self):
        self.plan, self.group = None, None

    def __call__(self, plan):
        if self.group is None:
            self.group = _spawn(plan)
        elif plan != self.plan:
            self.group.replan(plan)
        self.plan = plan
        return self.group

    def close(self):
        if self.group is not None:
            self.group.close()
        self.plan, self.group = None, None


@pytest.fixture(scope="module")
def groups():
    g = _Groups()
    yield g
    g.close()


@pytest.fixture
def dp_group(groups):
    return groups(MeshPlan(dp=2, tp=2))


@pytest.fixture
def tp4_group(groups):
    return groups(MeshPlan(tp=4))


@pytest.fixture
def ring_group(groups):
    return groups(MeshPlan(sp=2, tp=2))


@pytest.fixture
def no_group(groups):
    """A test whose server spawns its own group."""
    groups.close()


def _run(params, cfg, group=None, prompts=PROMPTS, **ekw):
    """(streams, the logits rank 0 computed, in dispatch order) of
    ``prompts`` on a fixed schedule: every request queued before
    start(), the synchronous loop; a grouped engine's replicas are then
    checked."""
    rows = []
    logits_fn = transformer._logits

    def tap(*a, **k):
        out = logits_fn(*a, **k)
        rows.append(out.detach().clone())
        return out

    ecfg = EngineConfig(**dict(GEOM, **ekw))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "_logits", tap)
        eng = (MeshEngine(params, cfg, ecfg, group=group) if group
               else InferenceEngine(params, cfg, ecfg, device="cpu"))
        qs = [eng.submit(p, GREEDY) for p in prompts]
        eng.start()
        try:
            outs = [drain(q) for q in qs]
            if group is not None:
                eng.check_replicas()
        finally:
            eng.stop()
    assert eng.debug_lifecycle_check() == {}
    return outs, rows


def _params(cfg, seed=0):
    return transformer.init_params(cfg, torch.Generator().manual_seed(seed),
                                   "cpu")


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------


def _jax_plan(monkeypatch, preset, attn, tp, mesh_sp, n):
    """The axis sizes of the JAX server's _serving_mesh on n devices."""
    real = jax.devices()
    monkeypatch.delenv("MESH_DEVICES", raising=False)
    if n <= len(real):
        monkeypatch.setattr(jax, "devices", lambda *a: real[:n])
    else:
        # Past the forced host devices: the plan JAX hands make_mesh.
        from seldon_tpu import parallel as jpar

        monkeypatch.setattr(jax, "devices", lambda *a: [object()] * n)
        monkeypatch.setattr(jpar, "make_mesh",
                            lambda plan, devices=None: plan.axis_sizes())
        monkeypatch.setattr(jme, "make_mesh",
                            lambda plan, devices=None: plan.axis_sizes())
    srv = jaxserver.JAXServer(preset=preset, tp=tp, mesh_sp=mesh_sp)
    cfg = jget_config(preset, attn_impl=attn)
    out = srv._serving_mesh(cfg)
    return dict(out if isinstance(out, dict) else out.shape)


def _port_plan(monkeypatch, preset, attn, tp, mesh_sp, n):
    """The axis sizes of the port's _serving_mesh on n cards (the card
    path with the device count and list replaced)."""
    cards = [torch.device("cuda", i) for i in range(n)]
    monkeypatch.setattr(mesh_engine, "device_budget", lambda: n)
    monkeypatch.setattr(mesh_engine, "cuda_devices", lambda: cards)
    monkeypatch.setattr(torchserver, "cuda_devices", lambda: cards)
    srv = torchserver.TorchServer(preset=preset, tp=tp, mesh_sp=mesh_sp,
                                  device="cpu")
    srv.device = torch.device("cuda", 0)
    cfg = get_config(preset, attn_impl=attn)
    return dict(srv._serving_mesh(cfg).shape)


@pytest.mark.parametrize("mesh_sp", [0, 2, 4])
@pytest.mark.parametrize("tp", [0, 1, 2])
@pytest.mark.parametrize("attn", ["xla", "ring"])
@pytest.mark.parametrize("preset", ["tiny", "llama3-8b"])
def test_serving_plan_equals_jax(preset, attn, tp, mesh_sp):
    if tp > 1 and mesh_sp > 1:
        with pytest.raises(ValueError, match="mutually exclusive"):
            jaxserver.JAXServer(preset=preset, tp=tp, mesh_sp=mesh_sp)
        with pytest.raises(ValueError, match="mutually exclusive"):
            torchserver.TorchServer(preset=preset, tp=tp, mesh_sp=mesh_sp,
                                    device="cpu")
        return
    for n in range(1, 17):
        with pytest.MonkeyPatch.context() as mp:
            try:
                want = _jax_plan(mp, preset, attn, tp, mesh_sp, n)
            except ValueError:
                want = None
        with pytest.MonkeyPatch.context() as mp:
            if want is None:
                with pytest.raises(ValueError):
                    _port_plan(mp, preset, attn, tp, mesh_sp, n)
                continue
            got = _port_plan(mp, preset, attn, tp, mesh_sp, n)
        assert got == want, (n, got, want)


def test_one_device_builds_no_group():
    """On the CPU (one device) tp=0 plans one device: no group."""
    srv = torchserver.TorchServer(preset="tiny", max_slots=4,
                                  max_seq_len=64, device="cpu")
    try:
        srv.predict(np.arange(3, 19)[None], [])
        assert srv._serving_mesh(srv.cfg).devices.size == 1
        assert srv.group is None
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# dp2 x tp2
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(DP_MODES))
def test_dp2_tp2_streams_equal_tp1(dp_group, mode):
    cfg = get_config("tiny")
    params = _params(cfg)
    want, _ = _run(params, cfg, **DP_MODES[mode])
    got, _ = _run(params, cfg, dp_group, **DP_MODES[mode])
    assert got == want
    assert all(len(s) > 0 for s in want)


def test_dp2_heal_rebuilds_every_replica(dp_group):
    """A dispatch fault under supervised recovery on dp2 x tp2: the
    rebuild of the device state reaches every replica and the replays
    their cuts, so the healed streams equal tp = 1's clean ones and every
    worker's slots equal rank 0's afterwards."""
    from seldon_tpu_torch.servers.chaos import ChaosConfig, ChaosMonkey

    cfg = get_config("tiny")
    params = _params(cfg)
    want, _ = _run(params, cfg, **MODES["ragged"])
    eng = MeshEngine(params, cfg, EngineConfig(**GEOM, **MODES["ragged"],
                                               heal=True), group=dp_group)
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


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dp2_tp2_streams_match_jax_engine_on_its_mesh(dp_group, mode):
    """The JAX engine on make_mesh(MeshPlan(dp=2, tp=2)) with the
    Megatron-placed params (its ragged leg on the Pallas kernel in
    interpret mode) against the port's dp2 x tp2 group."""
    from seldon_tpu.models.sampling import SamplingParams as JSP
    from seldon_tpu.servers import engine as jeng

    jcfg = jget_config("tiny")
    jparams, tparams = params_pair(jcfg, seed=0)
    mesh = jmake_mesh(JMeshPlan(dp=2, tp=2), jax.devices()[:4])
    placed = shard_tree(jparams, param_pspecs(jcfg), mesh)
    ekw = dict(GEOM, **MODES[mode])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(placed, jcfg, jeng.EngineConfig(**ekw),
                                   mesh=mesh)
        qs = [eng.submit(p, JSP(temperature=0.0, max_new_tokens=8, seed=i))
              for i, p in enumerate(PROMPTS)]
        eng.start()
        try:
            want = [drain(q) for q in qs]
        finally:
            eng.stop()
    got, _ = _run(tparams, get_config("tiny"), dp_group, **MODES[mode])
    assert_streams_match(got, want, jparams, jcfg, PROMPTS,
                         f"dp2xtp2-{mode}-vs-jax-mesh")


def _worker_b1_calls(worker, reset=False):
    """Run on a worker: its B1 calls (the plain version's on the CPU)."""
    n = getattr(worker, "b1_calls", 0)
    if reset:
        worker.b1_calls = 0
    return n


def _worker_count_b1(worker, on):
    """Run on a worker: count its calls of B1's wrapper."""
    if on:
        real = rpa.partials_kernel
        worker.b1_real = real
        worker.b1_calls = 0

        def counted(*a, **k):
            worker.b1_calls += 1
            return real(*a, **k)

        rpa.partials_kernel = counted
    else:
        rpa.partials_kernel = worker.b1_real


def test_dp2_replicas_run_their_own_legs(dp_group, monkeypatch):
    """Each replica runs only the waves in which it owns a live row:
    with every request on replica 1's slots, replica 0's ranks (rank 0
    and rank 1) run no ragged leg, replica 1's run all of them; the
    streams are still tp = 1's."""
    cfg = get_config("tiny")
    params = _params(cfg)
    prompts = PROMPTS[:2]
    want, _ = _run(params, cfg, prompts=prompts, **MODES["ragged"])
    calls = []
    real = rpa.partials_kernel
    monkeypatch.setattr(rpa, "partials_kernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    dp_group.run(f"{__name__}:_worker_count_b1", True)
    try:
        # Two requests take slots 3 and 2 (the free list pops from the
        # end): replica 1's block [2, 4).
        got, _ = _run(params, cfg, dp_group, prompts=prompts,
                      **MODES["ragged"])
        theirs = dp_group.run(f"{__name__}:_worker_b1_calls")
    finally:
        dp_group.run(f"{__name__}:_worker_count_b1", False)
    assert got == want
    assert len(calls) == 0 and theirs[0] == 0
    assert theirs[1] == theirs[2] > 0


def test_dp_refusals(dp_group):
    cfg = get_config("tiny")
    params = _params(cfg)
    with pytest.raises(ValueError, match="max_slots=3 does not split"):
        MeshEngine(params, cfg, EngineConfig(**dict(GEOM, max_slots=3)),
                   group=dp_group)
    with pytest.raises(ValueError, match="2-way 'tp' axis"):
        MeshEngine(params, dataclasses.replace(cfg, n_kv_heads=4),
                   EngineConfig(**GEOM), tp=4, group=dp_group)
    # The group still serves after every refusal.
    assert _run(params, cfg, dp_group)[0] == _run(params, cfg)[0]


def test_dp2_replica_drift_is_caught(dp_group):
    """check_replicas holds every worker to rank 0 over its replica's
    slots, and every worker's weights to its tp coordinate's."""
    cfg = get_config("tiny")
    params = _params(cfg)
    eng = MeshEngine(params, cfg, EngineConfig(**GEOM), group=dp_group)
    try:
        eng.check_replicas()
        pos = eng._state["pos"].clone()
        pos[2:] += 1  # replica 1's slots
        eng._state = dict(eng._state, pos=pos)
        with pytest.raises(RuntimeError, match=r"rank 2's state\['pos'\] "
                                               r"differs .* \[2, 4\)"):
            eng.check_replicas()
        eng._state = dict(eng._state, pos=pos - (pos > 0).int())
        dp_group.run(f"{__name__}:_worker_nudge_weight", 3)
        with pytest.raises(RuntimeError, match="rank 3's shard differs "
                                               "from rank 1's"):
            eng.check_replicas()
    finally:
        eng.stop()


def _worker_nudge_weight(worker, rank):
    """Run on a worker: rank ``rank`` moves one element of its wq."""
    if worker.ranks.rank == rank:
        with torch.no_grad():
            worker.params.blocks[0].wq.view(-1)[0] += 1


def test_hbm_and_roof_per_device_under_dp(dp_group, monkeypatch):
    monkeypatch.setenv("HBM_LEDGER", "1")
    monkeypatch.setenv("ROOF_LEDGER", "1")
    cfg = get_config("tiny")
    params = _params(cfg)
    ref = InferenceEngine(params, cfg, EngineConfig(**GEOM), device="cpu")
    try:
        ref_snap = ref.debug_hbm()
    finally:
        ref.stop()
    eng = MeshEngine(params, cfg, EngineConfig(**GEOM), group=dp_group)
    eng.start()
    try:
        for q in [eng.submit(p, GREEDY) for p in PROMPTS]:
            drain(q)
        snap, roof, info = eng.debug_hbm(), eng.debug_roof(), eng.mesh_info()
    finally:
        eng.stop()
    assert snap["devices"] == 4
    w, ref_w = (snap["categories"]["weights"],
                ref_snap["categories"]["weights"]["bytes"])
    assert w["bytes"] == 4 * w["bytes_per_device"]
    sharded = sum(getattr(bp, n).numel() * getattr(bp, n).element_size()
                  for bp in params.blocks
                  for n in ("wq", "wk", "wv", "w_gate", "w_up"))
    assert w["bytes_per_device"] == ref_w - sharded // 2
    # Each device holds its replica's half of the slab at half the heads;
    # the four devices together hold the dp = 1 slab.
    kv = snap["categories"]["kv_cache"]
    assert kv["bytes"] == ref_snap["categories"]["kv_cache"]["bytes"]
    assert kv["bytes_per_device"] == kv["bytes"] // 4
    assert info["plan"]["dp"] == 2 and info["tp"] == 2
    assert info["world"] == 4 and info["devices"] == ["cpu"] * 4
    assert info["weight_bytes_per_device"] == w["bytes_per_device"]
    assert roof["tp"] == 2 and roof["boundaries"] > 0
    assert roof["conservation"]["breaches"] == 0
    assert eng._roof._geom["max_slots"] == GEOM["max_slots"] // 2


def test_server_tp0_serves_the_auto_plan(no_group, monkeypatch):
    """TorchServer(tp=0) on four CPU ranks plans MeshPlan.auto(4, tiny) =
    dp 2 x tp 2 and serves on a group of that plan (never one device),
    its streams and scores the one-device server's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = dict(preset="tiny", max_slots=4, max_seq_len=128,
              prefill_chunk=16, ragged=1, ragged_kernel="pallas",
              device="cpu")
    reqs = [{"prompt_token_ids": list(range(5, 5 + n)), "max_new_tokens": 6,
             "temperature": 0.0} for n in (3, 17, 40)]
    ids = np.arange(3, 35).reshape(2, 16)
    plain = torchserver.TorchServer(**kw)
    want_nll = plain.predict(ids, [])
    plain.load()
    try:
        want = [plain.generate(r)["token_ids"] for r in reqs]
    finally:
        plain.stop()
    monkeypatch.setattr(torchserver, "serving_devices",
                        lambda device: [device] * 4)
    srv = torchserver.TorchServer(**kw)
    srv.load()
    try:
        assert isinstance(srv.engine, MeshEngine)
        assert srv.engine.mesh_info()["plan"] == {
            "dp": 2, "pp": 1, "sp": 1, "ep": 1, "tp": 2}
        got = [srv.generate(r)["token_ids"] for r in reqs]
        srv.engine.check_replicas()
        nll = srv.predict(ids, [])
    finally:
        srv.stop()
    assert got == want
    np.testing.assert_array_equal(nll, want_nll)


# ---------------------------------------------------------------------------
# tp = 4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", sorted(MODES))
def test_tp4_bit_equal_to_tp1(tp4_group, mode):
    cfg = dataclasses.replace(get_config("tiny"), n_kv_heads=4)
    assert MeshPlan.auto(4, cfg) == MeshPlan(tp=4)
    params = _params(cfg)
    want, wl = _run(params, cfg, **MODES[mode])
    got, gl = _run(params, cfg, tp4_group, **MODES[mode])
    assert got == want
    assert len(gl) == len(wl)
    for i, (a, b) in enumerate(zip(wl, gl)):
        assert torch.equal(a, b), f"{mode}: wave {i} logits differ"


# ---------------------------------------------------------------------------
# sp2 x tp2
# ---------------------------------------------------------------------------


def test_sp2_tp2_ring_score_and_admission(ring_group, monkeypatch):
    """The ring score on sp2 x tp2 against JAX's forward with ring_mesh on
    the same plan, and a context-parallel admission's first token against
    the one-device admission's."""
    jcfg = dataclasses.replace(jget_config("tiny"), attn_impl="ring")
    jparams, tparams = params_pair(jget_config("tiny"), seed=0)
    cfg = dataclasses.replace(get_config("tiny"), attn_impl="ring")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    mesh = jmake_mesh(JMeshPlan(sp=2, tp=2), jax.devices()[:4])
    want = jax.jit(lambda p, t: jtf.forward(p, t, jcfg, ring_mesh=mesh))(
        shard_tree(jparams, param_pspecs(jcfg), mesh), jnp.asarray(tokens))
    calls = []
    real = ra.ring_attention
    monkeypatch.setattr(ra, "ring_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    eng = MeshEngine(tparams, cfg, EngineConfig(**GEOM), group=ring_group)
    try:
        hints = ring_group.hints(2)
        got = ring_group.score(tokens, lambda: transformer.forward(
            eng.params, torch.from_numpy(tokens), cfg,
            ring=ring_group.sp_ranks, tp=hints))
        assert len(calls) == cfg.n_layers
        # A 20-token prompt admits in the 32 bucket: 32 % 2 == 0, so the
        # dense admission prefills context-parallel.
        prompt = list(range(3, 23))
        q = eng.submit(prompt, GREEDY)
        eng.start()
        first = drain(q)
        assert len(calls) == 2 * cfg.n_layers
        eng.check_replicas()
    finally:
        eng.stop()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2,
                               atol=2e-2)
    one, _ = _run(tparams, get_config("tiny"), prompts=[prompt])
    assert first[0] == one[0][0]
    assert first == one[0]


def _worker_count_ring(worker, on):
    """Run on a worker: count its ring attention calls (``on``), or stop
    and return the count."""
    if on:
        worker.ring_real, worker.ring_calls = ra.ring_attention, 0

        def counted(*a, **k):
            worker.ring_calls += 1
            return worker.ring_real(*a, **k)

        ra.ring_attention = counted
        return None
    ra.ring_attention = worker.ring_real
    return worker.ring_calls


def test_dp2_sp2_rings_inside_each_replica(groups, monkeypatch):
    """dp2 x sp2 with the ring config (tiny, tp 1): one admission group
    of four 32-bucket prompts is cut by slot, and each replica prefills
    its rows context-parallel over its own two sp ranks; the streams are
    one device's."""
    group = groups(MeshPlan(dp=2, sp=2))
    cfg = dataclasses.replace(get_config("tiny"), attn_impl="ring")
    params = _params(cfg)
    prompts = [list(range(3 + i, 3 + i + n))
               for i, n in enumerate((20, 17, 25, 12))]
    want, _ = _run(params, get_config("tiny"), prompts=prompts)
    calls = []
    real = ra.ring_attention
    monkeypatch.setattr(ra, "ring_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    group.run(f"{__name__}:_worker_count_ring", True)
    try:
        got, _ = _run(params, cfg, group, prompts=prompts)
    finally:
        theirs = group.run(f"{__name__}:_worker_count_ring", False)
    assert got == want
    assert [len(calls)] + theirs == [cfg.n_layers] * 4


def test_server_mesh_sp_plans_sp_by_tp(no_group, monkeypatch):
    """TorchServer(mesh_sp=2) with the ring on four CPU ranks: _mesh_for
    plans sp 2 x tp gcd(2, 2) = 2; its score is within 2e-2 of the
    one-device server's, and its context-parallel admission's stream is
    the one-device server's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    real = torchserver.get_config
    monkeypatch.setattr(torchserver, "get_config", lambda name, **kw:
                        dataclasses.replace(real(name, **kw),
                                            attn_impl="ring"))
    kw = dict(preset="tiny", max_slots=4, max_seq_len=128, device="cpu")
    req = {"prompt_token_ids": list(range(5, 25)), "max_new_tokens": 6,
           "temperature": 0.0}
    toks = np.random.default_rng(4).integers(3, 200, (2, 32))
    plain = torchserver.TorchServer(**kw)
    want_nll = plain.predict(toks, [])
    plain.load()
    try:
        want = plain.generate(req)["token_ids"]
    finally:
        plain.stop()
    monkeypatch.setattr(torchserver, "serving_devices",
                        lambda device: [device] * 4)
    srv = torchserver.TorchServer(mesh_sp=2, **kw)
    try:
        nll = srv.predict(toks, [])
        assert srv.group.mesh.shape == {"dp": 1, "pp": 1, "sp": 2, "ep": 1,
                                        "tp": 2}
        srv.load()
        got = srv.generate(req)["token_ids"]
        srv.engine.check_replicas()
    finally:
        srv.stop()
    np.testing.assert_allclose(nll, want_nll, rtol=2e-2, atol=2e-2)
    assert got == want


def test_row_share_pads_the_batched_products():
    """Inside a dp replica's ``lt_gemm.row_share`` the products batched
    over the slots run padded to the whole batch's count and give the
    replica's rows what they give outside it; the share nests and
    restores, and a batch that is not whole rows per item raises."""
    from seldon_tpu_torch.models import ragged_attention as ra_mod
    from seldon_tpu_torch.ops import lt_gemm

    g = torch.Generator().manual_seed(0)
    qr = torch.randn(6, 1, 2, 2, 16, generator=g)
    k = torch.randn(6, 1, 2, 16, generator=g)
    want = ra_mod._fresh_scores("bskgd,bukd->bkgsu", qr, k)
    assert lt_gemm.shared_items() is None
    with lt_gemm.row_share(2, 4):
        assert lt_gemm.shared_items() == (2, 4)
        assert transformer.whole_batch(6) == 12
        with pytest.raises(ValueError, match="whole number"):
            transformer.whole_batch(5)
        got = ra_mod._fresh_scores("bskgd,bukd->bkgsu", qr, k)
        with lt_gemm.row_share(3, 3):
            assert lt_gemm.shared_items() is None
        assert lt_gemm.shared_items() == (2, 4)
        q = torch.randn(6, 1, 4, 16, generator=g).bfloat16()
        ck = torch.randn(6, 2, 8, 16, generator=g).bfloat16()
        kf = torch.randn(6, 1, 2, 16, generator=g).bfloat16()
        mask = torch.rand(6, 1, 8, generator=g) > 0.3
        dec = transformer.gqa_attention_decode(q, ck, ck, kf, kf, mask)
        full = transformer.gqa_attention(q, kf, kf, torch.ones(
            6, 1, 1, dtype=torch.bool))
    assert lt_gemm.shared_items() is None
    assert torch.equal(got, want) and got.shape[0] == 6
    assert torch.equal(dec, transformer.gqa_attention_decode(
        q, ck, ck, kf, kf, mask))
    assert torch.equal(full, transformer.gqa_attention(q, kf, kf, torch.ones(
        6, 1, 1, dtype=torch.bool)))
