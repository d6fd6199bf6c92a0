"""Both prefix caches under dp > 1 on the CPU (``servers/dp_replicas.py``:
the paged trie's block moves, the dense trie's span broadcasts), held to
dp = 1 and to the JAX package.

One module-scoped group of four gloo ranks on ``MeshPlan(dp=2, tp=2)``
(tiny, 2 KV heads; 4 slots, replica 0 owns slots [0, 2), replica 1
[2, 4)). The traffic: a priming request alone, then a burst behind its
32-token head, each phase queued at once. Free slots are popped from the
end, so the primer runs on slot 3 (replica 1) and the burst's last
requests land on replica 0, whose hits read KV replica 1 computed.

 * For the paged modes (the ragged wave on B1's leg, the bucketed paged
   engine, the spec engine) and the dense modes (one-shot warm admission,
   chunked seed): the streams and every sampled logits row (keyed by seed
   and position, from each replica's leader) bit-equal to dp = 1's; the
   trie's hits, tokens saved, zero-copy admissions, copy-on-write copies,
   evictions and seed copies equal; ``check_replicas``; and at least one
   transfer between replicas.
 * The same traffic through the JAX engine on ``make_mesh(MeshPlan(dp=2,
   tp=2), jax.devices()[:4])`` with Megatron-placed params
   (``assert_streams_match``).
 * A pool of few blocks: trie blocks evicted, freed and allocated again
   to the other replica's slots, still bit-equal to dp = 1, and no freed
   block keeps a holder.
 * The heal rebuild with the prefix cache on, and warmup's dispatch of
   every lattice key (the dense prefix families through the dp cut).
 * ``TorchServer(prefix_cache=1, tp=0)`` on four CPU ranks serves its
   auto plan (dp 2 x tp 2) and hits; with ``mesh_sp=2`` and the ring on
   eight, sp 2 x tp 2 x dp 2.
 * The dp cut of the prefix families against their signatures."""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models.config import get_config as jget_config
from seldon_tpu.parallel import MeshPlan as JMeshPlan
from seldon_tpu.parallel import make_mesh as jmake_mesh
from seldon_tpu.parallel.sharding import param_pspecs, shard_tree
from seldon_tpu_torch.models import ragged_attention, spec_decode, transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from seldon_tpu_torch.servers import dp_replicas, engine, mesh_engine
from seldon_tpu_torch.servers import torchserver
from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine
from seldon_tpu_torch.servers.mesh_engine import MeshEngine
from seldon_tpu_torch.servers.prefix_cache import StoreGather
from torch_port_helpers import (_copying, assert_streams_match, drain,
                                params_pair)
from torch_port_helpers import one_intra_op_thread  # noqa: F401

TIMEOUT_S = 60.0
NEW = 8
HEAD = list(range(40, 72))  # four 8-token prefix blocks
PRIME = [HEAD + list(range(90, 95))]
BURST = [HEAD + list(range(100 + 16 * i, 100 + 16 * i + n))
         for i, n in enumerate((13, 4, 11, 7))]
PHASES = (PRIME, BURST)
GEOM = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32, 64),
            async_fetch=False, prefix_cache=True, prefix_block=8)
MODES = {
    "ragged": dict(paged_kv=True, chunked_prefill=True, prefill_chunk=8,
                   kv_block=8, ragged=True, ragged_kernel="pallas"),
    # kv_block 16 over 8-token prefix blocks: a match that ends inside a
    # pool block copies it (copy-on-write) on the reading replica.
    "paged": dict(paged_kv=True, kv_block=16, prompt_buckets=(16, 32, 64)),
    "spec": dict(spec_decode=True, spec_k=2, paged_kv=True, kv_block=8,
                 ragged_kernel="pallas"),
    "dense": {},
    "chunked": dict(chunked_prefill=True, prefill_chunk=8),
}
PAGED = ("ragged", "paged", "spec")
# The small pool of the eviction test (16 usable blocks of 8 tokens).
POOL_BLOCKS = 17
STATS = ("prefix_hits", "prefix_tokens_saved", "zero_copy_admissions",
         "cow_copies", "prefix_evictions", "prefix_seed_copies")


class _Group:
    """The module's group of four ranks, spawned at first use; a process
    is rank 0 of one group at a time, so a test whose server spawns its
    own closes it first."""

    def __init__(self):
        self.group = None

    def get(self):
        if self.group is None:
            with pytest.MonkeyPatch.context() as mp:
                mp.setenv("OMP_NUM_THREADS", "1")
                self.group = mesh_engine.spawn_group(
                    make_mesh(MeshPlan(dp=2, tp=2), ["cpu"] * 4), TIMEOUT_S)
        return self.group

    def close(self):
        if self.group is not None:
            self.group.close()
        self.group = None


@pytest.fixture(scope="module")
def groups():
    g = _Group()
    yield g
    g.close()


@pytest.fixture
def group(groups):
    return groups.get()


@pytest.fixture
def no_group(groups):
    groups.close()


def _params(cfg, seed=0):
    return transformer.init_params(cfg, torch.Generator().manual_seed(seed),
                                   "cpu")


class _SampleTap:
    """While active, the logits row each sampler call of this process sees
    for every row, keyed by (seed, position); a later call at a key
    replaces the row."""

    MODS = (ragged_attention, spec_decode, engine)

    def __enter__(self):
        self.rows = {}
        self.orig = ragged_attention.sample_per_row

        def tapped(logits, seeds, positions, *rest):
            for i, key in enumerate(zip(seeds.tolist(), positions.tolist())):
                self.rows[key] = logits[i].detach().clone()
            return self.orig(logits, seeds, positions, *rest)

        for mod in self.MODS:
            mod.sample_per_row = tapped
        return self

    def __exit__(self, *exc):
        for mod in self.MODS:
            mod.sample_per_row = self.orig


def _worker_tap(worker, on):
    """Run on a worker: start its sampler tap, or stop it and return its
    rows when the worker leads its replica (tp coordinate 0)."""
    if on:
        worker.sample_tap = _SampleTap().__enter__()
        return None
    tap = worker.sample_tap
    tap.__exit__()
    del worker.sample_tap
    return tap.rows if worker.axes.coord["tp"] == 0 else {}


def _run(params, cfg, group=None, phases=PHASES, before_start=None, **ekw):
    """(streams, the sampled logits rows of every request's tokens keyed
    by (seed, position), the trie's counters, each rank's transfers,
    the engine) of ``phases`` (each queued at once; request i sampled
    with seed i) on dp = 1 or the group; ``before_start(eng)`` runs before
    the engine starts."""
    ecfg = EngineConfig(**dict(GEOM, **ekw))
    eng = (MeshEngine(params, cfg, ecfg, group=group) if group
           else InferenceEngine(params, cfg, ecfg, device="cpu"))
    if before_start is not None:
        before_start(eng)
    prompts = [p for phase in phases for p in phase]
    moved = None
    if group is not None:
        group.transfers(reset=True)
        group.run(f"{__name__}:_worker_tap", True)
    with _SampleTap() as tap:
        eng.start()
        try:
            outs, seed = [], 0
            for phase in phases:
                with eng._book:
                    qs = []
                    for p in phase:
                        qs.append(eng.submit(p, SamplingParams(
                            temperature=0.0, max_new_tokens=NEW,
                            seed=seed)))
                        seed += 1
                outs += [drain(q) for q in qs]
            if group is not None:
                eng.check_replicas()
        finally:
            eng.stop()
            if group is not None:
                for theirs in group.run(f"{__name__}:_worker_tap", False):
                    tap.rows.update(theirs)
                moved = group.transfers()
    assert eng.debug_lifecycle_check() == {}
    rows = {}
    for i, (p, out) in enumerate(zip(prompts, outs)):
        for j in range(len(out)):
            rows[(i, len(p) + j)] = tap.rows[(i, len(p) + j)]
    st = eng.stats.snapshot()
    return outs, rows, {k: st[k] for k in STATS}, moved, eng


def _assert_same(want, got, what):
    assert got[0] == want[0], f"{what}: streams differ from dp = 1's"
    assert all(len(s) == NEW for s in want[0])
    assert got[1].keys() == want[1].keys(), what
    for key, row in want[1].items():
        assert torch.equal(got[1][key], row), \
            f"{what}: the logits row of (seed, position) {key} differs"
    assert got[2] == want[2], f"{what}: trie counters {got[2]} != {want[2]}"


@pytest.mark.parametrize("mode", sorted(MODES))
def test_dp2_tp2_prefix_equals_dp1(group, mode):
    cfg = get_config("tiny")
    params = _params(cfg)
    want = _run(params, cfg, **MODES[mode])
    got = _run(params, cfg, group, **MODES[mode])
    _assert_same(want, got, mode)
    assert want[2]["prefix_hits"] == len(BURST)
    moved = got[3]
    if mode in PAGED:
        # Replica 0's ranks received the head's blocks from replica 1's.
        assert moved[0].moves >= 1 and moved[0].blocks >= 2, moved
        assert [m.bytes_in > 0 for m in moved] == [True, True, False,
                                                   False], moved
        assert all(m.spans == 0 for m in moved)
    else:
        assert all(m.moves == 0 for m in moved)
        assert all(m.spans == moved[0].spans > 0 for m in moved), moved
        assert moved[0].bytes_in > 0 and moved[1].bytes_in > 0, moved


@pytest.mark.parametrize("mode", ["ragged", "paged", "dense", "chunked"])
def test_dp2_tp2_prefix_matches_jax_engine_on_its_mesh(group, mode):
    """The JAX engine on make_mesh(MeshPlan(dp=2, tp=2)) with the
    Megatron-placed params (its ragged leg on the Pallas kernel in
    interpret mode), the same two phases and seeds, against the port's
    dp2 x tp2 group; the trie's hits and tokens saved equal."""
    from seldon_tpu.models.sampling import SamplingParams as JSP
    from seldon_tpu.servers import engine as jeng

    jcfg = jget_config("tiny")
    jparams, tparams = params_pair(jcfg, seed=0)
    mesh = jmake_mesh(JMeshPlan(dp=2, tp=2), jax.devices()[:4])
    placed = shard_tree(jparams, param_pspecs(jcfg), mesh)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(
            placed, jcfg, jeng.EngineConfig(**dict(GEOM, **MODES[mode])),
            mesh=mesh)
        eng.start()
        try:
            want, seed = [], 0
            for phase in PHASES:
                with eng._book:
                    qs = []
                    for p in phase:
                        qs.append(eng.submit(p, JSP(
                            temperature=0.0, max_new_tokens=NEW, seed=seed)))
                        seed += 1
                want += [drain(q) for q in qs]
        finally:
            eng.stop()
    jsnap = eng.stats.snapshot()
    got = _run(tparams, get_config("tiny"), group, **MODES[mode])
    assert_streams_match(got[0], want, jparams, jcfg,
                         [p for ph in PHASES for p in ph],
                         f"dp2xtp2-prefix-{mode}-vs-jax-mesh")
    assert {k: got[2][k] for k in STATS[:2]} == {k: jsnap[k]
                                                 for k in STATS[:2]}


def test_dp2_evicted_blocks_reused_on_the_other_replica(group):
    """The ragged engine on a pool of few blocks: the head's blocks move
    to replica 0, are evicted and freed, and the allocator hands the same
    ids to replica 1, which writes another head into them; replica 0's
    hits on that head must move them again (a stale holder would read
    the first head's KV). Bit-equal to dp = 1 with evictions on both
    sides; afterwards only live blocks have holders."""
    cfg = get_config("tiny")
    params = _params(cfg)
    head2 = list(range(140, 172))
    phases = (PRIME, BURST,
              [[3 + (11 * j + 50 * i) % 250 for j in range(48)]
               for i in range(2)],
              [head2 + [5, 6, 7]],
              [head2 + list(range(100 + 16 * i, 100 + 16 * i + 5))
               for i in range(4)])
    ekw = dict(MODES["ragged"], kv_pool_blocks=POOL_BLOCKS)
    want = _run(params, cfg, phases=phases, **ekw)
    moved = []
    real = group.move_blocks

    def record(src, dst, bids, local):
        moved.append(list(bids))
        return real(src, dst, bids, local)

    group.move_blocks = record
    try:
        got = _run(params, cfg, group, phases=phases, **ekw)
    finally:
        del group.move_blocks
    _assert_same(want, got, "small pool")
    assert want[2]["prefix_evictions"] > 0, want[2]
    assert len(moved) == 2 and set(moved[0]) & set(moved[1]), moved
    eng = got[4]
    assert set(eng._holders) <= set(eng._allocator.refs_snapshot())


def test_dp2_prefix_heal_rebuilds_every_replica(group):
    """A dispatch fault under supervised recovery with the paged prefix
    cache on dp2 x tp2: the rebuild resets the trie and the holders on
    every replica, and the replays' streams equal dp = 1's clean ones."""
    from seldon_tpu_torch.servers.chaos import ChaosConfig, ChaosMonkey

    cfg = get_config("tiny")
    params = _params(cfg)
    want = _run(params, cfg, **MODES["ragged"])
    rebuilt = []

    def fault(eng):
        mk = ChaosMonkey(ChaosConfig(seed=0, dispatch_fail=1.0))
        orig, calls = mk.on_dispatch, []

        def nth(*args):  # one fault, inside the burst's waves
            calls.append(args)
            if len(calls) == 12:
                eng._chaos = None
                return orig(*args)

        mk.on_dispatch = nth
        eng._chaos = mk
        real = eng._rebuild_device_state

        def rebuild():
            real()
            rebuilt.append(dict(eng._holders))

        eng._rebuild_device_state = rebuild

    got = _run(params, cfg, group, before_start=fault, heal=True,
               **MODES["ragged"])
    assert rebuilt == [{}], "the one-shot fault never fired"
    assert got[0] == want[0]
    assert got[4].debug_health()["recoveries"] >= 1


@pytest.mark.parametrize("mode", ["ragged", "dense", "chunked"])
def test_dp2_warmup_seals_the_prefix_lattice(group, monkeypatch, mode):
    """Warmup dispatches every lattice key on dp2 x tp2 with the prefix
    cache on (the dense warm admission and seed through the dp cut, on
    zero prefix KV of each rank's heads); the traffic then runs no key
    outside the lattice, and its streams are dp = 1's."""
    monkeypatch.setenv("COMPILE_LEDGER", "1")
    cfg = get_config("tiny")
    params = _params(cfg)
    want = _run(params, cfg, **MODES[mode])
    got = _run(params, cfg, group, before_start=lambda eng: eng.warmup(),
               **MODES[mode])
    assert got[0] == want[0]
    snap = got[4].debug_compile()
    assert snap["warmup_complete"] is True
    assert snap["live_retrace_count"] == 0, snap["live_retraces"]
    assert any(k.startswith(("admit-prefix", "seed-prefix"))
               for k in got[4].static_lattice()) or mode == "ragged"


def test_server_prefix_cache_serves_the_dp_plan(no_group, monkeypatch):
    """TorchServer(prefix_cache=1, tp=0) on four CPU ranks plans dp 2 x
    tp 2 and serves: its streams are the one-device server's and the
    trie hits."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    kw = dict(preset="tiny", max_slots=4, max_seq_len=128,
              prefill_chunk=16, ragged=1, ragged_kernel="pallas",
              prefix_cache=1, device="cpu")
    reqs = [{"prompt_token_ids": p, "max_new_tokens": 6,
             "temperature": 0.0} for p in PRIME + BURST]
    plain = torchserver.TorchServer(**kw)
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
        assert srv.engine.mesh_info()["plan"]["dp"] == 2
        got = [srv.generate(r)["token_ids"] for r in reqs]
        srv.engine.check_replicas()
        hits = srv.engine.stats.snapshot()["prefix_hits"]
    finally:
        srv.stop()
    assert got == want
    assert hits == len(BURST)


def test_server_mesh_sp_prefix_cache_serves_dp(no_group, monkeypatch):
    """TorchServer(mesh_sp=2, prefix_cache=1) with the ring on eight CPU
    ranks plans sp 2 x tp 2 x dp 2 and serves the dense prefix cache (a
    span broadcast over each (sp, tp) coordinate's dp group): the
    one-device server's streams, and the trie hits."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    real = torchserver.get_config
    monkeypatch.setattr(torchserver, "get_config", lambda name, **kw:
                        dataclasses.replace(real(name, **kw),
                                            attn_impl="ring"))
    kw = dict(preset="tiny", max_slots=4, max_seq_len=128, prefix_cache=1,
              device="cpu")
    reqs = [{"prompt_token_ids": HEAD + list(range(90 + 9 * i, 95 + 9 * i)),
             "max_new_tokens": 6, "temperature": 0.0} for i in range(4)]
    plain = torchserver.TorchServer(**kw)
    plain.load()
    try:
        want = [plain.generate(r)["token_ids"] for r in reqs]
    finally:
        plain.stop()
    monkeypatch.setattr(torchserver, "serving_devices",
                        lambda device: [device] * 8)
    srv = torchserver.TorchServer(mesh_sp=2, **kw)
    srv.load()
    try:
        assert srv.engine.mesh_info()["plan"] == {
            "dp": 2, "pp": 1, "sp": 2, "ep": 1, "tp": 2}
        got = [srv.generate(r)["token_ids"] for r in reqs]
        srv.engine.check_replicas()
        hits = srv.engine.stats.snapshot()["prefix_hits"]
    finally:
        srv.stop()
    assert got == want
    assert hits == len(reqs) - 1


@pytest.mark.parametrize("name", sorted(dp_replicas.ROW_FAMILIES)
                         + sorted(dp_replicas.ONE_SLOT))
def test_cut_indices_name_the_slot_arguments(name):
    """Each row family's and one-slot family's index is its ``slots`` /
    ``slot`` parameter among the arguments after the state."""
    params = list(inspect.signature(
        getattr(InferenceEngine, name)).parameters)
    after = params[params.index("state") + 1:]
    index = dp_replicas.ROW_FAMILIES.get(name, dp_replicas.ONE_SLOT.get(name))
    assert after[index] == ("slots" if name in dp_replicas.ROW_FAMILIES
                            else "slot")


def test_cut_of_the_prefix_families():
    """The warm admission's rows and their trie paths go to the replica of
    their slot (slot ids made local); the chunked seed to its slot's
    replica alone; the writes of a row family map each row to its
    replica's cut."""
    G = 3
    slots = np.array([3, 0, 2], np.int32)
    args = [np.zeros((G, 8), np.int32), np.full(G, 9, np.int32),
            np.full(G, 8, np.int32),
            StoreGather(rows=((1, 2), (3,), (4, 5)), pad_to=16, stack=True)]
    args += [np.arange(G)] * 5 + [slots]
    active = np.zeros(4, bool)
    cuts = {d: dp_replicas.cut("_admit_prefix_impl", args, {}, 2 * d,
                               2 * d + 2, active) for d in (0, 1)}
    assert cuts[0].args[3].rows == ((3,),)
    assert cuts[1].args[3].rows == ((1, 2), (4, 5))
    assert cuts[1].args[9].tolist() == [1, 0] and cuts[1].items == (2, 3)
    w = dp_replicas.row_writes(cuts, None)
    assert w.owner.tolist() == [1, 0, 1] and w.index.tolist() == [0, 0, 1]
    g = StoreGather(rows=((7,),), pad_to=8, stack=False)
    assert dp_replicas.cut("_seed_prefix_impl", [g, 1], {}, 2, 4,
                           active) is None
    c = dp_replicas.cut("_seed_prefix_impl", [g, 3], {}, 2, 4, active)
    assert c.args == [g, 1]
