"""seldon_tpu_torch.servers.wave_program: the converged engine's lattice
as captured programs, held on the CPU, where a program runs the same
body on the same static buffers without a graph (the card's capture and
replay: tests/test_torch_wave_program_cuda.py and chip_smoke.py).

 * The program route against the eager route (``wave_program.disabled``)
   over one mixed burst (prefill chunks, finals, decode and idle rows,
   greedy and sampled) on the masked and kernel legs, bf16 and int8 KV,
   W8A8, the f32 tiny model and tiny-moe, with and without a block
   budget: every wave's outputs, the streams, the final state and the
   W8A8 launch counts bit-equal. Both engines run their sync loop with
   every request queued before start, so they schedule the same waves.
 * The branch-key table (``ragged_attention.wave_branch``) and the
   programs ``warmup`` builds per config.
 * The state hand-off: the programs hold the engine's state tensors in
   place; a field an eager family replaced is copied in before the next
   run.
 * ``host_callback``: the wrappers' counts run at once, after every
   replay of a captured body, never in a capture's warm run.
 * A forced heal recovery resets the state in place (the programs stay)
   and the later streams equal the clean ones.
 * No programs on the sparse and reference legs nor in a rank group.
 * The port's engine with its programs against the JAX engine
   (``ragged=True``, both legs; the JAX engine with a copying
   ``jnp.asarray``, ROADMAP.md C3) under the near-tie rule.

Bit-equality everywhere but the last, which is the repo's engine parity
rule (streams equal, or diverging where the reference's top-2 logit gap
is below RAGGED_LOGITS_ATOL)."""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from seldon_tpu.models.config import PRESETS as JPRESETS
from seldon_tpu_torch.models import quantize, ragged_attention, transformer
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import host_hooks, lt_gemm
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import wave_program
from seldon_tpu_torch.servers.chaos import ChaosConfig, ChaosMonkey
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from torch_port_helpers import (ENGINE_ECFG, assert_streams_match, drain,
                                engine_prompts, params_pair, run_jax_engine)

ECFG = dict(ENGINE_ECFG, prompt_buckets=(16, 32, 64), async_fetch=False)
NEW = 6
# Greedy and sampled requests in one burst.
KNOBS = [dict(temperature=0.0, max_new_tokens=NEW),
         dict(temperature=0.9, top_k=8, top_p=0.95, max_new_tokens=NEW)]
# Blocks of 8 positions: a leg whose longest row holds more than 16
# positions runs the masked head.
BUDGET = 2
# Prompts of 1 to 3 chunks of 16: the third chunk of the 40-token one
# starts past the budget, the early decode legs stay within it.
LENGTHS = [12, 26, 7, 40, 16, 3]


def _prompts(cfg, seed=29):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
            for n in LENGTHS]


def _model(case):
    """(params, cfg) of one case, seeded; W8A8 quantized as the server
    quantizes at load."""
    base = {"moe": "tiny-moe"}.get(case, "tiny")
    cfg = TPRESETS[base]
    if case == "int8kv":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if case == "f32":
        cfg = dataclasses.replace(cfg, dtype="float32")
    if case == "w8a8":
        cfg = dataclasses.replace(cfg, weight_dtype="int8", act_dtype="int8")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     "cpu")
    if case == "w8a8":
        params = quantize.quantize_params(params)
    return params, cfg


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _model(case)
        return cache[case]
    return get


def _engine(params, cfg, kernel="pallas", budget=0, **kw):
    ecfg = teng.EngineConfig(**dict(ECFG, ragged_kernel=kernel,
                                    ragged_block_budget=budget, **kw))
    return teng.InferenceEngine(params, cfg, ecfg, device="cpu")


def _submit(eng, prompts, seeds=None):
    return [eng.submit(p, SamplingParams(seed=i if seeds is None
                                         else seeds[i],
                                         **KNOBS[i % len(KNOBS)]))
            for i, p in enumerate(prompts)]


def _state_arrays(state):
    out = {k: v.clone() for k, v in state.items() if k != "cache"}
    out.update({f"cache.{k}": v.clone() for k, v in state["cache"].items()})
    return out


def _burst(params, cfg, prompts, kernel, budget=0, eager=False,
           setup=None):
    """One burst, every request queued before start (the sync loop then
    schedules the same waves on both routes). Returns the streams, every
    wave's host arrays, the final state, the W8A8 products counted, the
    program keys the engine held and its programs' runs."""
    eng = _engine(params, cfg, kernel, budget)
    if setup is not None:
        setup(eng)
    waves = []
    orig = eng._host_copy

    def recorded(tensors):
        host = orig(tensors)
        waves.append([t.numpy().copy() for t in host.arrays])
        return host

    eng._host_copy = recorded
    n0 = transformer.int_mm_launches
    qs = _submit(eng, prompts)
    ctx = wave_program.disabled() if eager else contextlib.nullcontext()
    with ctx:
        eng.start()
        try:
            streams = [drain(q) for q in qs]
            keys = eng._programs.keys()
        finally:
            eng.stop()
    assert eng.debug_lifecycle_check() == {}
    return dict(streams=streams, waves=waves,
                state=_state_arrays(eng._state),
                int_mm=transformer.int_mm_launches - n0, keys=keys,
                runs=eng._programs.runs)


def _assert_same(got, want):
    assert got["streams"] == want["streams"]
    assert len(got["waves"]) == len(want["waves"])
    for i, (g, w) in enumerate(zip(got["waves"], want["waves"])):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"wave {i}")
    assert got["state"].keys() == want["state"].keys()
    for k in got["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k
    assert got["int_mm"] == want["int_mm"]


@pytest.mark.parametrize("case,kernel,budget", [
    ("bf16", "pallas", 0), ("bf16", "pallas", BUDGET), ("bf16", "masked", 0),
    ("int8kv", "pallas", BUDGET), ("int8kv", "masked", 0),
    ("w8a8", "pallas", 0), ("f32", "pallas", BUDGET), ("f32", "masked", 0),
    ("moe", "pallas", 0)])
def test_programs_equal_the_eager_wave(models, case, kernel, budget):
    """The program route and the eager route of one mixed burst, bit for
    bit: each wave's first tokens, first-done flags, decode tokens,
    valid rows and active mask, the streams, the final pool and per-slot
    fields, and the W8A8 products counted."""
    params, cfg = models(case)
    prompts = _prompts(cfg)
    got = _burst(params, cfg, prompts, kernel, budget)
    want = _burst(params, cfg, prompts, kernel, budget, eager=True)
    _assert_same(got, want)
    assert want["keys"] == [] and want["runs"] == 0
    assert got["runs"] >= len(got["waves"]) > 0
    if case == "w8a8":
        assert got["int_mm"] > 0
    # Every key the burst ran is a branch warmup prepares.
    eng = _engine(params, cfg, kernel, budget)
    allowed = set(eng._wave_kws()) | {(("deactivate",), ())}
    assert set(got["keys"]) <= allowed
    branches = {k[1] for k in got["keys"] if k[0][0] == "ragged"}
    if kernel == "masked":
        assert branches == {("masked",)}
    elif budget:
        # Both heads on both legs, and decode-only waves.
        assert {b[0] for b in branches} == {"skip", "pallas", "masked"}
        assert {b[1] for b in branches} == {"pallas", "masked"}
    else:
        assert branches == {("skip", "pallas"), ("pallas", "pallas")}


# (kernel, budget, has_prefill, live_blocks) -> branch, at a table of 8
# block columns; n_live is clipped to the table as the wave clips it.
BRANCHES = [
    ("masked", 0, False, (1, 1), ("masked",)),
    ("masked", 2, True, (8, 8), ("masked",)),
    ("pallas", 0, False, (8, 8), ("skip", "pallas")),
    ("pallas", 0, True, (8, 8), ("pallas", "pallas")),
    ("pallas", 2, False, (9, 2), ("skip", "pallas")),
    ("pallas", 2, False, (1, 3), ("skip", "masked")),
    ("pallas", 2, True, (2, 2), ("pallas", "pallas")),
    ("pallas", 2, True, (3, 0), ("masked", "pallas")),
    ("pallas", 2, True, (0, 9), ("pallas", "masked")),
    ("pallas", 2, True, (12, 8), ("masked", "masked")),
    ("pallas", 8, True, (12, 12), ("pallas", "pallas")),
    ("sparse", 0, True, (1, 1), ("sparse", "sparse")),
]


@pytest.mark.parametrize("kernel,budget,has_prefill,live,branch", BRANCHES)
def test_wave_branch_table(kernel, budget, has_prefill, live, branch):
    assert ragged_attention.wave_branch(kernel, budget, has_prefill, live,
                                        8) == branch


@pytest.mark.parametrize("kernel,budget,n", [
    ("masked", 0, 1), ("masked", BUDGET, 1), ("pallas", 0, 2),
    ("pallas", BUDGET, 6), ("pallas", 8, 2), ("pallas", 64, 2)])
def test_warmup_prepares_every_reachable_branch(models, kernel, budget, n):
    """warmup prepares one program per branch the config reaches (six on
    the kernel leg under a budget below the table's 8 columns, two
    without one or at one the table cannot pass, one on the masked leg)
    and the deactivate program; a burst after it prepares nothing new."""
    params, cfg = models("bf16")
    eng = _engine(params, cfg, kernel, budget)
    eng.warmup()
    keys = set(eng._programs.keys())
    assert len(keys) == n + 1 and (("deactivate",), ()) in keys
    assert keys == set(eng._wave_kws()) | {(("deactivate",), ())}
    progs = {k: eng._programs.get(k) for k in keys}
    qs = _submit(eng, engine_prompts(cfg)[:3])
    eng.start()
    try:
        for q in qs:
            drain(q)
        assert {k: eng._programs.get(k) for k in eng._programs.keys()} \
            == progs
    finally:
        eng.stop()


def test_state_hand_off_in_place(models):
    """After a program run the engine's state is home's tensors; an eager
    family's replaced field is copied into home before the next run; the
    deactivate program equals the eager family on the same inputs."""
    params, cfg = models("bf16")
    eng = _engine(params, cfg)
    home = {k: v for k, v in eng._state.items() if k != "cache"}
    cache = dict(eng._state["cache"])
    keep = np.ones((4,), bool)
    eng._deactivate(keep)
    assert all(eng._state[k] is v for k, v in home.items())
    assert all(eng._state["cache"][k] is v for k, v in cache.items())
    # An eager family replaces two fields (as the admissions'
    # ``_set_rows`` does).
    eng._state = teng._set_rows(
        eng._state, torch.tensor([0, 2]),
        remaining=torch.tensor([5, 7], dtype=torch.int32),
        active=torch.tensor([True, True]))
    assert eng._state["remaining"] is not home["remaining"]
    want = teng.InferenceEngine._deactivate_impl(
        eng._state, torch.tensor([True, True, False, True]))
    keep[2] = False
    eng._deactivate(keep)
    assert eng._state["remaining"] is home["remaining"]
    assert eng._state["active"] is home["active"]
    for k in ("remaining", "active", "pos", "temp"):
        assert torch.equal(eng._state[k], want[k]), k
    assert home["remaining"].tolist() == [5, 0, 0, 0]
    assert home["active"].tolist() == [True, False, False, False]


def test_host_callback_counts_now_per_replay_never_warm():
    """Eager: the wrappers' counts at once. While a body is captured:
    recorded, run once per replay. In a capture's warm run: dropped."""
    xq = torch.ones((3, 32), dtype=torch.int8)
    w = torch.ones((32, 16), dtype=torch.int8)
    n0 = transformer.int_mm_launches
    transformer._int_mm(xq, w)
    assert transformer.int_mm_launches == n0 + 1
    hooks = []
    with host_hooks.collecting(hooks):
        transformer._int_mm(xq, w)
        host_hooks.host_callback(
            functools.partial(rpa._count, torch.bfloat16))
        host_hooks.host_callback(lt_gemm._count)
    assert transformer.int_mm_launches == n0 + 1 and len(hooks) == 3
    b0, e0, g0 = rpa.launches, rpa.entry_launches[torch.bfloat16], \
        lt_gemm.launches
    for _ in range(2):  # two replays
        for fn in hooks:
            fn()
    assert transformer.int_mm_launches == n0 + 3
    assert (rpa.launches, rpa.entry_launches[torch.bfloat16],
            lt_gemm.launches) == (b0 + 2, e0 + 2, g0 + 2)
    with host_hooks.collecting(host_hooks.WARM):
        transformer._int_mm(xq, w)
    assert transformer.int_mm_launches == n0 + 3


def test_disabled_nests_and_clear_caches_rebinds(models):
    params, cfg = models("bf16")
    eng = _engine(params, cfg)
    assert eng._captured()
    with wave_program.disabled():
        with wave_program.disabled():
            assert not eng._captured()
        assert not eng._captured()
    assert eng._captured()
    eng._deactivate(np.ones((4,), bool))
    prog = eng._programs.get((("deactivate",), ()))
    wave_program.clear_caches()
    eng._deactivate(np.ones((4,), bool))
    assert eng._programs.get((("deactivate",), ())) is not prog
    assert len(eng._programs) == 1


def test_ledger_has_no_graph_pool_on_the_cpu(models, monkeypatch):
    """The HBM ledger's ``graph_pool`` is the card's: on the CPU the
    programs run without a graph and the category is absent."""
    monkeypatch.setenv("HBM_LEDGER", "1")
    params, cfg = models("bf16")
    eng = _engine(params, cfg)
    eng.warmup()
    assert len(eng._programs) == 3
    assert "graph_pool" not in eng.debug_hbm()["categories"]
    eng.stop()
    assert "graph_pool" not in eng.debug_hbm()["categories"]


class _OneFault:
    """Chaos that faults the n-th ragged dispatch once, then disarms."""

    def __init__(self, eng, n):
        self.mk = ChaosMonkey(ChaosConfig(seed=1, dispatch_fail=1.0))
        self.eng, self.n, self.seen = eng, n, 0
        orig = self.mk.on_dispatch

        def nth(site, rids=()):
            if site != "ragged":
                return None
            self.seen += 1
            if self.seen == self.n:
                eng._chaos = None
                return orig(site, rids)
            return None

        self.mk.on_dispatch = nth
        eng._chaos = self.mk


@pytest.mark.parametrize("case", ["bf16", "int8kv"])
def test_heal_resets_the_state_in_place(models, case):
    """A wave fault mid-burst under heal: the recovery resets the state
    the programs hold in place (the same tensors, the same program
    objects as after warmup) and the delivered streams equal the clean
    run's."""
    params, cfg = models(case)
    prompts = _prompts(cfg)
    clean = _burst(params, cfg, prompts, "pallas")["streams"]
    eng = _engine(params, cfg, heal=True, heal_max_retries=4)
    eng.warmup()
    progs = {k: eng._programs.get(k) for k in eng._programs.keys()}
    home = eng._programs.home
    fields = {k: v for k, v in home.items() if k != "cache"}
    in_place = []
    rebuild = eng._rebuild_device_state

    def rebuilt():
        rebuild()
        # Right after the rebuild: home's tensors, at their initial values.
        in_place.append(
            all(eng._state[k] is v for k, v in fields.items())
            and all(eng._state["cache"][k] is v
                    for k, v in home["cache"].items())
            and not eng._state["active"].any()
            and not eng._state["cache"]["k"].any())

    eng._rebuild_device_state = rebuilt
    _OneFault(eng, 6)
    qs = _submit(eng, prompts)
    eng.start()
    try:
        streams = [drain(q) for q in qs]
        assert eng._heal.recoveries >= 1 and in_place and all(in_place)
        assert {k: eng._programs.get(k) for k in eng._programs.keys()} \
            == progs
        assert eng._programs.home is home
        assert all(eng._state[k] is v for k, v in fields.items())
    finally:
        eng.stop()
    assert streams == clean


@pytest.mark.parametrize("leg", ["sparse", "reference"])
def test_no_programs_on_the_eager_legs(models, leg):
    params, cfg = models("bf16")
    eng = _engine(params, cfg, "sparse")
    eng._kernel = leg  # "reference" is a diagnostic leg the config refuses
    qs = _submit(eng, engine_prompts(cfg)[:3])
    eng.start()
    try:
        streams = [drain(q) for q in qs]
        assert len(eng._programs) == 0 and eng._programs.runs == 0
    finally:
        eng.stop()
    assert all(streams)


def test_no_programs_in_a_rank_group():
    """tp = 2 on two spawned CPU ranks: the engine holds no programs."""
    from seldon_tpu_torch.servers.torchserver import TorchServer

    srv = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                      prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                      tp=2, device="cpu")
    try:
        out = srv.generate({"prompt": "abc", "max_new_tokens": 3,
                            "temperature": 0.0})["token_ids"]
        assert out and srv.engine._programs is None
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_tiny():
    return params_pair(JPRESETS["tiny"], seed=0)


@pytest.mark.parametrize("leg", ["masked", "pallas"])
def test_programs_match_the_jax_engine(jax_tiny, leg):
    """The port's engine with its programs (the default) against the JAX
    engine's masked leg on the same weights and burst, greedy and
    sampled."""
    jparams, tparams = jax_tiny
    cfg_t, cfg_j = TPRESETS["tiny"], JPRESETS["tiny"]
    prompts = engine_prompts(cfg_t)
    for knobs in KNOBS:
        want = run_jax_engine(jparams, cfg_j, prompts, knobs)
        eng = teng.InferenceEngine(
            tparams, cfg_t,
            teng.EngineConfig(**dict(ENGINE_ECFG, ragged_kernel=leg)),
            device="cpu")
        eng.start()
        try:
            qs = [eng.submit(p, SamplingParams(seed=i, **knobs))
                  for i, p in enumerate(prompts)]
            got = [drain(q) for q in qs]
        finally:
            eng.stop()
        assert eng._programs.runs > 0
        assert_streams_match(got, want, jparams, cfg_j, prompts,
                             f"programs {leg}", knobs)
