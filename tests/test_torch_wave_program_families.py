"""seldon_tpu_torch.servers.wave_program on every single-rank family:
the bucketed, dense and chunked engines, both prefix caches and the
spec engine's verify and draft waves as captured programs, held on the
CPU, where a program runs the same body on the same static buffers
without a graph (the card's capture and replay:
tests/test_torch_wave_program_cuda.py and chip_smoke.py).

 * The program route against the eager route (``wave_program.disabled``)
   over one mixed burst per configuration (the dense slab, with
   ``attn_impl="flash"`` too; paged; chunked dense and paged; the dense
   and paged prefix caches with warm hits, the chunked dense seed and a
   copy-on-write copy; spec on the masked and kernel legs with the
   n-gram and model drafters, a block budget on the kernel leg; bf16
   and int8 KV): every boundary's host arrays, the streams and the
   final state bit-equal, and every program key in the lattice.
 * Two admission groups of one key in one boundary: each group's first
   tokens outlive the next run of the same program.
 * A lazy capture mid-burst on the dense slab and on the paged pool,
   with the card's warm run done on the CPU: the streams, the cache and
   the per-slot fields equal the eager route's.
 * ``warmup`` prepares exactly the keys of ``dispatch_keys``, one
   program per branch, and a burst after it prepares nothing new.
 * A forced heal recovery on a bucketed engine keeps its programs.
 * No programs on the sparse and reference legs nor in a rank group.
 * The captured bucketed and spec engines against the JAX engine
   (spec-off: the JAX spec tests are red, ROADMAP.md) under the repo's
   near-tie rule, with JAX's copying ``jnp.asarray`` (ROADMAP.md C3).

Bit-equality everywhere but the last."""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from seldon_tpu.models.config import PRESETS as JPRESETS
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import shape_lattice, wave_program
from seldon_tpu_torch.servers.chaos import ChaosConfig, ChaosMonkey
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)
from torch_port_helpers import (assert_streams_match, drain, params_pair,
                                run_jax_engine)

NEW = 6
BASE = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32, 64),
            max_admit=2, decode_chunk=4, min_chunk=2, prefix_block=8,
            async_fetch=False)
PAGED = dict(paged_kv=True, kv_block=8)
CHUNKED = dict(chunked_prefill=True, prefill_chunk=16)
SPEC = dict(PAGED, spec_decode=True, spec_k=4)
# name -> (engine config, model case, a model drafter)
CONFIGS = {
    "dense": (BASE, "bf16", False),
    "dense-flash": (BASE, "flash", False),
    "dense-int8": (BASE, "int8kv", False),
    "paged": (dict(BASE, **PAGED), "bf16", False),
    "paged-int8-flash": (dict(BASE, **PAGED), "int8kv-flash", False),
    "chunked-dense": (dict(BASE, **CHUNKED), "bf16", False),
    "chunked-paged": (dict(BASE, **CHUNKED, **PAGED), "bf16", False),
    "prefix-dense": (dict(BASE, prefix_cache=True), "bf16", False),
    "prefix-dense-chunked": (dict(BASE, prefix_cache=True, **CHUNKED),
                             "bf16", False),
    # kv_block 16 over prefix_block 8: a hit ending mid-block copies it.
    "prefix-paged-cow": (dict(BASE, prefix_cache=True, paged_kv=True,
                              kv_block=16), "bf16", False),
    "spec-ngram-masked": (dict(BASE, **SPEC, ragged_kernel="masked"),
                          "bf16", False),
    "spec-ngram-pallas": (dict(BASE, **SPEC, ragged_kernel="pallas",
                               ragged_block_budget=4), "bf16", False),
    "spec-model-pallas": (dict(BASE, **SPEC, ragged_kernel="pallas"),
                          "bf16", True),
    "spec-model-int8": (dict(BASE, **SPEC, ragged_kernel="masked"),
                        "int8kv", True),
}
KNOBS = [dict(temperature=0.0, max_new_tokens=NEW),
         dict(temperature=0.9, top_k=8, top_p=0.95, max_new_tokens=NEW)]
# A shared 24-token head (three prefix blocks) on the first six prompts:
# the later groups hit the trie the earlier ones filled. The first four
# bucket alike, so the first boundary admits two groups of one key.
SUFFIXES = [4, 6, 2, 7, 30, 12]
OTHERS = [9, 3]


def _prompts(cfg, seed=31):
    rng = np.random.default_rng(seed)
    head = rng.integers(3, cfg.vocab_size, size=(24,)).tolist()
    out = [head + rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
           for n in SUFFIXES]
    return out + [rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
                  for n in OTHERS]


def _model(case):
    cfg = TPRESETS["tiny"]
    if "int8kv" in case:
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if "flash" in case:
        cfg = dataclasses.replace(cfg, attn_impl="flash")
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     "cpu")
    return params, cfg


@pytest.fixture(scope="module")
def models():
    cache = {}

    def get(case):
        if case not in cache:
            cache[case] = _model(case)
        return cache[case]
    return get


def _engine(models, name, **kw):
    ecfg, case, drafter = CONFIGS[name]
    params, cfg = models(case)
    draft = None
    if drafter:
        dcfg = TPRESETS["tiny"]
        draft = (transformer.init_params(
            dcfg, torch.Generator().manual_seed(11), "cpu"), dcfg)
    return teng.InferenceEngine(params, cfg, teng.EngineConfig(
        **dict(ecfg, **kw)), device="cpu", draft=draft)


def _state_arrays(state):
    out = {k: v.clone() for k, v in state.items() if k != "cache"}
    out.update({f"cache.{k}": v.clone() for k, v in state["cache"].items()})
    return out


class _Spy:
    """Each boundary's host arrays and the keys dispatched before it."""

    def __init__(self, eng):
        self.waves, self.keys, self.boundary = [], [], []
        copy, dispatch = eng._host_copy, eng._dispatch

        def recorded(tensors):
            host = copy(tensors)
            self.waves.append([t.numpy().copy() for t in host.arrays])
            self.keys.append(self.boundary)
            self.boundary = []
            return host

        def spied(key, *args, **kw):
            self.boundary.append(key)
            return dispatch(key, *args, **kw)

        eng._host_copy, eng._dispatch = recorded, spied


def _burst(eng, prompts, eager=False):
    """``prompts`` queued before start (the sync loop then schedules the
    same boundaries on both routes). Returns the streams, the spy, the
    final state, the program keys and runs, and B2's launches."""
    spy = _Spy(eng)
    qs = [eng.submit(p, SamplingParams(seed=i, **KNOBS[i % len(KNOBS)]))
          for i, p in enumerate(prompts)]
    with wave_program.disabled() if eager else contextlib.nullcontext():
        eng.start()
        try:
            streams = [drain(q) for q in qs]
            keys = eng._programs.keys()
        finally:
            eng.stop()
    assert eng.debug_lifecycle_check() == {}
    return dict(streams=streams, spy=spy, state=_state_arrays(eng._state),
                keys=keys, runs=eng._programs.runs, stats=eng.stats.snapshot())


def _assert_same(got, want):
    assert got["streams"] == want["streams"]
    assert got["spy"].keys == want["spy"].keys
    assert len(got["spy"].waves) == len(want["spy"].waves) > 0
    for i, (g, w) in enumerate(zip(got["spy"].waves, want["spy"].waves)):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"boundary {i}")
    assert got["state"].keys() == want["state"].keys()
    for k in got["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k


@pytest.mark.parametrize("name", list(CONFIGS))
def test_programs_equal_the_eager_route(models, name):
    """Every boundary's first tokens, first-done flags, decode or verify
    tokens, valid rows and active mask, the dispatched keys, the streams
    and the final cache and per-slot fields, bit for bit; every program
    key is in the lattice, with the branch its family takes."""
    eng = _engine(models, name)
    prompts = _prompts(eng.cfg)
    got = _burst(eng, prompts)
    want = _burst(_engine(models, name), prompts, eager=True)
    _assert_same(got, want)
    assert want["keys"] == [] and want["runs"] == 0
    assert got["runs"] >= sum(len(k) for k in got["spy"].keys) > 0
    lattice = shape_lattice.dispatch_keys(eng.lattice_spec())
    assert {k for k, _ in got["keys"]} <= lattice
    kinds = {k[0] for k, _ in got["keys"]}
    for (key, branch) in got["keys"]:
        if key[0] == "verify":
            assert branch in (("masked",), ("pallas",))
        else:
            assert branch == ()
    s = got["stats"]
    if "prefix" in name:
        assert s["prefix_hits"] > 0
    if name == "prefix-paged-cow":
        assert ("cow",) in {k for k, _ in got["keys"]}
    if name == "prefix-dense-chunked":
        assert "seed-prefix" in kinds
    if name == "spec-ngram-pallas":
        # Both sides of the budget: the kernel leg and the masked head.
        assert {b for k, b in got["keys"] if k[0] == "verify"} == {
            ("masked",), ("pallas",)}
    if name.startswith("spec-model"):
        assert "draft" in kinds


@pytest.mark.parametrize("name", ["dense", "paged"])
def test_two_groups_of_one_key_in_one_boundary(models, name):
    """The first boundary admits two groups at one key; each group's
    first tokens are copied out of the program's static outputs before
    the second group's run overwrites them: the burst equals the eager
    one, and two runs of one admission program, both outputs held, equal
    two eager runs."""
    eng = _engine(models, name)
    prompts = _prompts(eng.cfg)
    got = _burst(eng, prompts)
    first = got["spy"].keys[0]
    admits = [k for k in first if k[0].startswith("admit")]
    assert len(admits) == 2 and admits[0] == admits[1]
    _assert_same(got, _burst(_engine(models, name), prompts, eager=True))

    def two_runs(eager):
        e = _engine(models, name)
        Sb = 16
        outs = []
        with wave_program.disabled() if eager else contextlib.nullcontext():
            for g, slots in enumerate(([0, 1], [2, 3])):
                toks = np.array([[5 + g + 7 * i] * Sb for i in range(2)],
                                np.int32)
                a = [toks, np.full((2,), 9 + g, np.int32),
                     np.zeros((2,), np.int64), np.ones((2,), np.float32),
                     np.zeros((2,), np.int32), np.ones((2,), np.float32),
                     np.full((2,), NEW, np.int32),
                     np.array(slots, np.int32)]
                if e._paged:
                    table = np.zeros((2, e._nbs), np.int32)
                    table[:, :2] = np.array(slots)[:, None] * 2 + [1, 2]
                    outs.append(e._dispatch(
                        ("admit-paged", Sb, 2, 0), "_paged_admit_impl",
                        [table, a[0], a[1], np.zeros((2,), np.int32),
                         *a[2:]], fresh=2, prefix_width=0))
                else:
                    outs.append(e._admit(*a))
        return [[t.clone() for t in o[:2]] for o in outs], e._programs.runs

    got2, runs = two_runs(False)
    want2, _ = two_runs(True)
    assert runs == 2
    for g, w in zip(got2, want2):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    assert not torch.equal(got2[0][0], got2[1][0])


@pytest.mark.parametrize("name", ["dense", "chunked-dense",
                                  "prefix-dense-chunked", "paged"])
def test_lazy_capture_mid_burst(models, name, monkeypatch):
    """Programs made in the middle of traffic, each with the card's warm
    run (the body once on its first run's own inputs against a copy of
    the per-slot fields and the live cache) before its first run: the
    first dispatches run eagerly, so every program is made while slots
    are live. The streams, the cache and the per-slot fields equal the
    eager route's: the warm run writes no live slot."""
    made = []
    make = wave_program.Programs._make

    def warm_then_make(self, prog):
        made.append(prog.key)
        prog.warm()
        make(self, prog)

    monkeypatch.setattr(wave_program.Programs, "_make", warm_then_make)
    eng = _engine(models, name)
    n = [0]
    captured = eng._captured

    def late():
        n[0] += 1
        return n[0] > 4 and captured()

    eng._captured = late
    prompts = _prompts(eng.cfg)
    got = _burst(eng, prompts)
    want = _burst(_engine(models, name), prompts, eager=True)
    assert len(made) == len(got["keys"]) > 1
    assert got["streams"] == want["streams"]
    for k in want["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k


@pytest.mark.parametrize("name", [
    "dense", "paged", "chunked-dense", "chunked-paged", "prefix-dense",
    "prefix-dense-chunked", "prefix-paged-cow", "spec-ngram-pallas",
    "spec-model-pallas"])
def test_warmup_prepares_the_lattice(models, name):
    """``warmup`` makes one program per key of ``dispatch_keys`` and per
    branch (the verify rungs on the kernel leg under a block budget
    below the table take both), and a burst after it makes none."""
    eng = _engine(models, name)
    eng.warmup()
    keys = eng._programs.keys()
    lattice = shape_lattice.dispatch_keys(eng.lattice_spec())
    assert {k for k, _ in keys} == lattice
    want = len(lattice)
    if name == "spec-ngram-pallas":
        want += len(eng._spec_rungs)
        assert {b for k, b in keys if k[0] == "verify"} == {("masked",),
                                                             ("pallas",)}
    assert len(keys) == want
    progs = {k: eng._programs.get(k) for k in keys}
    qs = [eng.submit(p, SamplingParams(seed=i, max_new_tokens=4))
          for i, p in enumerate(_prompts(eng.cfg)[:4])]
    eng.start()
    try:
        for q in qs:
            drain(q)
        assert {k: eng._programs.get(k) for k in eng._programs.keys()} \
            == progs
    finally:
        eng.stop()


class _OneFault:
    """Chaos that faults the n-th dispatch at ``site`` once."""

    def __init__(self, eng, site, n):
        self.mk = ChaosMonkey(ChaosConfig(seed=1, dispatch_fail=1.0))
        self.seen = 0
        orig = self.mk.on_dispatch

        def nth(s, rids=()):
            if s != site:
                return None
            self.seen += 1
            if self.seen == n:
                eng._chaos = None
                return orig(s, rids)
            return None

        self.mk.on_dispatch = nth
        eng._chaos = self.mk


@pytest.mark.parametrize("name", ["dense", "spec-ngram-pallas"])
def test_heal_keeps_the_programs(models, name):
    """A decode-site fault mid-burst under heal: the recovery resets the
    state in place (the same tensors and program objects as after
    warmup) and the delivered streams equal the clean run's."""
    prompts = _prompts(TPRESETS["tiny"])
    clean = _burst(_engine(models, name), prompts)["streams"]
    eng = _engine(models, name, heal=True, heal_max_retries=4)
    eng.warmup()
    progs = {k: eng._programs.get(k) for k in eng._programs.keys()}
    home = eng._programs.home
    _OneFault(eng, "decode", 3)
    qs = [eng.submit(p, SamplingParams(seed=i, **KNOBS[i % len(KNOBS)]))
          for i, p in enumerate(prompts)]
    eng.start()
    try:
        streams = [drain(q) for q in qs]
        assert eng._heal.recoveries >= 1
        assert {k: eng._programs.get(k) for k in eng._programs.keys()} \
            == progs
        assert eng._programs.home is home
    finally:
        eng.stop()
    assert streams == clean


@pytest.mark.parametrize("leg", ["sparse", "reference"])
def test_no_programs_on_the_eager_legs(models, leg):
    eng = _engine(models, "spec-ngram-pallas", ragged_kernel="sparse")
    eng._kernel = leg  # "reference" is a diagnostic leg the config refuses
    got = _burst(eng, _prompts(eng.cfg)[:4])
    assert got["keys"] == [] and got["runs"] == 0
    assert all(got["streams"])


def test_no_programs_in_a_bucketed_rank_group():
    """tp = 2 on two spawned CPU ranks, the dense bucketed engine."""
    from seldon_tpu_torch.servers.torchserver import TorchServer

    srv = TorchServer(preset="tiny", max_slots=2, max_seq_len=64, tp=2,
                      device="cpu")
    try:
        out = srv.generate({"prompt": "abc", "max_new_tokens": 3,
                            "temperature": 0.0})["token_ids"]
        assert out and srv.engine._programs is None
    finally:
        srv.stop()


@pytest.fixture(scope="module")
def jax_tiny():
    return params_pair(JPRESETS["tiny"], seed=0)


@pytest.mark.parametrize("name,ref", [
    ("paged", "paged"), ("dense", "dense"),
    ("spec-ngram-pallas", "paged")])
def test_programs_match_the_jax_engine(jax_tiny, name, ref):
    """The captured engine against the JAX engine on the same weights
    and burst (every request queued before start, the JAX engine with a
    copying ``jnp.asarray``), greedy and sampled: the spec engine against
    JAX's spec-off paged engine, whose streams its verify waves
    reproduce."""
    jparams, tparams = jax_tiny
    cfg_t, cfg_j = TPRESETS["tiny"], JPRESETS["tiny"]
    ecfg = CONFIGS[name][0]
    prompts = _prompts(cfg_t)
    for knobs in KNOBS:
        want = run_jax_engine(jparams, cfg_j, prompts, knobs,
                              CONFIGS[ref][0])
        eng = teng.InferenceEngine(tparams, cfg_t, teng.EngineConfig(**ecfg),
                                   device="cpu")
        qs = [eng.submit(p, SamplingParams(seed=i, **knobs))
              for i, p in enumerate(prompts)]
        eng.start()
        try:
            got = [drain(q) for q in qs]
        finally:
            eng.stop()
        assert eng._programs.runs > 0
        assert_streams_match(got, want, jparams, cfg_j, prompts,
                             f"programs {name}", knobs)
