"""A single-rank engine's captured programs on the card
(``servers/wave_program.py``): each ``("ragged", C)`` branch,
``("deactivate",)`` and every family of the bucketed, dense, chunked,
prefix and spec engines captured as a CUDA graph and replayed. Marked
`cuda`; skipped where there is no card.

This file imports neither jax nor the JAX package, so it runs on a
machine with only PyTorch for CUDA (the repo's conftest imports jax;
skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_wave_program_cuda.py

 * Captured against eager (``wave_program.disabled``) on tiny, bit for
   bit: every wave's host arrays, the streams, the final pool (but its
   trash block, which a capture's warm run writes) and per-slot fields;
   the kernel leg with and without a block budget, the
   masked leg, int8 KV, W8A8 and float32.
 * The launch counters (B1, cuBLASLt, ``torch._int_mm``) equal between
   the routes: a replay counts what the captured body launched.
 * A host read inside a capture raises (``rpa.live_columns`` without
   n_live, ``ragged_wave`` without has_prefill, a cuBLASLt plan miss).
 * The other families, captured against eager on tiny, bit for bit
   (every boundary's host arrays, the streams, the final cache but the
   paged pool's trash block, the per-slot fields): the dense slab and
   the paged pool under ``attn_impl="flash"`` (B2 in every cold
   admission, counted per replay and never per capture: layers x cold
   admissions on both routes), chunked, both prefix caches with warm
   hits and a copy-on-write copy, spec on both legs with the n-gram and
   model drafters; and a lazy capture mid-burst on the dense slab.
 * ``release()`` returns the graph pool's reserved bytes, and the HBM
   ledger's ``graph_pool`` holds them while the programs exist; engines
   built and stopped one after another leave no card memory behind.
 * Each program stages its host descriptors through pinned memory into
   its static inputs, which hold the last run's values.
"""

import contextlib
import dataclasses
import gc

import numpy as np
import pytest
import torch

from seldon_tpu_torch.models import quantize, ragged_attention, transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import flash_attention as fa
from seldon_tpu_torch.ops import lt_gemm
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import shape_lattice, wave_program

ECFG = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32, 64),
            paged_kv=True, kv_block=8, kv_pool_blocks=4 * 8 + 1,
            chunked_prefill=True, prefill_chunk=16, prefix_block=8,
            ragged=True, async_fetch=False)
LENGTHS = [12, 26, 7, 40, 16, 3]
KNOBS = [dict(temperature=0.0, max_new_tokens=6),
         dict(temperature=0.9, top_k=8, top_p=0.95, max_new_tokens=6)]
BUDGET = 2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_wave_program_cuda.py")
    return torch.device("cuda")


def _model(case, dev):
    cfg = get_config("tiny")
    if case == "int8kv":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if case == "f32":
        cfg = dataclasses.replace(cfg, dtype="float32")
    if case == "w8a8":
        cfg = dataclasses.replace(cfg, weight_dtype="int8", act_dtype="int8")
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(3), dev)
    if case == "w8a8":
        params = quantize.quantize_params(params)
    return params, cfg


def _counts():
    return (rpa.launches, lt_gemm.launches, transformer.int_mm_launches)


def _burst(params, cfg, dev, kernel, budget, eager):
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(
        **ECFG, ragged_kernel=kernel, ragged_block_budget=budget), dev)
    waves = []
    orig = eng._host_copy

    def recorded(tensors):
        host = orig(tensors)
        waves.append(host)
        return host

    eng._host_copy = recorded
    rng = np.random.default_rng(29)
    prompts = [rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
               for n in LENGTHS]
    qs = [eng.submit(p, SamplingParams(seed=i, **KNOBS[i % 2]))
          for i, p in enumerate(prompts)]
    c0 = _counts()
    ctx = wave_program.disabled() if eager else contextlib.nullcontext()
    with ctx:
        eng.start()
        try:
            streams = []
            for q in qs:
                toks = []
                while (item := q.get(timeout=300)) is not None:
                    assert "error" not in item, item
                    toks.extend(item["tokens"])
                streams.append(toks)
            keys = eng._programs.keys()
            captures = eng._programs.captures
        finally:
            eng.stop()
    torch.cuda.synchronize()
    counts = tuple(b - a for a, b in zip(c0, _counts()))
    state = {k: v.cpu() for k, v in eng._state.items() if k != "cache"}
    # Block 0 is the trash block: a capture's warm run writes it too.
    state.update({f"cache.{k}": v[:, 1:].cpu()
                  for k, v in eng._state["cache"].items()})
    return dict(streams=streams, waves=[h.wait() for h in waves],
                state=state, counts=counts, keys=keys, captures=captures)


@pytest.mark.cuda
@pytest.mark.parametrize("case,kernel,budget", [
    ("bf16", "pallas", 0), ("bf16", "pallas", BUDGET), ("bf16", "masked", 0),
    ("int8kv", "pallas", BUDGET), ("w8a8", "pallas", 0),
    ("f32", "pallas", 0)])
def test_captured_equals_eager(cuda, case, kernel, budget):
    """Replays against the eager wave, bit for bit, and the counters
    equal: B1 (the kernel leg launches it), cuBLASLt, and W8A8's
    ``torch._int_mm``."""
    params, cfg = _model(case, cuda)
    got = _burst(params, cfg, cuda, kernel, budget, eager=False)
    want = _burst(params, cfg, cuda, kernel, budget, eager=True)
    assert got["streams"] == want["streams"]
    assert len(got["waves"]) == len(want["waves"]) > 0
    for i, (g, w) in enumerate(zip(got["waves"], want["waves"])):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"wave {i}")
    for k in want["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k
    assert got["counts"] == want["counts"]
    assert got["captures"] == len(got["keys"]) > 0
    assert want["keys"] == [] and want["captures"] == 0
    b1, gemm, int_mm = got["counts"]
    assert (b1 > 0) == (kernel == "pallas")
    assert gemm > 0
    assert (int_mm > 0) == (case == "w8a8")


@contextlib.contextmanager
def _capture():
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(side):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


@pytest.mark.cuda
def test_host_reads_raise_inside_a_capture(cuda):
    bound = torch.ones((4, 1), dtype=torch.int32, device=cuda)
    assert rpa.live_columns(bound, 8, 8) == 1  # eager: reads the card
    flags = torch.zeros((4,), dtype=torch.bool, device=cuda)
    x = torch.ones((3, 64), dtype=torch.bfloat16, device=cuda)
    w = torch.ones((64, 40), dtype=torch.bfloat16, device=cuda)
    lt_gemm.matmul(x[:1], w, tps=(1,))  # the handle, outside a capture
    with _capture():
        with pytest.raises(RuntimeError, match="captured wave"):
            rpa.live_columns(bound, 8, 8)
        with pytest.raises(RuntimeError, match="captured wave"):
            ragged_attention.ragged_wave(
                None, None, None, None, None, None, None, None, None, None,
                None, None, flags, None, kernel="pallas", has_prefill=None)
        with pytest.raises(RuntimeError, match="captured wave"):
            lt_gemm.matmul(x, w, tps=(1,))  # a shape no run planned


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["ragged", "spec"])
def test_release_returns_the_pool(cuda, family):
    """The programs' shared graph pool holds segments after a warmup (one
    program per lattice key and branch); ``stop()`` releases them and
    the card's reserved bytes fall by at least the pool's."""
    params, cfg = _model("bf16", cuda)
    ecfg = (dict(ECFG) if family == "ragged" else
            dict(FAMILY_BASE, **FAMILY_SPEC))
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(
        **ecfg, ragged_kernel="pallas", ragged_block_budget=BUDGET), cuda)
    eng.warmup()
    n = (7 if family == "ragged" else
         len(shape_lattice.dispatch_keys(eng.lattice_spec()))
         + len(eng._spec_rungs))
    assert eng._programs.captures == len(eng._programs) == n
    pool = eng._programs.pool_bytes()
    assert pool > 0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(cuda)
    eng.stop()
    assert len(eng._programs) == 0 and eng._programs.pool_bytes() == 0
    assert reserved - torch.cuda.memory_reserved(cuda) >= pool


@pytest.mark.cuda
def test_engines_leave_no_card_memory_behind(cuda):
    """Captured engines built, run and stopped one after another leave
    the card's allocated bytes where the first left them: every engine
    captures on the process's one side stream, so cuBLAS keeps no new
    workspace (32 MiB per handle and stream) per engine."""
    def one():
        _family_burst("chunked-paged", cuda, eager=False)
        gc.collect()
        torch.cuda.synchronize()
        return torch.cuda.memory_allocated(cuda)

    first = one()
    for _ in range(3):
        assert one() <= first


@pytest.mark.cuda
def test_ledger_counts_the_pool(cuda, monkeypatch):
    """With the HBM ledger armed, ``graph_pool`` is a static category
    holding the pool's bytes after warmup, and 0 once ``stop()`` has
    released the programs."""
    monkeypatch.setenv("HBM_LEDGER", "1")
    params, cfg = _model("bf16", cuda)
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(
        **ECFG, ragged_kernel="pallas"), cuda)
    eng.warmup()
    cat = eng.debug_hbm()["categories"]["graph_pool"]
    assert cat["static"] and cat["bytes"] == eng._programs.pool_bytes() > 0
    eng.stop()
    assert eng.debug_hbm()["categories"]["graph_pool"]["bytes"] == 0


@pytest.mark.cuda
def test_staging_fills_the_static_inputs(cuda):
    """A program's runs stage into the same static inputs, each holding
    the last run's descriptors; two runs of one program in a row (two
    admission groups of one key) each see their own."""
    params, cfg = _model("bf16", cuda)
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(
        **ECFG, ragged_kernel="pallas"), cuda)
    keep = np.ones((ECFG["max_slots"],), bool)
    eng._deactivate(keep)
    prog = eng._programs.get((("deactivate",), ()))
    inputs = [t.data_ptr() for t in prog.inputs]
    keep[1] = False
    eng._deactivate(keep)
    assert [t.data_ptr() for t in prog.inputs] == inputs
    torch.cuda.synchronize()
    assert prog.inputs[0].cpu().numpy().tolist() == keep.tolist()
    assert eng._state["active"].cpu().tolist() == [False] * 4
    eng.stop()


# The other families on tiny (tests/test_torch_wave_program_families.py
# holds the same configurations on the CPU).
FAMILY_BASE = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32, 64),
                   max_admit=2, decode_chunk=4, min_chunk=2, prefix_block=8,
                   async_fetch=False)
FAMILY_PAGED = dict(paged_kv=True, kv_block=8)
FAMILY_SPEC = dict(FAMILY_PAGED, spec_decode=True, spec_k=4)
FAMILIES = {
    "dense-flash": (dict(FAMILY_BASE), "flash", False),
    "paged-flash": (dict(FAMILY_BASE, **FAMILY_PAGED), "flash", False),
    "dense-int8": (dict(FAMILY_BASE), "int8kv", False),
    "chunked-paged": (dict(FAMILY_BASE, **FAMILY_PAGED,
                           chunked_prefill=True, prefill_chunk=16), "bf16",
                      False),
    "prefix-dense-chunked": (dict(FAMILY_BASE, prefix_cache=True,
                                  chunked_prefill=True, prefill_chunk=16),
                             "bf16", False),
    "prefix-dense": (dict(FAMILY_BASE, prefix_cache=True), "bf16", False),
    "prefix-paged-cow": (dict(FAMILY_BASE, prefix_cache=True, paged_kv=True,
                              kv_block=16), "bf16", False),
    "spec-ngram-pallas": (dict(FAMILY_BASE, **FAMILY_SPEC,
                               ragged_kernel="pallas",
                               ragged_block_budget=4), "bf16", False),
    "spec-ngram-masked": (dict(FAMILY_BASE, **FAMILY_SPEC), "f32", False),
    "spec-model-pallas": (dict(FAMILY_BASE, **FAMILY_SPEC,
                               ragged_kernel="pallas"), "int8kv", True),
}


def _family_model(case, dev):
    if case != "flash":
        return _model(case, dev)
    cfg = dataclasses.replace(get_config("tiny"), attn_impl="flash")
    return transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(3), dev), cfg


def _family_prompts(cfg):
    rng = np.random.default_rng(31)
    head = rng.integers(3, cfg.vocab_size, size=(24,)).tolist()
    return ([head + rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
             for n in (4, 6, 2, 7, 30, 12)]
            + [rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
               for n in (9, 3)])


def _family_burst(name, dev, eager, late=0):
    """One burst of ``name``'s configuration, every request queued before
    start; with ``late``, the first ``late`` dispatches run eagerly, so
    the programs are made while slots are live."""
    ecfg, case, drafter = FAMILIES[name]
    params, cfg = _family_model(case, dev)
    draft = None
    if drafter:
        dcfg = get_config("tiny")
        draft = (transformer.init_params(
            dcfg, torch.Generator(device=dev).manual_seed(11), dev), dcfg)
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(**ecfg), dev,
                               draft=draft)
    if late:
        n, captured = [0], eng._captured

        def later():
            n[0] += 1
            return n[0] > late and captured()
        eng._captured = later
    waves = []
    orig = eng._host_copy

    def recorded(tensors):
        host = orig(tensors)
        waves.append(host)
        return host

    eng._host_copy = recorded
    qs = [eng.submit(p, SamplingParams(seed=i, **KNOBS[i % 2]))
          for i, p in enumerate(_family_prompts(cfg))]
    b1, b2 = rpa.launches, fa.launches
    with wave_program.disabled() if eager else contextlib.nullcontext():
        eng.start()
        try:
            streams = []
            for q in qs:
                toks = []
                while (item := q.get(timeout=300)) is not None:
                    assert "error" not in item, item
                    toks.extend(item["tokens"])
                streams.append(toks)
            keys = eng._programs.keys()
            captures = eng._programs.captures
        finally:
            eng.stop()
    torch.cuda.synchronize()
    state = {k: v.cpu() for k, v in eng._state.items() if k != "cache"}
    # A paged pool's block 0 is the trash block, which rows outside a
    # family's writes scatter into in any order.
    state.update({f"cache.{k}": (v[:, 1:] if eng._paged else v).cpu()
                  for k, v in eng._state["cache"].items()})
    return dict(streams=streams, waves=[h.wait() for h in waves],
                state=state, keys=keys, captures=captures,
                b1=rpa.launches - b1, b2=fa.launches - b2,
                stats=eng.stats.snapshot(), n_layers=cfg.n_layers)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FAMILIES))
def test_families_captured_equal_eager(cuda, name):
    """Replays against the eager families, bit for bit, every key in the
    lattice; B1 and B2 launches equal on both routes, B2's = layers x
    cold admissions (a capture counts nothing, a replay what it
    launched)."""
    got = _family_burst(name, cuda, eager=False)
    want = _family_burst(name, cuda, eager=True)
    assert got["streams"] == want["streams"]
    assert len(got["waves"]) == len(want["waves"]) > 0
    for i, (g, w) in enumerate(zip(got["waves"], want["waves"])):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b, err_msg=f"boundary {i}")
    for k in want["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k
    assert want["keys"] == [] and want["captures"] == 0
    assert got["captures"] == len(got["keys"]) > 0
    assert (got["b1"], got["b2"]) == (want["b1"], want["b2"])
    if "flash" in name:
        assert got["b2"] == (got["n_layers"]
                             * got["stats"]["cold_admit_dispatches"]) > 0
    if "pallas" in name:
        assert got["b1"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["dense-flash", "prefix-dense-chunked"])
def test_lazy_dense_capture_mid_burst(cuda, name):
    """Programs made mid-burst on the dense slab (their warm runs beside
    live slots): the streams, the whole slab and the fields equal the
    eager route's."""
    got = _family_burst(name, cuda, eager=False, late=4)
    want = _family_burst(name, cuda, eager=True)
    assert got["captures"] > 1
    assert got["streams"] == want["streams"]
    for k in want["state"]:
        assert torch.equal(got["state"][k], want["state"][k]), k
