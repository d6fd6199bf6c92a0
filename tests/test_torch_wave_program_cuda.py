"""The converged engine's captured programs on the card
(``servers/wave_program.py``): each ``("ragged", C)`` branch and
``("deactivate",)`` captured as a CUDA graph and replayed. Marked `cuda`;
skipped where there is no card.

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
 * ``release()`` returns the graph pool's reserved bytes, and the HBM
   ledger's ``graph_pool`` holds them while the programs exist.
 * Each program stages its descriptors through one pinned buffer per
   input, kept across runs.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from seldon_tpu_torch.models import quantize, ragged_attention, transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import lt_gemm
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import wave_program

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
def test_release_returns_the_pool(cuda):
    """The programs' shared graph pool holds segments after a warmup;
    ``stop()`` releases them and the card's reserved bytes fall by at
    least the pool's."""
    params, cfg = _model("bf16", cuda)
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(
        **ECFG, ragged_kernel="pallas", ragged_block_budget=BUDGET), cuda)
    eng.warmup()
    assert eng._programs.captures == len(eng._programs) == 7
    pool = eng._programs.pool_bytes()
    assert pool > 0
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(cuda)
    eng.stop()
    assert len(eng._programs) == 0 and eng._programs.pool_bytes() == 0
    assert reserved - torch.cuda.memory_reserved(cuda) >= pool


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
def test_staging_keeps_one_pinned_buffer_per_input(cuda):
    """A program's runs stage through the same pinned buffers, each
    holding the last run's descriptors."""
    params, cfg = _model("bf16", cuda)
    eng = teng.InferenceEngine(params, cfg, teng.EngineConfig(
        **ECFG, ragged_kernel="pallas"), cuda)
    keep = np.ones((ECFG["max_slots"],), bool)
    eng._deactivate(keep)
    prog = eng._programs.get((("deactivate",), ()))
    staging = list(prog._staging)
    assert all(t.is_pinned() for t in staging)
    keep[1] = False
    eng._deactivate(keep)
    assert [t.data_ptr() for t in prog._staging] == \
        [t.data_ptr() for t in staging]
    torch.cuda.synchronize()
    assert prog._staging[0].numpy().tolist() == keep.tolist()
    assert prog.inputs[0].cpu().numpy().tolist() == keep.tolist()
    eng.stop()
