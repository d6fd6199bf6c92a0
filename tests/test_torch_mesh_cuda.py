"""Exact tensor parallelism on the card: two ranks sharing one card
(the explicit device list ``["cuda:0", "cuda:0"]``: gloo staged through
host buffers) serve ``tiny`` on the ragged kernel leg. Marked ``cuda``;
skipped where there is no card. This file imports neither jax nor the
JAX package, so it runs on a machine with only PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

The tp=2 greedy streams equal tp=1's, every worker's per-slot state
equals rank 0's, and B1 (the hand-written kernel) launched on both
ranks, once per layer per wave leg on each."""

import pytest
import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.servers import mesh_engine
from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

PROMPTS = [list(range(2, 2 + n)) for n in (5, 12, 24, 7)]
ECFG = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
            paged_kv=True, chunked_prefill=True, prefill_chunk=8,
            prefix_block=8, kv_block=8, ragged=True, ragged_kernel="pallas",
            async_fetch=False)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mesh_cuda.py")
    return torch.device("cuda", 0)


def _streams(eng):
    qs = [eng.submit(p, SamplingParams(temperature=0.0, max_new_tokens=8))
          for p in PROMPTS]
    eng.start()
    try:
        out = []
        for q in qs:
            toks = []
            while (item := q.get(timeout=300)) is not None:
                assert "error" not in item, item
                toks.extend(item["tokens"])
            out.append(toks)
        if isinstance(eng, mesh_engine.MeshEngine):
            eng.check_replicas()
        return out
    finally:
        eng.stop()


def _launches(worker):
    return rpa.launches


@pytest.mark.cuda
def test_tp2_on_one_card_equals_tp1(cuda):
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    want = _streams(InferenceEngine(params, cfg, EngineConfig(**ECFG),
                                    device=cuda))
    group = mesh_engine.spawn_group(
        mesh_engine.build_tp_mesh(2, ["cuda:0", "cuda:0"]))
    try:
        assert group.ranks.route == "staged"
        eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**ECFG),
                                     tp=2, group=group)
        before = rpa.launches, group.run(f"{__name__}:_launches")[0]
        got = _streams(eng)
        after = rpa.launches, group.run(f"{__name__}:_launches")[0]
    finally:
        group.close()
    assert got == want
    mine, theirs = after[0] - before[0], after[1] - before[1]
    assert mine > 0 and mine == theirs
    assert mine % cfg.n_layers == 0
