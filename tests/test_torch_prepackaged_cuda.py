"""The prepackaged servers, learned detectors, explainers and the runtime
sanitizer of seldon_tpu_torch on the card, against the port on the CPU.
Marked `cuda`; skipped where there is no card.

This file imports neither jax nor the JAX package, so it runs on a
machine with only PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_prepackaged_cuda.py

Tolerances: tree cursors bit-equal (the comparison is f32 on both
devices), probabilities within 1e-5; the sklearn head within 1e-5 of a
numpy f64 product even with the process's matmul precision lowered;
detector scores rtol 1e-4; IG within 1e-5; JAX's normal sampler's
uniform bit-equal and its values within 128 f32 ulps of the CPU's."""

import json

import numpy as np
import pytest
import torch

from seldon_tpu_torch.components import (IntegratedGradients,
                                         IsolationForestDetector,
                                         Seq2SeqLSTMDetector, VAEDetector)
from seldon_tpu_torch.models import prng, transformer
from seldon_tpu_torch.models.config import PRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine
from seldon_tpu_torch.servers.sklearnserver import (SKLearnServer,
                                                   export_linear_model)
from seldon_tpu_torch.servers.xgboostserver import XGBoostServer

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_prepackaged_cuda.py")
    return torch.device("cuda")


def _dump(rng, n_trees, depth, F):
    def node(nid, d):
        if d == depth:
            return {"nodeid": nid, "leaf": float(rng.normal())}
        yes, no = 2 * nid + 1, 2 * nid + 2
        return {"nodeid": nid, "split": f"f{int(rng.integers(F))}",
                "split_condition": float(np.float32(rng.normal())),
                "yes": yes, "no": no, "missing": no,
                "children": [node(yes, d + 1), node(no, d + 1)]}
    return [node(0, 0) for _ in range(n_trees)]


def test_xgboost_on_the_card(cuda, tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "model.json").write_text(json.dumps(
        {"trees": _dump(rng, 100, 6, 28), "objective": "binary:logistic",
         "base_score": 0.5}))
    X = rng.normal(size=(512, 28)).astype(np.float32)
    X[rng.random(X.shape) < 0.01] = np.nan
    dev = XGBoostServer(model_uri=str(tmp_path))
    host = XGBoostServer(model_uri=str(tmp_path), device="cpu")
    got, want = dev.predict(X, []), host.predict(X, [])
    assert dev.tags()["backend"] == "torch-trees"
    assert dev._trees.device.type == "cuda"
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(
        dev._trees.leaves(torch.from_numpy(X).to(cuda)).cpu().numpy(),
        host._trees.leaves(torch.from_numpy(X)).numpy())


def test_sklearn_head_keeps_full_f32_on_the_card(cuda, tmp_path):
    rng = np.random.default_rng(1)
    coef = rng.normal(size=(10, 784)) * 0.05
    intercept = rng.normal(size=10)
    export_linear_model(str(tmp_path), coef, intercept)
    X = rng.normal(size=(256, 784)).astype(np.float32)
    logits = X.astype(np.float64) @ coef.astype(np.float32).T.astype(
        np.float64) + intercept.astype(np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    oracle = e / e.sum(1, keepdims=True)
    srv = SKLearnServer(model_uri=str(tmp_path))
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 for others
        got = srv.predict(X, [])
    finally:
        torch.set_float32_matmul_precision(before)
    assert srv.tags()["backend"] == "torch"
    np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)


def test_detectors_on_the_card(cuda):
    rng = np.random.default_rng(2)
    X = rng.normal(size=(256, 41)).astype(np.float32)
    S = rng.normal(size=(64, 16, 3)).astype(np.float32)
    for det, data in (
            (IsolationForestDetector(seed=0).fit(X), X),
            (VAEDetector(seed=0).fit(X, epochs=2), X),
            (Seq2SeqLSTMDetector(hidden_dim=16, seed=0).fit(
                S, epochs=2, batch_size=32), S)):
        assert det.device.type == "cuda"
        host = type(det).from_jax_state(det.__getstate__(), device="cpu")
        np.testing.assert_allclose(det.predict(data, []),
                                   host.predict(data, []), rtol=1e-4)


def test_ig_on_the_card(cuda):
    rng = np.random.default_rng(3)
    W = torch.from_numpy(rng.normal(size=(20, 4)).astype(np.float32))
    X = rng.normal(size=(8, 20)).astype(np.float32)
    got = IntegratedGradients(lambda Z: torch.tanh(Z @ W.to(Z.device)),
                              steps=32).explain(X)
    want = IntegratedGradients(lambda Z: torch.tanh(Z @ W), steps=32,
                               device="cpu").explain(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_normal_on_the_card(cuda):
    shape = (64, 4096)
    lo = prng._NORMAL_LO
    k_host = prng.key(torch.tensor(5))
    k_dev = k_host.to(cuda)
    assert torch.equal(prng.uniform(k_dev, shape, lo, 1.0).cpu(),
                       prng.uniform(k_host, shape, lo, 1.0))
    a = prng.normal(k_dev, shape).cpu().numpy().view(np.int32)
    b = prng.normal(k_host, shape).numpy().view(np.int32)
    assert np.abs(a.astype(np.int64) - b).max() <= 128


def test_sanitized_streams_on_the_card(cuda, monkeypatch):
    """The ragged kernel leg on tiny with GRAFTSAN=1: streams equal to the
    same engine's with it off, zero violations, B1 launched."""
    cfg = PRESETS["tiny"]
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    ecfg = EngineConfig(max_slots=4, max_seq_len=64, ragged=True,
                        paged_kv=True, chunked_prefill=True, kv_block=8,
                        prefill_chunk=16, prefix_block=8,
                        prompt_buckets=(16, 32), ragged_kernel="pallas")
    prompts = [list(range(3, 3 + n)) for n in (24, 7, 13, 30)]
    got = {}
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("GRAFTSAN", "1")
        eng = InferenceEngine(params, cfg, ecfg, device=cuda)
        eng.start()
        n0 = rpa.launches
        try:
            got[armed] = [eng.generate_blocking(
                p, SamplingParams(temperature=0.0, max_new_tokens=8))[
                    "token_ids"] for p in prompts]
        finally:
            eng.stop()
        assert rpa.launches > n0
        assert eng.debug_lifecycle_check() == {}
    assert eng._san is not None and not eng._san.violations
    assert got[True] == got[False]
