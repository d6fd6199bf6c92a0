"""The port's explainers (components/explainers.py) against the JAX
package's: integrated gradients on torch models, occlusion, and the
deployed ExplainerServer explaining a live port engine over real sockets.

 * the 5 cases of tests/test_explainers.py twinned;
 * IG attributions within 1e-5 of the JAX explainer's on the same linear
   and MLP models (the same numpy weights in both), and on the sklearn
   server's device head (``LinearHead``) against the same softmax head in
   jax;
 * occlusion attributions equal to JAX's on the same predict function."""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_tpu.components import explainers as jexp
from seldon_tpu_torch.components.explainers import (ExplainerServer,
                                                    IntegratedGradients,
                                                    OcclusionExplainer)
from seldon_tpu_torch.servers.sklearnserver import LinearHead

CPU = "cpu"
IG_ATOL = 1e-5


def _ig(model_fn, **kw):
    return IntegratedGradients(model_fn, device=CPU, **kw)


# ---------------------------------------------------------------------------
# Integrated gradients: the JAX package's cases
# ---------------------------------------------------------------------------


def test_ig_linear_model_recovers_weights():
    w = torch.tensor([2.0, -1.0, 0.5])

    def model(X):
        return X @ w  # scalar output per row

    ig = _ig(model, steps=32)
    X = np.array([[1.0, 1.0, 1.0], [2.0, 0.0, -2.0]], np.float32)
    attrs = ig.explain(X)
    # For a linear model IG is exactly w * (x - b).
    np.testing.assert_allclose(attrs, X * w.numpy(), rtol=1e-4)


def test_ig_completeness_nonlinear():
    W1 = torch.tensor([[1.0, -2.0], [0.5, 1.0]])
    w2 = torch.tensor([1.0, 2.0])

    def model(X):
        return torch.tanh(X @ W1) @ w2

    ig = _ig(model, steps=256)
    X = np.array([[0.7, -1.3]], np.float32)
    attrs = ig.explain(X)
    fx = float(model(torch.from_numpy(X))[0])
    f0 = float(model(torch.zeros(1, 2))[0])
    # Completeness axiom: attributions sum to f(x) - f(baseline).
    np.testing.assert_allclose(attrs.sum(), fx - f0, rtol=1e-2)


def test_ig_class_output_index():
    W = torch.tensor([[3.0, 0.0], [0.0, 5.0]])

    def model(X):
        return X @ W  # [B, 2] class scores

    attrs0 = _ig(model, steps=16, output_index=0).explain(
        np.array([[1.0, 1.0]], np.float32)
    )
    np.testing.assert_allclose(attrs0, [[3.0, 0.0]], atol=1e-4)


# ---------------------------------------------------------------------------
# Integrated gradients against JAX's on the same models
# ---------------------------------------------------------------------------


def _mlp(rng, F, H, C):
    W1 = rng.normal(size=(F, H)).astype(np.float32)
    b1 = rng.normal(size=H).astype(np.float32)
    W2 = (rng.normal(size=(H, C)) / np.sqrt(H)).astype(np.float32)
    tW1, tb1, tW2 = (torch.from_numpy(a) for a in (W1, b1, W2))
    return ((lambda X: jnp.tanh(X @ W1 + b1) @ W2),
            (lambda X: torch.tanh(X @ tW1 + tb1) @ tW2))


@pytest.mark.parametrize("output_index,steps", [(None, 64), (2, 32),
                                                (0, 128)])
def test_ig_matches_jax_mlp(output_index, steps):
    rng = np.random.default_rng(3)
    jm, pm = _mlp(rng, 6, 16, 3)
    X = rng.normal(size=(5, 6)).astype(np.float32)
    base = rng.normal(size=(6,)).astype(np.float32) * 0.1
    want = jexp.IntegratedGradients(jm, steps=steps,
                                    output_index=output_index).explain(
        X, base)
    got = _ig(pm, steps=steps, output_index=output_index).explain(X, base)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=IG_ATOL)


def test_ig_matches_jax_linear():
    rng = np.random.default_rng(4)
    w = rng.normal(size=(9,)).astype(np.float32)
    X = rng.normal(size=(7, 9)).astype(np.float32)
    want = jexp.IntegratedGradients(lambda X: X @ w, steps=16).explain(X)
    tw = torch.from_numpy(w)
    got = _ig(lambda X: X @ tw, steps=16).explain(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=IG_ATOL)


def test_ig_over_the_sklearn_head_matches_jax():
    """IG through the sklearn server's device head (softmax over a 784 x
    10 logistic model, MNIST's shape) against jax's softmax of the same
    product, and its completeness."""
    rng = np.random.default_rng(5)
    coef = (rng.normal(size=(10, 784)) * 0.05).astype(np.float32)
    intercept = rng.normal(size=10).astype(np.float32)
    head = LinearHead(coef, intercept, classifier=True, device=CPU)
    X = rng.uniform(0, 1, size=(4, 784)).astype(np.float32)
    got = _ig(head, steps=64, output_index=3).explain(X)

    def jhead(Z):
        return jax.nn.softmax(Z @ coef.T + intercept, axis=-1)

    want = jexp.IntegratedGradients(jhead, steps=64,
                                    output_index=3).explain(X)
    np.testing.assert_allclose(got, want, rtol=0, atol=IG_ATOL)
    f = head.predict_numpy(X)[:, 3] - head.predict_numpy(
        np.zeros_like(X))[:, 3]
    np.testing.assert_allclose(got.sum(1), f, rtol=1e-2, atol=1e-4)


# ---------------------------------------------------------------------------
# Occlusion
# ---------------------------------------------------------------------------


def test_occlusion_matches_linear_effect():
    calls = []

    def predict_fn(X):
        calls.append(np.asarray(X).shape)
        return np.asarray(X) @ np.array([1.0, 10.0, -5.0])

    occ = OcclusionExplainer(predict_fn)
    attrs = occ.explain(np.array([[2.0, 1.0, 1.0]], np.float32))
    np.testing.assert_allclose(attrs, [[2.0, 10.0, -5.0]], rtol=1e-6)
    # One BATCHED call per row (f+1 rows), not per feature.
    assert calls == [(4, 3)]


@pytest.mark.parametrize("output_index", [None, 1])
def test_occlusion_equals_jax(output_index):
    rng = np.random.default_rng(6)
    W = rng.normal(size=(5, 3))
    X = rng.normal(size=(4, 5)).astype(np.float32)
    base = rng.normal(size=(5,)).astype(np.float32)

    def fn(Z):
        return np.tanh(np.asarray(Z) @ W)

    got = OcclusionExplainer(fn, output_index=output_index).explain(X, base)
    want = jexp.OcclusionExplainer(fn, output_index=output_index).explain(
        X, base)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# ExplainerServer against a live port engine
# ---------------------------------------------------------------------------


def test_explainer_server_explains_live_engine():
    from aiohttp import web

    from seldon_tpu_torch.client import SeldonClient
    from seldon_tpu_torch.core import payloads
    from seldon_tpu_torch.orchestrator.server import EngineServer
    from seldon_tpu_torch.orchestrator.spec import (Endpoint, EndpointType,
                                                    PredictiveUnit,
                                                    PredictorSpec)
    from seldon_tpu_torch.runtime.metrics_server import ServerMetrics
    from seldon_tpu_torch.runtime.wrapper import (build_grpc_server,
                                                  build_rest_app)

    class Linear:
        def predict(self, X, names, meta=None):
            return np.asarray(X) @ np.array([[4.0], [-2.0]])

    results = {}

    async def run():
        gsrv = build_grpc_server(Linear())
        uport = gsrv.add_insecure_port("127.0.0.1:0")
        gsrv.start()
        es = EngineServer(
            spec=PredictorSpec(
                name="p",
                graph=PredictiveUnit(
                    name="lin", type="MODEL",
                    endpoint=Endpoint("127.0.0.1", uport, EndpointType.GRPC),
                ),
            ),
            http_port=0, grpc_port=0, enable_batching=False,
            metrics=ServerMetrics(),
        )
        await es.start(host="127.0.0.1")
        eport = None
        for site in es._runner.sites:
            eport = site._server.sockets[0].getsockname()[1]
        explainer = ExplainerServer(predictor_host=f"127.0.0.1:{eport}")
        xrunner = web.AppRunner(build_rest_app(explainer))
        await xrunner.setup()
        xsite = web.TCPSite(xrunner, "127.0.0.1", 0)
        await xsite.start()
        xport = xsite._server.sockets[0].getsockname()[1]

        def client_calls():
            c = SeldonClient(host="127.0.0.1", port=eport)
            results["explain"] = c.explain(
                data=np.array([[3.0, 1.0]]), payload_kind="ndarray",
                explainer_host=f"127.0.0.1:{xport}",
            )

        await asyncio.get_running_loop().run_in_executor(None, client_calls)
        await xrunner.cleanup()
        await es.stop()
        gsrv.stop(0)

    asyncio.run(run())
    resp = results["explain"]
    assert resp.success
    attrs = payloads.get_data_from_message(resp.msg)
    # Linear single-output model: occlusion == weight * x exactly.
    np.testing.assert_allclose(np.asarray(attrs), [[12.0, -2.0]], rtol=1e-5)
    assert resp.msg.meta.tags["explainer"].string_value == "occlusion"


def test_explainer_server_needs_a_predictor(monkeypatch):
    monkeypatch.delenv("PREDICTOR_HOST", raising=False)
    srv = ExplainerServer()
    with pytest.raises(RuntimeError, match="predictor_host"):
        srv.predict(np.zeros((1, 2)), [])
    assert srv.tags() == jexp.ExplainerServer().tags()
