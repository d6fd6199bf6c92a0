"""The port's tree traversal and prepackaged servers against the JAX
package's: ``ops/trees.py``, ``servers/{xgboostserver,sklearnserver,
mlflowserver,tfproxy,sagemakerproxy}.py``.

 * ``from_xgboost_json`` arrays equal to JAX's on seeded ensembles with
   sparse node ids, missing directions and a stump;
 * leaf cursors bit-equal to a numpy walk of the dump (NaN features to
   the missing child), margins and probabilities within 1e-5 of
   ``seldon_tpu.ops.trees.predict``;
 * the server twins of tests/test_parity_servers.py (sklearn, xgboost,
   the six mlflow cases, tfproxy), each server's outputs beside the JAX
   server's on the same model files (probabilities within 1e-5, labels
   equal) and the route in ``tags()["backend"]``;
 * proxies: the TF-Serving and SageMaker request bytes and the SigV4
   headers equal to JAX's, and tests/test_aux_parity.py's SigV4 vector
   and SageMaker invoke;
 * every new entry point refuses to start without a card unless given
   ``device="cpu"``.

Runs on the CPU (``device="cpu"``); the card's twins are in
tests/test_torch_prepackaged_cuda.py."""

import datetime
import http.server
import json
import threading

import numpy as np
import pytest
import torch

import jax

from seldon_tpu.ops import trees as jtrees
from seldon_tpu.servers import mlflowserver as jmlflow
from seldon_tpu.servers import sagemakerproxy as jsm
from seldon_tpu.servers import sklearnserver as jsk
from seldon_tpu.servers import tfproxy as jtf
from seldon_tpu.servers import xgboostserver as jxgb
from seldon_tpu_torch.ops import trees
from seldon_tpu_torch.servers import sagemakerproxy, tfproxy
from seldon_tpu_torch.servers.mlflowserver import MLFlowServer
from seldon_tpu_torch.servers.sklearnserver import (LinearHead, SKLearnServer,
                                                   export_linear_model)
from seldon_tpu_torch.servers.xgboostserver import XGBoostServer

CPU = "cpu"

# A 2-tree ensemble in xgboost dump format:
# tree0: f0 < 0.5 ? leaf 1.0 : (f1 < 2.0 ? leaf -1.0 : leaf 3.0)
# tree1: f1 < 1.0 ? leaf 0.5 : leaf -0.5
TREE0 = {
    "nodeid": 0, "split": "f0", "split_condition": 0.5, "yes": 1, "no": 2,
    "children": [
        {"nodeid": 1, "leaf": 1.0},
        {"nodeid": 2, "split": "f1", "split_condition": 2.0, "yes": 3,
         "no": 4, "children": [
             {"nodeid": 3, "leaf": -1.0},
             {"nodeid": 4, "leaf": 3.0},
         ]},
    ],
}
TREE1 = {
    "nodeid": 0, "split": "f1", "split_condition": 1.0, "yes": 1, "no": 2,
    "children": [{"nodeid": 1, "leaf": 0.5}, {"nodeid": 2, "leaf": -0.5}],
}


def manual_predict(x):
    t0 = 1.0 if x[0] < 0.5 else (-1.0 if x[1] < 2.0 else 3.0)
    t1 = 0.5 if x[1] < 1.0 else -0.5
    return t0 + t1


def random_dump(rng, n_trees, depth, n_features, sparse=True):
    """Seeded xgboost-style trees: heap node ids (sparse where a branch
    stops early), 'f<i>' or integer splits, a missing direction on some
    nodes, and one stump."""

    def node(nid, d):
        if d == depth or (d > 0 and rng.random() < 0.25):
            return {"nodeid": nid, "leaf": float(rng.normal())}
        yes, no = (2 * nid + 1, 2 * nid + 2) if sparse else (None, None)
        feat = int(rng.integers(n_features))
        out = {"nodeid": nid,
               "split": f"f{feat}" if rng.random() < 0.8 else feat,
               "split_condition": float(np.float32(rng.normal())),
               "yes": yes, "no": no}
        if rng.random() < 0.5:
            out["missing"] = no if rng.random() < 0.5 else yes
        out["children"] = [node(yes, d + 1), node(no, d + 1)]
        return out

    dump = [node(0, 0) for _ in range(n_trees - 1)]
    dump.append({"nodeid": 0, "leaf": 0.25})  # a stump
    return dump


def numpy_walk(dump, X):
    """Final node (dense index) of every (row, tree), walked node by node
    in the dump itself: the oracle of the cursors."""
    out = np.zeros((X.shape[0], len(dump)), np.int64)
    for t, tree in enumerate(dump):
        ids = []

        def collect(n):
            ids.append(n["nodeid"])
            for c in n.get("children", []):
                collect(c)

        collect(tree)
        dense = {nid: i for i, nid in enumerate(sorted(ids))}
        for b in range(X.shape[0]):
            n = tree
            while "leaf" not in n:
                f = n["split"]
                f = int(f[1:]) if isinstance(f, str) else int(f)
                x = X[b, f]
                if np.isnan(x):
                    nxt = n.get("missing", n["yes"])
                elif x < np.float32(n["split_condition"]):
                    nxt = n["yes"]
                else:
                    nxt = n["no"]
                n = next(c for c in n["children"] if c["nodeid"] == nxt)
            out[b, t] = dense[n["nodeid"]]
    return out


# ---------------------------------------------------------------------------
# ops/trees.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_from_xgboost_json_arrays_equal_jax(seed):
    rng = np.random.default_rng(seed)
    dump = random_dump(rng, 12, 5, 6)
    for form in (dump, json.dumps(dump), [json.dumps(t) for t in dump]):
        got = trees.from_xgboost_json(form, base_score=0.25)
        want = jtrees.from_xgboost_json(form, base_score=0.25)
        for name in ("feature", "threshold", "left", "right", "value",
                     "missing"):
            a, b = getattr(got, name), getattr(want, name)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        assert (got.max_depth, got.base_score, got.n_trees) == (
            want.max_depth, want.base_score, want.n_trees)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cursors_bit_equal_and_margins_match_jax(seed):
    rng = np.random.default_rng(100 + seed)
    F = 7
    dump = random_dump(rng, 40, 6, F)
    ens = trees.from_xgboost_json(dump, base_score=-0.3)
    jens = jtrees.from_xgboost_json(dump, base_score=-0.3)
    X = rng.normal(size=(96, F)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = np.nan
    # Rows that sit exactly on a threshold go right ("x < thr" is False).
    X[0, ens.feature[0, 0]] = ens.threshold[0, 0]
    dev = trees.DeviceTrees(ens, CPU)
    leaves = dev.leaves(torch.from_numpy(X)).numpy()
    assert np.array_equal(leaves, numpy_walk(dump, X))
    for obj in ("reg", "binary"):
        got = trees.predict(dev, X, obj).numpy()
        want = np.asarray(jtrees.predict(jens, X, obj))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # A host ensemble is uploaded to the rows' device per call.
    np.testing.assert_array_equal(
        trees.predict_margin(ens, torch.from_numpy(X)).numpy(),
        trees.predict_margin(dev, X).numpy())


def test_tree_ensemble_matches_manual():
    ens = trees.from_xgboost_json([json.dumps(TREE0), json.dumps(TREE1)])
    X = np.array(
        [[0.0, 0.0], [1.0, 0.0], [1.0, 2.5], [0.4, 5.0], [0.6, 1.5]],
        np.float32,
    )
    out = trees.predict(trees.DeviceTrees(ens, CPU), X).numpy()
    expected = np.array([manual_predict(x) for x in X])
    np.testing.assert_allclose(out, expected, rtol=1e-6)


def test_tree_ensemble_binary_objective():
    ens = trees.from_xgboost_json([json.dumps(TREE1)])
    out = trees.predict(trees.DeviceTrees(ens, CPU),
                        np.array([[0.0, 0.0]]), "binary").numpy()
    assert 0.0 < out[0] < 1.0


# ---------------------------------------------------------------------------
# XGBoostServer
# ---------------------------------------------------------------------------


def _xgb_dir(tmp_path, doc):
    d = tmp_path / "xgb"
    d.mkdir()
    (d / "model.json").write_text(json.dumps(doc))
    return str(d)


def test_xgboost_server_json(tmp_path):
    model_dir = _xgb_dir(tmp_path, {"trees": [TREE0, TREE1],
                                    "objective": "reg", "base_score": 0.0})
    srv = XGBoostServer(model_uri=model_dir, device=CPU)
    srv.load()
    out = srv.predict(np.array([[0.0, 0.0]], np.float32), [])
    np.testing.assert_allclose(out, [1.5], rtol=1e-6)
    assert srv.tags() == {"server": "xgboostserver",
                          "backend": "torch-trees"}


def test_xgboost_server_logistic_base_score(tmp_path):
    # xgboost's stored base_score for binary:logistic is in PROBABILITY
    # space: 0.5 must contribute margin logit(0.5)=0, not +0.5.
    model_dir = _xgb_dir(tmp_path, {"trees": [TREE0, TREE1],
                                    "objective": "binary:logistic",
                                    "base_score": 0.5})
    srv = XGBoostServer(model_uri=model_dir, device=CPU)
    srv.load()
    out = srv.predict(np.array([[0.0, 0.0]], np.float32), [])
    np.testing.assert_allclose(out, [1.0 / (1.0 + np.exp(-1.5))], rtol=1e-6)


@pytest.mark.parametrize("wrapped", [True, False])
def test_xgboost_server_matches_jax_server(tmp_path, wrapped):
    rng = np.random.default_rng(7)
    dump = random_dump(rng, 60, 6, 9)
    doc = ({"trees": dump, "objective": "binary:logistic",
            "base_score": 0.3} if wrapped else dump)
    model_dir = _xgb_dir(tmp_path, doc)
    X = rng.normal(size=(128, 9)).astype(np.float32)
    X[rng.random(X.shape) < 0.05] = np.nan
    srv = XGBoostServer(model_uri=model_dir, device=CPU)
    ref = jxgb.XGBoostServer(model_uri=model_dir)
    got, want = srv.predict(X, []), np.asarray(ref.predict(X, []))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert srv.ensemble.base_score == ref.ensemble.base_score
    assert srv.objective == ref.objective


def test_xgboost_bst_keeps_the_jax_route(tmp_path, monkeypatch):
    """model.bst loads only through xgboost, with JAX's message when it
    is missing (no silent reroute)."""
    import sys

    (tmp_path / "model.bst").write_bytes(b"\0")
    monkeypatch.setitem(sys.modules, "xgboost", None)
    for srv in (XGBoostServer(model_uri=str(tmp_path), device=CPU),
                jxgb.XGBoostServer(model_uri=str(tmp_path))):
        with pytest.raises(RuntimeError, match="model.bst needs xgboost"):
            srv.load()
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        XGBoostServer(model_uri=str(tmp_path / "empty"), device=CPU).load()


# ---------------------------------------------------------------------------
# SKLearnServer
# ---------------------------------------------------------------------------


def test_sklearn_server_npz_logistic(tmp_path):
    # 3-class logistic: coef [3, 2].
    coef = np.array([[1.0, 0.0], [0.0, 1.0], [-1.0, -1.0]])
    intercept = np.array([0.0, 0.0, 0.0])
    export_linear_model(str(tmp_path), coef, intercept,
                        classes=["a", "b", "c"])
    srv = SKLearnServer(model_uri=str(tmp_path), device=CPU)
    srv.load()
    probs = srv.predict(np.array([[5.0, 0.0]], np.float32), [])
    assert probs.shape == (1, 3)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)
    assert np.argmax(probs[0]) == 0  # feature favors class a
    assert srv.class_names() == ["a", "b", "c"]
    assert srv.tags() == {"server": "sklearnserver", "backend": "torch"}

    srv2 = SKLearnServer(model_uri=str(tmp_path), method="predict",
                         device=CPU)
    srv2.load()
    labels = srv2.predict(np.array([[0.0, 5.0]], np.float32), [])
    # sklearn's model.predict() returns class LABELS, not argmax indices.
    assert labels[0] == "b"


def test_sklearn_server_binary_sigmoid(tmp_path):
    export_linear_model(str(tmp_path), np.array([[2.0, -1.0]]),
                        np.array([0.5]))
    srv = SKLearnServer(model_uri=str(tmp_path), device=CPU)
    srv.load()
    probs = srv.predict(np.array([[1.0, 1.0]], np.float32), [])
    assert probs.shape == (1, 2)
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("case", ["softmax", "sigmoid", "regressor",
                                  "int_labels"])
def test_sklearn_server_matches_jax_server(tmp_path, case):
    rng = np.random.default_rng(11)
    F = 64
    n_out = {"softmax": 10, "sigmoid": 1, "regressor": 1,
             "int_labels": 4}[case]
    coef = rng.normal(size=(n_out, F)) * 0.2
    intercept = rng.normal(size=n_out)
    classes = {"softmax": [f"c{i}" for i in range(10)],
               "int_labels": [3, 5, 7, 11]}.get(case)
    kind = "linear" if case == "regressor" else "logistic"
    export_linear_model(str(tmp_path), coef, intercept, classes=classes,
                        kind=kind)
    X = rng.normal(size=(256, F)).astype(np.float32)
    # The numpy f64 product of the stored f32 parameters: the oracle.
    c32 = np.atleast_2d(coef.astype(np.float32)).astype(np.float64)
    logits = X.astype(np.float64) @ c32.T + intercept.astype(
        np.float32).astype(np.float64)
    for method in ("predict_proba", "predict"):
        srv = SKLearnServer(model_uri=str(tmp_path), method=method,
                            device=CPU)
        ref = jsk.SKLearnServer(model_uri=str(tmp_path), method=method)
        got, want = srv.predict(X, []), np.asarray(ref.predict(X, []))
        assert got.shape == want.shape and got.dtype == want.dtype
        if method == "predict_proba" and case != "regressor":
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
            if n_out == 1:
                p1 = 1 / (1 + np.exp(-logits[:, 0]))
                oracle = np.stack([1 - p1, p1], 1)
            else:
                e = np.exp(logits - logits.max(1, keepdims=True))
                oracle = e / e.sum(1, keepdims=True)
            np.testing.assert_allclose(got, oracle, rtol=0, atol=1e-5)
        elif case == "regressor":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            probs = srv._head.predict_numpy(X)
            top2 = np.sort(probs, 1)[:, -2:]
            clear = (top2[:, 1] - top2[:, 0]) > 1e-5
            assert clear.mean() > 0.9
            np.testing.assert_array_equal(got[clear], want[clear])


def test_linear_head_keeps_full_f32(monkeypatch):
    """The product ignores a lowered process-wide matmul precision and
    restores it afterwards."""
    rng = np.random.default_rng(5)
    head = LinearHead(rng.normal(size=(10, 784)), rng.normal(size=10),
                      classifier=True, device=CPU)
    X = rng.normal(size=(64, 784)).astype(np.float32)
    want = head.predict_numpy(X)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("medium")
        got = head.predict_numpy(X)
        assert torch.get_float32_matmul_precision() == "medium"
    finally:
        torch.set_float32_matmul_precision(before)
    np.testing.assert_array_equal(got, want)


def test_sklearn_joblib_keeps_the_jax_route(tmp_path):
    pytest.importorskip("joblib")
    import joblib
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.normal(size=(60, 3))
    clf = LogisticRegression().fit(X, (X[:, 0] > 0).astype(int))
    joblib.dump(clf, tmp_path / "model.joblib")
    srv = SKLearnServer(model_uri=str(tmp_path), device=CPU)
    np.testing.assert_allclose(srv.predict(X[:5], []),
                               clf.predict_proba(X[:5].astype(np.float32)))
    assert srv.tags()["backend"] == "joblib"


# ---------------------------------------------------------------------------
# MLFlowServer: native MLmodel parsing, no mlflow installed
# ---------------------------------------------------------------------------


def _write_mlflow_dir(tmp_path, model, flavor_yaml: str,
                      pkl_name="model.pkl"):
    import pickle

    (tmp_path / pkl_name).write_bytes(pickle.dumps(model))
    (tmp_path / "MLmodel").write_text(flavor_yaml)


def test_mlflow_sklearn_flavor_without_mlflow(tmp_path):
    import sys

    assert "mlflow" not in sys.modules
    from sklearn.linear_model import LogisticRegression

    rng = np.random.default_rng(0)
    X = rng.normal(size=(80, 3))
    y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(int)
    clf = LogisticRegression().fit(X, y)
    _write_mlflow_dir(
        tmp_path, clf,
        "flavors:\n"
        "  python_function:\n"
        "    loader_module: mlflow.sklearn\n"
        "    model_path: model.pkl\n"
        "  sklearn:\n"
        "    pickled_model: model.pkl\n"
        "    serialization_format: cloudpickle\n"
        "    sklearn_version: 1.9.0\n",
    )
    srv = MLFlowServer(model_uri=str(tmp_path), method="predict_proba",
                       device=CPU)
    srv.load()
    assert srv._head is not None  # linear fast path engaged
    assert srv.tags()["backend"] == "torch"
    Xt = rng.normal(size=(5, 3)).astype(np.float32)
    got = srv.predict(Xt, [])
    np.testing.assert_allclose(got, clf.predict_proba(Xt), rtol=2e-3,
                               atol=2e-4)
    ref = jmlflow.MLFlowServer(model_uri=str(tmp_path),
                               method="predict_proba")
    np.testing.assert_allclose(got, np.asarray(ref.predict(Xt, [])),
                               rtol=0, atol=1e-5)
    labels = MLFlowServer(model_uri=str(tmp_path), method="predict",
                          device=CPU)
    np.testing.assert_array_equal(labels.predict(Xt, []), clf.predict(Xt))


def test_mlflow_pyfunc_descriptor_only(tmp_path):
    from sklearn.linear_model import Ridge

    rng = np.random.default_rng(1)
    X = rng.normal(size=(60, 4))
    y = X @ np.array([1.0, -2.0, 0.5, 0.0]) + 3.0
    reg = Ridge().fit(X, y)
    _write_mlflow_dir(
        tmp_path, reg,
        "flavors:\n"
        "  python_function:\n"
        "    loader_module: mlflow.sklearn\n"
        "    model_path: model.pkl\n",
    )
    srv = MLFlowServer(model_uri=str(tmp_path), device=CPU)
    Xt = rng.normal(size=(7, 4)).astype(np.float32)
    out = srv.predict(Xt, [])
    assert out.shape == (7,)
    np.testing.assert_allclose(out, reg.predict(Xt), rtol=1e-3, atol=1e-3)
    ref = jmlflow.MLFlowServer(model_uri=str(tmp_path))
    np.testing.assert_allclose(out, np.asarray(ref.predict(Xt, [])),
                               rtol=1e-5, atol=1e-5)


def test_mlflow_nonlinear_estimator_falls_back_to_sklearn(tmp_path):
    from sklearn.ensemble import RandomForestClassifier

    rng = np.random.default_rng(2)
    X = rng.normal(size=(50, 3))
    y = (X[:, 0] > 0).astype(int)
    clf = RandomForestClassifier(n_estimators=5, random_state=0).fit(X, y)
    _write_mlflow_dir(
        tmp_path, clf,
        "flavors:\n  sklearn:\n    pickled_model: model.pkl\n",
    )
    srv = MLFlowServer(model_uri=str(tmp_path), method="predict_proba",
                       device=CPU)
    Xt = rng.normal(size=(4, 3))
    np.testing.assert_allclose(srv.predict(Xt, []), clf.predict_proba(Xt))
    assert srv.tags()["backend"] == "sklearn"


def test_mlflow_margin_classifier_no_device_path(tmp_path):
    from sklearn.svm import LinearSVC

    rng = np.random.default_rng(3)
    X = rng.normal(size=(60, 3))
    y = (X[:, 0] - X[:, 2] > 0).astype(int)
    clf = LinearSVC().fit(X, y)
    _write_mlflow_dir(
        tmp_path, clf,
        "flavors:\n  sklearn:\n    pickled_model: model.pkl\n",
    )
    srv = MLFlowServer(model_uri=str(tmp_path), method="predict",
                       device=CPU)
    Xt = rng.normal(size=(8, 3))
    srv.predict(Xt, [])
    assert srv._head is None
    np.testing.assert_array_equal(srv.predict(Xt, []), clf.predict(Xt))


def test_mlflow_glm_keeps_inverse_link(tmp_path):
    from sklearn.linear_model import PoissonRegressor

    rng = np.random.default_rng(4)
    X = rng.normal(size=(80, 3))
    y = rng.poisson(np.exp(0.3 * X[:, 0] + 1.0))
    reg = PoissonRegressor().fit(X, y)
    _write_mlflow_dir(
        tmp_path, reg,
        "flavors:\n  sklearn:\n    pickled_model: model.pkl\n",
    )
    srv = MLFlowServer(model_uri=str(tmp_path), device=CPU)
    Xt = rng.normal(size=(6, 3))
    out = srv.predict(Xt, [])
    assert srv._head is None
    np.testing.assert_allclose(out, reg.predict(Xt))
    assert (out > 0).all()  # rate space, not log space


def test_mlflow_exotic_flavor_clear_error(tmp_path):
    (tmp_path / "MLmodel").write_text(
        "flavors:\n  pytorch:\n    model_data: data\n"
    )
    srv = MLFlowServer(model_uri=str(tmp_path), device=CPU)
    with pytest.raises(RuntimeError, match="pytorch"):
        srv.load()


# ---------------------------------------------------------------------------
# Proxies: request bytes and signatures equal to JAX's
# ---------------------------------------------------------------------------


class _Recorder(http.server.BaseHTTPRequestHandler):
    """Fake TF-Serving / SageMaker endpoint: records each request and
    answers {"predictions": instances * 3}."""

    seen = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers["Content-Length"]))
        _Recorder.seen.append({"path": self.path, "body": body,
                               "headers": dict(self.headers)})
        if self.headers.get("content-type") == "text/csv":
            rows = [[float(v) for v in ln.split(",")]
                    for ln in body.decode().splitlines()]
        else:
            doc = json.loads(body)
            rows = doc.get("instances") or next(iter(
                doc["inputs"].values()))
        data = json.dumps({"predictions": (np.asarray(rows) * 3.0).tolist()
                           }).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def log_message(self, *a):
        pass


@pytest.fixture
def recorder():
    _Recorder.seen = []
    httpd = http.server.HTTPServer(("127.0.0.1", 0), _Recorder)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    t.join(timeout=10)


def test_tfproxy_rest_roundtrip_and_bytes(recorder):
    X = np.array([[1.0, 2.0], [3.5, -1.25]])
    outs = []
    for mod in (tfproxy, jtf):
        for kw in ({}, {"signature_name": "serving_default",
                        "model_input": "x"}):
            proxy = mod.TFServingProxy(
                rest_endpoint=f"http://127.0.0.1:{recorder}/",
                model_name="m", **kw)
            outs.append(proxy.predict(X, []))
    for out in outs:
        np.testing.assert_allclose(out, X * 3.0)
    port, ref = _Recorder.seen[:2], _Recorder.seen[2:]
    for a, b in zip(port, ref):
        assert a["path"] == b["path"] == "/v1/models/m:predict"
        assert a["body"] == b["body"]
    assert tfproxy.TFServingProxy().tags() == jtf.TFServingProxy().tags()


def test_sigv4_matches_known_vector_and_jax():
    """AWS's documented test vector (GET iam, 2015-08-30)."""
    kw = dict(region="us-east-1", service="iam", access_key="AKIDEXAMPLE",
              secret_key="wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY",
              now=datetime.datetime(2015, 8, 30, 12, 36, 0,
                                    tzinfo=datetime.timezone.utc))
    h = sagemakerproxy.sigv4_headers("GET", "iam.amazonaws.com", "/", b"",
                                     **kw)
    assert h["authorization"].startswith(
        "AWS4-HMAC-SHA256 Credential=AKIDEXAMPLE/20150830/us-east-1/iam/"
        "aws4_request"
    )
    assert h == sagemakerproxy.sigv4_headers(
        "GET", "iam.amazonaws.com", "/", b"", **kw)
    assert h == jsm.sigv4_headers("GET", "iam.amazonaws.com", "/", b"",
                                  **kw)
    body = b'{"instances": [[1.0, 2.0]]}'
    for path in ("/endpoints/a b/invocations", "/x/~y_z.-"):
        sig = dict(kw, session_token="tok", service="sagemaker")
        assert sagemakerproxy.sigv4_headers(
            "POST", "h:9", path, body, **sig) == jsm.sigv4_headers(
                "POST", "h:9", path, body, **sig)


def test_sagemaker_proxy_invokes_endpoint(monkeypatch, recorder):
    fixed = datetime.datetime(2026, 1, 2, 3, 4, 5,
                              tzinfo=datetime.timezone.utc)

    class _Clock(datetime.datetime):
        @classmethod
        def now(cls, tz=None):
            return fixed

    class _DT:
        timezone = datetime.timezone
        datetime = _Clock

    monkeypatch.setenv("AWS_ACCESS_KEY_ID", "AKID")
    monkeypatch.setenv("AWS_SECRET_ACCESS_KEY", "secret")
    X = np.array([[1.0, 2.0]])
    for mod in (sagemakerproxy, jsm):
        monkeypatch.setattr(mod, "datetime", _DT)
        for ctype in ("application/json", "text/csv"):
            proxy = mod.SagemakerProxy(
                endpoint_name="my-model", region="us-west-2",
                content_type=ctype,
                endpoint_url=f"http://127.0.0.1:{recorder}")
            np.testing.assert_allclose(proxy.predict(X, []), X * 3.0)
            assert proxy.tags()["proxy"] == "sagemaker"
    port, ref = _Recorder.seen[:2], _Recorder.seen[2:]
    assert len(ref) == 2
    for a, b in zip(port, ref):
        assert a["path"] == b["path"] == "/endpoints/my-model/invocations"
        assert a["body"] == b["body"]
        assert "AWS4-HMAC-SHA256" in a["headers"]["authorization"]
        assert a["headers"]["authorization"] == b["headers"]["authorization"]
    assert json.loads(port[0]["body"]) == {"instances": [[1.0, 2.0]]}
    assert port[1]["body"] == b"1.0,2.0"


# ---------------------------------------------------------------------------
# Devices
# ---------------------------------------------------------------------------


def _entry_points():
    from seldon_tpu_torch.components import (IntegratedGradients,
                                             IsolationForestDetector,
                                             Seq2SeqLSTMDetector,
                                             VAEDetector)

    return {
        "SKLearnServer": lambda **kw: SKLearnServer(**kw),
        "XGBoostServer": lambda **kw: XGBoostServer(**kw),
        "MLFlowServer": lambda **kw: MLFlowServer(**kw),
        "VAEDetector": lambda **kw: VAEDetector(**kw),
        "IsolationForestDetector": lambda **kw: IsolationForestDetector(
            **kw),
        "Seq2SeqLSTMDetector": lambda **kw: Seq2SeqLSTMDetector(**kw),
        "IntegratedGradients": lambda **kw: IntegratedGradients(
            lambda X: X.sum(-1), **kw),
        "DeviceTrees": lambda **kw: trees.DeviceTrees(
            trees.from_xgboost_json([TREE1]), **kw),
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_need_a_card_unless_told_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    make = _entry_points()[name]
    with pytest.raises(RuntimeError, match="CUDA"):
        make()
    with pytest.raises(RuntimeError, match="CUDA"):
        make(device="cuda")
    assert make(device=CPU).device == torch.device(CPU)


def test_jax_stays_on_the_cpu():
    assert jax.devices()[0].platform == "cpu"


@pytest.mark.parametrize("kind", ["xgboost", "sklearn"])
def test_served_by_the_microservice_over_rest(tmp_path, kind):
    """A model.json / model.npz served the way the microservice CLI builds
    its unit (typed parameters -> the class) behind the port's REST app:
    answers equal to direct calls, the route in meta.tags."""
    from seldon_tpu_torch.core import payloads
    from seldon_tpu_torch.runtime import microservice, wrapper
    from torch_port_helpers import RestServers, http_request

    rng = np.random.default_rng(9)
    if kind == "xgboost":
        model_dir = _xgb_dir(tmp_path, {"trees": random_dump(rng, 20, 4, 5),
                                        "objective": "binary:logistic",
                                        "base_score": 0.4})
        cls = "seldon_tpu_torch.servers.xgboostserver.XGBoostServer"
        X = rng.normal(size=(6, 5)).astype(np.float32)
    else:
        model_dir = str(tmp_path)
        export_linear_model(model_dir, rng.normal(size=(3, 5)),
                            rng.normal(size=3), classes=[1, 2, 3])
        cls = "seldon_tpu_torch.servers.sklearnserver.SKLearnServer"
        X = rng.normal(size=(6, 5)).astype(np.float32)
    params = microservice.parse_parameters(json.dumps([
        {"name": "model_uri", "value": model_dir},
        {"name": "device", "value": "cpu"}]))
    unit = microservice.build_user_object(cls, params)
    servers = RestServers(wrapper.build_rest_app(unit))
    try:
        status, raw = http_request(servers.ports[0], "POST", "/predict",
                                   {"data": {"ndarray": X.tolist()}})
    finally:
        servers.close()
    assert status == 200, raw[:300]
    body = json.loads(raw)
    got = np.asarray(payloads.get_data_from_message(
        payloads.dict_to_message(body)))
    np.testing.assert_array_equal(got, unit.predict(X, []))
    assert body["meta"]["tags"]["backend"] == unit.tags()["backend"]
