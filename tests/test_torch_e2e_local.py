"""E2E on the port: SeldonDeployment CR -> the port's reconcile -> the
port's LocalProcessStore -> REAL processes of the port -> HTTP / gRPC.

The JAX package's tests/test_e2e_local.py, on seldon_tpu_torch: a CR to
a live predict, the two-unit hop, the zero-downtime rolling update, the
bandit's feedback, and a `tiny` TorchServer pod on the CPU (its unit
parameters name `device="cpu"`) whose predict through the engine and
gRPC Generate on the unit are bit-equal to the in-process port server,
by image and through the prepackaged JAX_SERVER route with a `file://`
modelUri. Each test closes its store in `finally`."""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

from seldon_tpu_torch.operator import Reconciler, SeldonDeployment
from seldon_tpu_torch.operator.localstore import LocalProcessStore
from seldon_tpu_torch.packaging import render_template

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.e2e

V1 = "local/tests.fixed_models.ModelV1:1"
V2 = "local/tests.fixed_models.ModelV2:1"
TORCH_SERVER = "local/seldon_tpu_torch.servers.torchserver.TorchServer:1"
TINY = [  # the unit parameters of a tiny TorchServer pod on the CPU
    {"name": "preset", "value": "tiny", "type": "STRING"},
    {"name": "init_seed", "value": "3", "type": "INT"},
    {"name": "max_slots", "value": "2", "type": "INT"},
    {"name": "max_seq_len", "value": "64", "type": "INT"},
    {"name": "prefill_chunk", "value": "16", "type": "INT"},
    {"name": "ragged", "value": "1", "type": "INT"},
    {"name": "ragged_kernel", "value": "pallas", "type": "STRING"},
    {"name": "device", "value": "cpu", "type": "STRING"},
]
PROMPTS = [list(range(5, 21)), [7, 3, 9, 1, 30, 31], list(range(40, 72))]


def _post(port: int, path: str, body, timeout=30):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _predict(port: int, rows, timeout=30):
    return _post(port, "/api/v0.1/predictions",
                 {"data": {"ndarray": rows}}, timeout)


def _cr(name="e2e", generation=1, image=V1, pred_name="main"):
    return SeldonDeployment.from_dict({
        "metadata": {"name": name, "namespace": "default",
                     "generation": generation},
        "spec": {
            "predictors": [{
                "name": pred_name,
                "replicas": 1,
                "graph": {"name": "clf", "type": "MODEL", "image": image},
            }],
        },
    })


def _reconcile_until_available(rec, store, sdep, timeout_s=120):
    """Reconcile -> wait for processes -> reconcile (the controller loop's
    resync behavior, compressed)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        status = rec.reconcile(sdep)
        if status.state == "Available":
            return status
        if status.state == "Failed":  # terminal: waiting can't fix it
            raise AssertionError(f"reconcile failed: {status}")
        store.wait_ready(30)
    raise AssertionError(f"never became Available: {status}")


def _only_workload(store):
    return next(m["metadata"]["name"]
                for m in store.list("Deployment", "default"))


def test_cr_to_live_http_predict():
    store = LocalProcessStore(repo_root=REPO)
    rec = Reconciler(store, istio_enabled=False)
    try:
        _reconcile_until_available(rec, store, _cr())
        port = store.engine_port(_only_workload(store))
        out = _predict(port, [[0.0, 0.0]])
        assert out["data"]["ndarray"] == [[1.0, 2.0, 3.0, 4.0]], out
        assert "clf" in out["meta"]["requestPath"], out["meta"]
        for _ in range(5):
            assert _predict(port, [[1.0]])["data"]["ndarray"] == [
                [1.0, 2.0, 3.0, 4.0]
            ]
    finally:
        store.close()


def test_engine_graph_with_live_unit_hop():
    """Transformer -> model two-unit graph: both hops are real processes
    and tags from both units merge into the response meta."""
    store = LocalProcessStore(repo_root=REPO)
    rec = Reconciler(store, istio_enabled=False)
    try:
        sdep = SeldonDeployment.from_dict({
            "metadata": {"name": "hop", "namespace": "default"},
            "spec": {"predictors": [{
                "name": "main",
                "replicas": 1,
                "graph": {
                    "name": "scaler",
                    "type": "TRANSFORMER",
                    "image": "local/tests.fixed_models.DoublerTransformer:1",
                    "children": [
                        {"name": "clf", "type": "MODEL", "image": V1}
                    ],
                },
            }]},
        })
        _reconcile_until_available(rec, store, sdep)
        out = _predict(store.engine_port(_only_workload(store)), [[3.0]])
        assert out["data"]["ndarray"] == [[1.0, 2.0, 3.0, 4.0]], out
        path = out["meta"]["requestPath"]
        assert set(path) >= {"scaler", "clf"}, path
        assert out["meta"]["tags"].get("scaled") is True, out["meta"]
    finally:
        store.close()


def test_rolling_update_zero_downtime():
    """A generation bump swaps the graph version; the OLD engine keeps
    serving until the new one is ready, then stale resources GC (engine
    last) and their processes exit."""
    store = LocalProcessStore(repo_root=REPO)
    rec = Reconciler(store, istio_enabled=False)
    try:
        _reconcile_until_available(
            rec, store, _cr(generation=1, image=V1, pred_name="main")
        )
        v1_dep = _only_workload(store)
        v1_port = store.engine_port(v1_dep)
        v1_procs = list(store.pods[v1_dep].procs)
        assert _predict(v1_port, [[0.0]])["data"]["ndarray"] == [
            [1.0, 2.0, 3.0, 4.0]
        ]

        # Generation 2 renames the predictor -> new workload + processes.
        sdep2 = _cr(generation=2, image=V2, pred_name="canary")
        status = rec.reconcile(sdep2)
        assert status.state == "Creating"  # the new pod is still starting
        # Rollout window: BOTH generations' processes are live and the old
        # engine still serves v1 — zero downtime.
        assert _predict(v1_port, [[0.0]])["data"]["ndarray"] == [
            [1.0, 2.0, 3.0, 4.0]
        ]
        names = {m["metadata"]["name"]
                 for m in store.list("Deployment", "default")}
        assert len(names) == 2, names
        assert all(p.poll() is None for p in v1_procs)
        _reconcile_until_available(rec, store, sdep2)

        remaining = {m["metadata"]["name"]
                     for m in store.list("Deployment", "default")}
        assert v1_dep not in remaining, remaining
        assert store.pods.get(v1_dep) is None
        assert all(p.poll() is not None for p in v1_procs)
        out = _predict(store.engine_port(next(iter(remaining))), [[0.0]])
        assert out["data"]["ndarray"] == [[5.0, 6.0, 7.0, 8.0]], out
    finally:
        store.close()


def test_bandit_feedback_shifts_routing():
    """An EpsilonGreedy router unit of the port + two fixed models;
    rewarding only v2's branch via /feedback makes the router concentrate
    traffic on it — reward routing follows meta.routing across real
    process hops."""
    store = LocalProcessStore(repo_root=REPO)
    rec = Reconciler(store, istio_enabled=False)
    try:
        sdep = SeldonDeployment.from_dict({
            "metadata": {"name": "mab", "namespace": "default"},
            "spec": {"predictors": [{
                "name": "main",
                "replicas": 1,
                "graph": {
                    "name": "eg",
                    "type": "ROUTER",
                    "image":
                        "local/seldon_tpu_torch.components.EpsilonGreedy:1",
                    "parameters": [
                        {"name": "n_branches", "value": "2", "type": "INT"},
                        {"name": "epsilon", "value": "0.1",
                         "type": "FLOAT"},
                        {"name": "seed", "value": "7", "type": "INT"},
                    ],
                    "children": [
                        {"name": "model-a", "type": "MODEL", "image": V1},
                        {"name": "model-b", "type": "MODEL", "image": V2},
                    ],
                },
            }]},
        })
        _reconcile_until_available(rec, store, sdep)
        port = store.engine_port(_only_workload(store))

        def feedback(resp, reward):
            return _post(port, "/api/v0.1/feedback", {
                "request": {"data": {"ndarray": [[1.0]]}},
                "response": resp,
                "reward": reward,
            })

        v2_rewards = 0
        for _ in range(200):
            resp = _predict(port, [[1.0]])
            is_v2 = resp["data"]["ndarray"][0][0] == 5.0
            feedback(resp, 1.0 if is_v2 else 0.0)
            v2_rewards += int(is_v2)
            if v2_rewards >= 2:
                break
        assert v2_rewards >= 2, "router never explored branch 1 in 200 tries"
        v2_count = sum(
            _predict(port, [[1.0]])["data"]["ndarray"][0][0] == 5.0
            for _ in range(30)
        )
        assert v2_count >= 22, v2_count  # eps=0.1 -> expect ~27/30
    finally:
        store.close()


def _in_process_server(**kw):
    from seldon_tpu_torch.runtime.microservice import parse_parameters
    from seldon_tpu_torch.servers.torchserver import TorchServer

    srv = TorchServer(**dict(parse_parameters(json.dumps(TINY)), **kw))
    srv.load()
    return srv


def _grpc_generate(port, prompt):
    import grpc

    from seldon_tpu_torch.proto import prediction_grpc
    from seldon_tpu_torch.proto import prediction_pb2 as pb

    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        stub = prediction_grpc.TextGenStub(ch)
        return list(stub.Generate(pb.GenerateRequest(
            prompt_token_ids=prompt, max_new_tokens=6, temperature=0.0,
            seed=1), timeout=60).token_ids)


def _check_torchserver_pod(store, srv, unit_name):
    """Predict through the engine pod (REST) and gRPC Generate on the
    unit pod's recorded port, against the in-process server."""
    dep = _only_workload(store)
    X = np.random.default_rng(0).integers(0, 256, (2, 24)).tolist()
    out = _predict(store.engine_port(dep), X, timeout=60)
    got = np.asarray(out["data"]["ndarray"], np.float64).astype(np.float32)
    want = srv.predict(np.asarray(X), names=[])
    assert got.shape == want.shape == (2,)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert unit_name in out["meta"]["requestPath"], out["meta"]
    uport = store.pods[dep].ports[unit_name]
    for prompt in PROMPTS:
        want_toks = srv.generate({"prompt_token_ids": prompt,
                                  "max_new_tokens": 6, "temperature": 0.0,
                                  "seed": 1})["token_ids"]
        assert _grpc_generate(uport, prompt) == want_toks


def test_tiny_torchserver_pod_bit_equal_to_in_process():
    """The template's single-model CR with the unit named by image as the
    port's TorchServer, `tiny` on the CPU: the pod's predict (through the
    engine) and gRPC Generate (on the unit) equal the in-process port
    server's, bit for bit."""
    store = LocalProcessStore(repo_root=REPO)
    rec = Reconciler(store, istio_enabled=False)
    srv = None
    try:
        cr = render_template("single-model", name="tiny",
                             implementation="JAX_SERVER")
        graph = cr["spec"]["predictors"][0]["graph"]
        # JAX_SERVER without a modelUri is refused, as in JAX.
        refused = Reconciler(store).reconcile(SeldonDeployment.from_dict(
            json.loads(json.dumps(cr))))
        assert refused.state == "Failed"
        assert "requires modelUri" in refused.description
        assert not store.pods
        graph.pop("implementation")
        graph.update(image=TORCH_SERVER, parameters=TINY)
        _reconcile_until_available(rec, store, SeldonDeployment.from_dict(cr))
        srv = _in_process_server()
        _check_torchserver_pod(store, srv, "model")
    finally:
        store.close()
        if srv is not None:
            srv.stop()


def test_tiny_torchserver_model_uri_through_initializer(tmp_path):
    """The prepackaged JAX_SERVER route: the webhook names the port's
    TorchServer, the model initializer resolves a `file://` modelUri (a
    tiny HF checkpoint) into the unit's parameters, and the pod serves it
    bit-equal to the same checkpoint served in process."""
    import chip_smoke

    src = _in_process_server()
    ckpt = tmp_path / "ckpt"
    chip_smoke.write_hf_checkpoint(src.params, src.cfg, str(ckpt))
    src.stop()
    store = LocalProcessStore(repo_root=REPO)
    rec = Reconciler(store, istio_enabled=False)
    srv = None
    try:
        cr = render_template("single-model", name="uri",
                             implementation="JAX_SERVER",
                             model_uri=f"file://{ckpt}")
        cr["spec"]["predictors"][0]["graph"]["parameters"] = [
            p for p in TINY if p["name"] not in ("preset", "init_seed")]
        _reconcile_until_available(rec, store, SeldonDeployment.from_dict(cr))
        dep = _only_workload(store)
        pod = store.manifests[("Deployment", "default", dep)]["spec"][
            "template"]["spec"]
        assert pod["initContainers"][0]["command"][-1] == \
            "seldon_tpu_torch.servers.storage"
        assert pod["containers"][0]["command"][-1] == \
            "seldon_tpu_torch.servers.torchserver.TorchServer"
        srv = _in_process_server(model_uri=f"file://{ckpt}")
        _check_torchserver_pod(store, srv, "model")
    finally:
        store.close()
        if srv is not None:
            srv.stop()
