"""seldon_tpu_torch.client and seldon_tpu_torch.runtime.tester against the
JAX package's: the port's SeldonClient against the port's microservice
CLI (REST, rest-proto, gRPC), both clients' request bytes through one
capture server, and the contract tester against a port unit and the
port's EngineServer (direct, over gRPC, and through a prefix-stripping
gateway)."""

import asyncio
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import grpc
import numpy as np
import pytest
from aiohttp import web

from seldon_tpu import client as jclient
from seldon_tpu.runtime import tester as jtester
from seldon_tpu_torch import client as tclient
from seldon_tpu_torch.orchestrator.server import EngineServer
from seldon_tpu_torch.orchestrator.spec import PredictorSpec
from seldon_tpu_torch.proto import prediction_grpc
from seldon_tpu_torch.proto import prediction_pb2 as pb
from seldon_tpu_torch.runtime import tester as ttester
from seldon_tpu_torch.runtime.metrics_server import ServerMetrics
from torch_port_helpers import EngineThread, RestServers
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODEL_APP = """
import numpy as np

class EchoScaler:
    def __init__(self, factor=2.0):
        self.factor = float(factor)

    def predict(self, X, names, meta=None):
        return np.asarray(X) * self.factor

    def tags(self):
        return {"m": "echo"}
"""

CONTRACT = {
    "features": [
        {"name": "f1", "dtype": "FLOAT", "ftype": "continuous", "range": [0, 1]},
        {"name": "f2", "dtype": "FLOAT", "ftype": "continuous", "range": [0, 1]},
    ],
    "targets": [
        {"name": "o1", "dtype": "FLOAT", "ftype": "continuous",
         "range": [0, 3], "repeat": 2},
    ],
}

API_CONTRACT = {
    "features": [
        {"name": "a", "dtype": "FLOAT", "ftype": "continuous",
         "range": [0.0, 1.0]},
        {"name": "b", "dtype": "FLOAT", "ftype": "continuous",
         "range": [0.0, 1.0]},
    ],
    "targets": [
        {"name": "proba", "dtype": "FLOAT", "ftype": "continuous",
         "range": [0.0, 1.0], "repeat": 3}
    ],
}

MIXED_CONTRACT = {
    "features": [
        {"name": "x", "dtype": "FLOAT", "ftype": "continuous",
         "range": [-2, 5], "shape": [2]},
        {"name": "n", "dtype": "INT", "ftype": "continuous",
         "range": ["-inf", 10], "repeat": 2},
        {"name": "c", "dtype": "INT", "ftype": "categorical",
         "values": [0, 1, 2]},
        {"name": "s", "dtype": "STRING", "ftype": "categorical",
         "values": ["a", "b"]},
    ],
}


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _free_ports(n):
    """n distinct free ports (each socket held until all are picked)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _start_microservice(workdir, env):
    """The CLI on two fresh ports: (process, ports), or (None, output) if
    it exited before both ports answered (a port taken in between by
    another process, say)."""
    http_port, grpc_port = _free_ports(2)
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_tpu_torch.runtime.microservice",
         "EchoScaler", "--api-type", "REST,GRPC",
         "--http-port", str(http_port), "--grpc-port", str(grpc_port),
         "--host", "127.0.0.1"],
        cwd=workdir, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    deadline = time.time() + 60
    while time.time() < deadline:
        try:
            for port in (http_port, grpc_port):
                with socket.create_connection(("127.0.0.1", port), 0.2):
                    pass
            return proc, (http_port, grpc_port)
        except OSError:
            if proc.poll() is not None:
                return None, proc.stdout.read().decode()
            time.sleep(0.1)
    proc.kill()
    proc.wait(timeout=10)
    raise AssertionError("microservice never came up")


@pytest.fixture(scope="module")
def microservice(tmp_path_factory):
    """The port's microservice CLI in a subprocess on a user model file."""
    workdir = tmp_path_factory.mktemp("app")
    (workdir / "EchoScaler.py").write_text(MODEL_APP)
    env = dict(os.environ, PYTHONPATH=REPO,
               PREDICTIVE_UNIT_PARAMETERS=json.dumps(
                   [{"name": "factor", "value": "2.0", "type": "FLOAT"}]))
    for _ in range(3):
        proc, got = _start_microservice(workdir, env)
        if proc is not None:
            break
    else:
        raise RuntimeError(f"microservice died:\n{got}")
    http_port, grpc_port = got
    yield http_port, grpc_port
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


# ---------------------------------------------------------------------------
# The port's client against the port's microservice CLI
# ---------------------------------------------------------------------------


def test_cli_rest_predict(microservice):
    http_port, _ = microservice
    c = tclient.SeldonClient(host="127.0.0.1", port=http_port,
                             transport="rest")
    r = c.microservice(data=np.array([[1.0, 2.0]]), method="predict")
    assert r.success, r.error
    np.testing.assert_allclose(r.data, [[2.0, 4.0]])
    assert r.response["meta"]["tags"] == {"m": "echo"}


def test_cli_grpc_predict(microservice):
    _, grpc_port = microservice
    c = tclient.SeldonClient(host="127.0.0.1", grpc_port=grpc_port,
                             transport="grpc")
    r = c.microservice(data=np.array([[3.0, 4.0]]), method="predict")
    assert r.success, r.error
    np.testing.assert_allclose(r.data, [[6.0, 8.0]])
    c.close()


def test_cli_rest_proto_fast_path(microservice):
    http_port, _ = microservice
    c = tclient.SeldonClient(host="127.0.0.1", port=http_port,
                             transport="rest-proto")
    r = c.microservice(data=np.array([[5.0, 6.0]], dtype=np.float32))
    assert r.success, r.error
    assert r.data.dtype == np.float32  # the dense fast path keeps dtype
    np.testing.assert_allclose(r.data, [[10.0, 12.0]])


def test_cli_errors_are_responses(microservice):
    """A refused call comes back as an unsuccessful ClientResponse."""
    http_port, _ = microservice
    c = tclient.SeldonClient(host="127.0.0.1", port=http_port,
                             transport="rest")
    r = c.microservice(data=np.array([[1.0]]), method="route")
    assert not r.success and r.error
    nobody = tclient.SeldonClient(host="127.0.0.1", port=_free_port(),
                                  transport="rest", timeout_s=2)
    r = nobody.predict(data=np.array([[1.0]]))
    assert not r.success and r.error


def test_contract_tester_against_cli(microservice, tmp_path):
    http_port, grpc_port = microservice
    cpath = tmp_path / "contract.json"
    cpath.write_text(json.dumps(CONTRACT))
    for transport, port in (("rest", http_port), ("grpc", grpc_port)):
        result = ttester.run_contract_test(
            str(cpath), host="127.0.0.1", port=port, transport=transport,
            n_requests=5, batch_size=3)
        assert result["ok"], (transport, result["failures"])
    bad = dict(CONTRACT, targets=[dict(CONTRACT["targets"][0],
                                       range=[0, 0.5])])
    cpath.write_text(json.dumps(bad))
    result = ttester.run_contract_test(
        str(cpath), host="127.0.0.1", port=http_port, n_requests=3)
    assert not result["ok"]
    assert all("out of range" in f for f in result["failures"])


def test_client_aggregate_and_unknown_method():
    c = tclient.SeldonClient(transport="grpc", grpc_port=1)
    r = c.microservice(method="nope")
    assert not r.success and "unknown method" in r.error
    r = c.microservice(method="send_feedback", msg=None)
    assert not r.success and "Feedback" in r.error
    r = c.microservice(method="aggregate")
    assert not r.success and "msgs" in r.error
    with pytest.raises(ValueError, match="explainer_host"):
        c.explain(data=np.array([[1.0]]))
    c.close()
    assert tclient.SeldonClient.gateway_prefix("ns", "d") == "/seldon/ns/d"


# ---------------------------------------------------------------------------
# The tester's generator and validator, twin against twin
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("contract", [CONTRACT, API_CONTRACT, MIXED_CONTRACT])
def test_generate_batch_matches_jax(contract):
    for seed in (0, 5):
        X_j, names_j = jtester.generate_batch(
            contract, 4, np.random.default_rng(seed))
        X_t, names_t = ttester.generate_batch(
            contract, 4, np.random.default_rng(seed))
        assert names_t == names_j
        assert X_t.dtype == X_j.dtype and X_t.shape == X_j.shape
        if X_t.dtype == object:
            assert X_t.tolist() == X_j.tolist()
        else:
            assert X_t.tobytes() == X_j.tobytes()


def test_validate_response_matches_jax():
    X, _ = ttester.generate_batch(CONTRACT, 4)
    for arr in (X * 2.0, X * 100.0, X[:, :1], np.ones((2, 2, 2)), "text"):
        assert (ttester.validate_response(CONTRACT, arr)
                == jtester.validate_response(CONTRACT, arr))
    cat = {"targets": [{"name": "k", "ftype": "categorical",
                        "values": [0, 1]}]}
    for arr in (np.array([[0], [1]]), np.array([[0], [2]])):
        assert (ttester.validate_response(cat, arr)
                == jtester.validate_response(cat, arr))


# ---------------------------------------------------------------------------
# The request bytes: both clients through one capture server
# ---------------------------------------------------------------------------


class _Capture:
    """A REST app and a gRPC server that record every request (path,
    content type, raw body; gRPC: method, serialized message, routing
    metadata) and answer a fixed message."""

    REPLY = pb.SeldonMessage(strData="ok")
    GEN = pb.GenerateResponse(text="hi", token_ids=[1, 2], ttft_ms=1.5,
                              total_ms=2.5)

    def __init__(self):
        self.rest = []
        self.grpc = []

        async def handle(request):
            body = await request.read()
            ctype = request.headers.get("Content-Type", "")
            self.rest.append((request.path, ctype, body))
            if request.path == "/generate":
                msg = self.GEN
            else:
                msg = self.REPLY
            if ctype.startswith("application/x-protobuf"):
                return web.Response(body=msg.SerializeToString(),
                                    content_type="application/x-protobuf")
            from seldon_tpu_torch.core import payloads
            return web.json_response(payloads.message_to_dict(msg))

        app = web.Application()
        app.router.add_post("/{tail:.*}", handle)
        self.servers = RestServers(app)
        self.port = self.servers.ports[0]

        capture = self

        class Impl:
            def __init__(self, service):
                self.service = service

            def __getattr__(self, method):
                def call(request, context):
                    md = sorted((k, v) for k, v in
                                context.invocation_metadata()
                                if k in ("seldon", "namespace"))
                    capture.grpc.append((self.service, method,
                                         request.SerializeToString(), md))
                    if method == "Generate":
                        return capture.GEN
                    return capture.REPLY
                return call

        from concurrent import futures
        self.gserver = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        for service in ("Seldon", "Model", "Generic", "Router", "Combiner",
                        "TextGen"):
            prediction_grpc.add_servicer(self.gserver, service,
                                         Impl(service))
        self.grpc_port = self.gserver.add_insecure_port("127.0.0.1:0")
        self.gserver.start()

    def close(self):
        self.gserver.stop(0)
        self.servers.close()


@pytest.fixture(scope="module")
def capture():
    cap = _Capture()
    yield cap
    cap.close()


def _calls(mod, cap, transport, deployment=""):
    """Every client call, in one order, through client module `mod`."""
    c = mod.SeldonClient(host="127.0.0.1", port=cap.port,
                         grpc_port=cap.grpc_port, transport=transport,
                         deployment=deployment, namespace="ns1")
    X = np.arange(6, dtype=np.float64).reshape(2, 3) / 7.0
    out = []
    for kind in ("dense", "tensor", "ndarray"):
        out.append(c.predict(data=X, names=["a", "b", "c"],
                             payload_kind=kind).success)
    out.append(c.predict(data=X, gateway_prefix="/seldon/ns1/d1/").success)
    req = c._build_request(X, "dense", None, None)
    resp = pb.SeldonMessage(strData="r")
    out.append(c.feedback(request_msg=req, response_msg=resp, reward=0.5,
                          truth=np.array([[1.0]])).success)
    for method in ("predict", "transform_input", "transform_output",
                   "route"):
        out.append(c.microservice(data=X, method=method).success)
    out.append(c.microservice(method="aggregate",
                              msgs=[X, pb.SeldonMessage(strData="m")]
                              ).success)
    fb = pb.Feedback(reward=1.0)
    out.append(c.microservice(method="send_feedback", msg=fb).success)
    gen = c.generate(prompt="hello", prompt_token_ids=[5, 6],
                     max_new_tokens=4, temperature=0.0, top_k=3, top_p=0.9,
                     seed=2)
    out.append(gen)
    c.close()
    return out


@pytest.mark.parametrize("transport", ["rest", "rest-proto", "grpc"])
def test_request_bytes_equal_jax(capture, transport):
    deployment = "d1" if transport == "grpc" else ""
    capture.rest.clear()
    capture.grpc.clear()
    want = _calls(jclient, capture, transport, deployment)
    j_rest, j_grpc = list(capture.rest), list(capture.grpc)
    capture.rest.clear()
    capture.grpc.clear()
    got = _calls(tclient, capture, transport, deployment)
    assert got == want
    assert all(x for x in got[:-1])
    assert got[-1] == {"text": "hi", "token_ids": [1, 2], "ttft_ms": 1.5,
                       "total_ms": 2.5}
    assert capture.rest == j_rest
    assert capture.grpc == j_grpc
    assert len(capture.rest if transport != "grpc" else capture.grpc) == 12
    if transport == "grpc":
        # The Seldon API carries the gateway's routing metadata.
        assert [md for service, _, _, md in capture.grpc
                if service == "Seldon"] == [
            [("namespace", "ns1"), ("seldon", "d1")]] * 5


def test_generate_stream_over_grpc(capture):
    class Streamer:
        def GenerateStream(self, request, context):
            for i in range(3):
                yield pb.GenerateResponse(text=str(i), token_ids=[i],
                                          ttft_ms=float(i))

    from concurrent import futures
    server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
    prediction_grpc.add_servicer(server, "TextGen", Streamer())
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    try:
        chunks = {}
        for name, mod in (("jax", jclient), ("torch", tclient)):
            c = mod.SeldonClient(host="127.0.0.1", grpc_port=port)
            chunks[name] = list(c.generate_stream(prompt="x",
                                                  max_new_tokens=3))
            c.close()
    finally:
        server.stop(0)
    assert chunks["torch"] == chunks["jax"]
    assert [ch["token_ids"] for ch in chunks["torch"]] == [[0], [1], [2]]


# ---------------------------------------------------------------------------
# The deployed-API tester against the port's EngineServer
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def live_engine():
    """The port's EngineServer on a SIMPLE_MODEL graph, and a gateway that
    strips /seldon/{ns}/{name} as an ingress rewrite does."""
    spec = PredictorSpec.from_dict({"name": "t", "graph": {
        "name": "simple", "type": "MODEL", "implementation": "SIMPLE_MODEL",
    }})
    eng = EngineThread(EngineServer(spec=spec, http_port=0, grpc_port=0,
                                    enable_batching=False,
                                    metrics=ServerMetrics()))

    async def gateway(request):
        import aiohttp

        rest = "/" + request.match_info["rest"]
        async with aiohttp.ClientSession() as s:
            async with s.post(
                f"http://127.0.0.1:{eng.http}{rest}",
                data=await request.read(),
                headers={"Content-Type":
                         request.headers.get("Content-Type", "")},
            ) as r:
                return web.Response(status=r.status, body=await r.read(),
                                    content_type=r.content_type)

    gw = web.Application()
    gw.router.add_post("/seldon/{ns}/{name}/{rest:.*}", gateway)
    servers = RestServers(gw)
    yield {"http": eng.http, "grpc": eng.grpc, "gateway": servers.ports[0]}
    servers.close()
    eng.close()


def _contract(tmp_path, contract=API_CONTRACT):
    p = tmp_path / "contract.json"
    p.write_text(json.dumps(contract))
    return str(p)


@pytest.mark.parametrize("route", ["rest", "grpc", "gateway"])
def test_api_tester_against_engine(live_engine, tmp_path, route):
    kw = dict(host="127.0.0.1", n_requests=5)
    if route == "rest":
        kw.update(port=live_engine["http"], transport="rest",
                  with_feedback=True)
    elif route == "grpc":
        kw.update(grpc_port=live_engine["grpc"], transport="grpc")
    else:
        kw.update(port=live_engine["gateway"], transport="rest",
                  deployment="t", namespace="default", with_feedback=True)
    res = ttester.run_api_test(_contract(tmp_path), **kw)
    assert res["ok"], res["failures"]
    assert res["requests"] == 5


def test_api_tester_detects_contract_violation(live_engine, tmp_path):
    """SIMPLE_MODEL answers 0.9 / 0.05 / 0.05: a target range excluding
    0.9 must produce failures."""
    bad = dict(API_CONTRACT, targets=[{
        "name": "proba", "dtype": "FLOAT", "ftype": "continuous",
        "range": [0.0, 0.5], "repeat": 3}])
    res = ttester.run_api_test(_contract(tmp_path, bad), host="127.0.0.1",
                               port=live_engine["http"], transport="rest",
                               n_requests=2)
    assert not res["ok"]
    assert any("out of range" in f for f in res["failures"])


def test_tester_cli(live_engine, tmp_path, capsys):
    rc = ttester.main([_contract(tmp_path), "127.0.0.1",
                       str(live_engine["http"]), "--api", "-n", "2"])
    assert rc == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True


def test_tester_against_a_torch_unit(tmp_path):
    """run_contract_test on a TorchServer unit (tiny, CPU) with a
    token-id contract. The unit answers one mean NLL per row, a [B]
    array, so the contract names no 2-D targets; the answers are held
    to the unit's own predict."""
    from seldon_tpu_torch.runtime import wrapper
    from seldon_tpu_torch.servers.torchserver import TorchServer

    srv = TorchServer(preset="tiny", device="cpu")
    contract = {
        "features": [{"name": "tok", "dtype": "INT", "ftype": "categorical",
                      "values": list(range(3, 40)), "repeat": 6}],
    }
    servers = RestServers(wrapper.build_rest_app(srv))
    try:
        res = ttester.run_contract_test(
            _contract(tmp_path, contract), host="127.0.0.1",
            port=servers.ports[0], n_requests=3, batch_size=2)
        X, names = ttester.generate_batch(contract, 2,
                                          np.random.default_rng(1))
        c = tclient.SeldonClient(host="127.0.0.1", port=servers.ports[0],
                                 transport="rest-proto")
        r = c.microservice(data=X, names=names)
    finally:
        servers.close()
        srv.stop()
    assert res["ok"], res["failures"]
    assert r.success, r.error
    np.testing.assert_array_equal(r.data, srv.predict(X, names))
