"""The port's orchestrator (seldon_tpu_torch/orchestrator/) against the JAX
package's (seldon_tpu/orchestrator/), in one process.

The same graph dicts, requests (numpy arrays with puids set by hand, so an
A/B branch is fixed) and units go through both packages; answers are
compared as ``SerializeToString(deterministic=True)``. The units are the
port's microservices (gRPC, REST proto, REST JSON, the fast lane), and,
for the cross-package checks, the JAX package's. Also: the spec's
round-trips and problems, ``sync_drivable``, identity headers on REST and
gRPC hops, the engine server over real sockets (REST JSON / proto /
multipart, both gRPC lanes, pause, readiness, metrics, /seldon.json),
workers sharing a port, the micro-batcher, ``fuse_rows`` / ``split_rows``,
the async fast client, annotations and tracing. Every socket binds port 0
and every client call has a timeout."""

import asyncio
import base64
import json
import os
import pathlib
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

import seldon_tpu.native as jnative
from seldon_tpu.core import annotations as jann
from seldon_tpu.core import http as jhttp
from seldon_tpu.core import openapi as jopenapi
from seldon_tpu.core import payloads as jpay
from seldon_tpu.core import tracing as jtr
from seldon_tpu.orchestrator import batcher as jbat
from seldon_tpu.orchestrator import client as jcli
from seldon_tpu.orchestrator import server as jsrv
from seldon_tpu.orchestrator import spec as jspec
from seldon_tpu.orchestrator import units as junits
from seldon_tpu.orchestrator import walker as jwalk
from seldon_tpu.proto import prediction_grpc as jgrpc
from seldon_tpu.proto import prediction_pb2 as jpb
from seldon_tpu.runtime import fastpath as jfast
from seldon_tpu.runtime import metrics_server as jmet
from seldon_tpu.runtime import wrapper as jwrap
import seldon_tpu_torch.native as tnative
from seldon_tpu_torch.core import annotations as tann
from seldon_tpu_torch.core import http as thttp
from seldon_tpu_torch.core import openapi as topenapi
from seldon_tpu_torch.core import payloads as tpay
from seldon_tpu_torch.core import tracing as ttr
from seldon_tpu_torch.orchestrator import batcher as tbat
from seldon_tpu_torch.orchestrator import client as tcli
from seldon_tpu_torch.orchestrator import server as tsrv
from seldon_tpu_torch.orchestrator import spec as tspec
from seldon_tpu_torch.orchestrator import units as tunits
from seldon_tpu_torch.orchestrator import walker as twalk
from seldon_tpu_torch.proto import prediction_grpc as tgrpc
from seldon_tpu_torch.proto import prediction_pb2 as tpb
from seldon_tpu_torch.runtime import fastpath as tfast
from seldon_tpu_torch.runtime import metrics_server as tmet
from seldon_tpu_torch.runtime import wrapper as twrap
from tests.torch_port_helpers import (EngineThread, RestServers, grpc_server,
                                      http_request)

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT = 30

J = SimpleNamespace(name="jax", spec=jspec, walker=jwalk, client=jcli,
                    batcher=jbat, server=jsrv, units=junits, payloads=jpay,
                    pb=jpb, grpc=jgrpc, metrics=jmet, wrapper=jwrap,
                    tracing=jtr, http=jhttp, fast=jfast)
T = SimpleNamespace(name="torch", spec=tspec, walker=twalk, client=tcli,
                    batcher=tbat, server=tsrv, units=tunits, payloads=tpay,
                    pb=tpb, grpc=tgrpc, metrics=tmet, wrapper=twrap,
                    tracing=ttr, http=thttp, fast=tfast)
PKGS = (J, T)


def spec_of(pkg, d):
    s = pkg.spec.PredictorSpec.from_dict(json.loads(json.dumps(d)))
    pkg.spec.default_unit_types(s.graph)
    return s


def request(pkg, rows, puid="", kind="dense", names=None):
    msg = pkg.payloads.build_message(np.asarray(rows, np.float64),
                                     names=names, kind=kind)
    msg.meta.puid = puid
    return msg


def wire(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


def walk(pkg, d, reqs, **engine_kw):
    """[(rows, puid, kind)] through ``pkg``'s PredictorEngine over graph
    ``d``, in one event loop (the client's channels belong to it)."""

    async def go():
        eng = pkg.walker.PredictorEngine(spec_of(pkg, d), **engine_kw)
        try:
            return [await asyncio.wait_for(
                eng.predict(request(pkg, rows, puid, kind)), TIMEOUT)
                for rows, puid, kind in reqs]
        finally:
            await eng.close()

    return asyncio.run(go())


def puid_for_branch(branch, seed=1337, ratio=0.5):
    """A puid that the A/B unit (either package's) routes to ``branch``."""
    unit = tunits.RandomABTestUnit(ratio_a=ratio, seed=seed)
    for i in range(1000):
        msg = tpb.SeldonMessage()
        msg.meta.puid = f"puid-{i}"
        if unit.route(msg, 2) == branch:
            return msg.meta.puid
    raise AssertionError("no puid found")


PUID_A, PUID_B = puid_for_branch(0), puid_for_branch(1)


# ---------------------------------------------------------------------------
# Units: the port's microservices
# ---------------------------------------------------------------------------


class FixedModel:
    def __init__(self, values, image):
        self.values = np.asarray(values, dtype=np.float64)
        self.image = image

    def predict(self, X, names, meta=None):
        return np.tile(self.values, (np.asarray(X).shape[0], 1))

    def tags(self):
        return {"image": self.image}


class FixedRouter:
    def __init__(self, branch):
        self.branch = branch
        self.feedback_seen = []

    def route(self, X, names):
        return self.branch

    def send_feedback(self, features, names, reward, truth, routing=None):
        self.feedback_seen.append((float(reward), routing))


class Doubler:
    def __init__(self):
        self.batches = []  # (rows, batch_index tag or None) per call

    def predict(self, X, names, meta=None):
        X = np.asarray(X)
        tags = (meta or {}).get("tags", {})
        self.batches.append((X.shape[0], tags.get("batch_index")))
        return X * 2.0

    def tags(self):
        return {"arm": "doubler"}

    def metrics(self):
        return [{"type": "COUNTER", "key": "doubler_calls", "value": 1}]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def units():
    """The port's units on 127.0.0.1: m1, m2, the router and the doubler
    on gRPC; the doubler also on REST and the fast lane; and the JAX
    package's doubler on gRPC and REST (cross-package)."""
    objs = dict(m1=FixedModel([[1, 2, 3, 4]], "fixed:0.1"),
                m2=FixedModel([[5, 6, 7, 8]], "fixed:0.2"),
                r=FixedRouter(1), d=Doubler(), jd=Doubler())
    servers, ports = [], {}
    for name in ("m1", "m2", "r", "d"):
        srv, ports[name] = grpc_server(twrap, objs[name])
        servers.append(srv)
    jg, ports["jd"] = grpc_server(jwrap, objs["jd"])
    servers.append(jg)
    rest = RestServers(twrap.build_rest_app(objs["d"]),
                       jwrap.build_rest_app(objs["jd"]))
    ports["d_rest"], ports["jd_rest"] = rest.ports
    fast, ports["d_fast"] = tfast.start_fast_server(objs["d"], "127.0.0.1", 0)
    try:
        yield SimpleNamespace(ports=ports, **objs)
    finally:
        fast.shutdown()
        fast.server_close()
        rest.close()
        for srv in servers:
            srv.stop(grace=0.5)


def ep(port, type_="GRPC", **kw):
    return {"service_host": "127.0.0.1", "service_port": port, "type": type_,
            **kw}


def model(name, endpoint, image=""):
    d = {"name": name, "type": "MODEL", "endpoint": endpoint}
    if image:
        d["image"] = image
    return d


def network_graphs(p):
    """Graph dicts over the ``units`` fixture's ports ``p``."""
    return {
        "router_grpc": {"name": "p", "graph": {
            "name": "router", "type": "ROUTER", "endpoint": ep(p["r"]),
            "children": [model("m1", ep(p["m1"]), "fixed:0.1"),
                         model("m2", ep(p["m2"]), "fixed:0.2")]}},
        "combiner_grpc": {"name": "p", "graph": {
            "name": "comb", "implementation": "AVERAGE_COMBINER",
            "children": [model("m1", ep(p["m1"])), model("m2", ep(p["m2"]))]}},
        "abtest_rest_proto": {"name": "p", "graph": {
            "name": "ab", "implementation": "RANDOM_ABTEST",
            "children": [model("d", ep(p["d_rest"], "REST"), "dbl:1"),
                         model("m2", ep(p["m2"]))]}},
        "abtest_rest_json": {"name": "p", "graph": {
            "name": "ab", "implementation": "RANDOM_ABTEST",
            "children": [model("d", ep(p["d_rest"], "REST", content="json")),
                         model("m2", ep(p["m2"]))]}},
        "fast_lane": {"name": "p", "graph": model(
            "d", ep(p["d"], fast_port=p["d_fast"]), "dbl:2")},
        "combiner_mixed": {"name": "p", "graph": {
            "name": "comb", "implementation": "AVERAGE_COMBINER",
            "children": [model("d1", ep(p["d_rest"], "REST", content="json")),
                         model("d2", ep(p["d"], fast_port=p["d_fast"]))]}},
    }


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

SPECS = {
    "simple": {"name": "p", "graph": {"name": "m",
                                      "implementation": "SIMPLE_MODEL"}},
    "abtest_params": {"name": "p", "traffic": 40, "replicas": 2, "graph": {
        "name": "ab", "implementation": "RANDOM_ABTEST",
        "parameters": [{"name": "ratioA", "value": "0.3", "type": "FLOAT"},
                       {"name": "seed", "value": 7, "type": "INT"}],
        "children": [{"name": "a", "implementation": "SIMPLE_MODEL"},
                     {"name": "b", "implementation": "SIMPLE_MODEL"}]}},
    "network_chain": {"name": "q", "labels": {"team": "x"},
                      "annotations": {"seldon.io/x": "1"}, "graph": {
        "name": "t", "type": "TRANSFORMER", "image": "trans:0.3",
        "endpoint": {"serviceHost": "h", "servicePort": 9100},
        "children": [{
            "name": "r", "type": "ROUTER", "endpoint": ep(9101),
            "children": [
                {"name": "llm", "implementation": "JAX_SERVER",
                 "modelUri": "gs://bucket/llm", "serviceAccountName": "sa",
                 "endpoint": {"service_host": "u", "service_port": 9102,
                              "fastPort": 9103}},
                {"name": "o", "type": "OUTPUT_TRANSFORMER",
                 "endpoint": ep(9104, "REST", content="JSON")}]}]}},
    "combiner_network": {"name": "p", "graph": {
        "name": "c", "type": "COMBINER", "endpoint": ep(9004),
        "children": [model("a", ep(9000)), model("b", ep(9001))]}},
    "combiner_hardcoded": {"name": "p", "graph": {
        "name": "c", "implementation": "AVERAGE_COMBINER",
        "children": [{"name": "a", "implementation": "SIMPLE_MODEL"},
                     {"name": "b", "implementation": "SIMPLE_MODEL"}]}},
    "rest_leaf": {"name": "p", "graph": model("m", ep(9000, "REST"))},
    "router_without_children": {"name": "p", "graph": {"name": "r",
                                                       "type": "ROUTER"}},
    "combiner_without_children": {"name": "p", "graph": {
        "name": "c", "implementation": "AVERAGE_COMBINER"}},
    "model_without_endpoint": {"name": "p", "graph": {"name": "m",
                                                      "type": "MODEL"}},
    "prepackaged_without_uri": {"name": "p", "graph": {
        "name": "m", "implementation": "SKLEARN_SERVER",
        "endpoint": ep(9000)}},
    "duplicate_names": {"name": "p", "graph": {
        "name": "x", "implementation": "SIMPLE_ROUTER",
        "children": [{"name": "x", "implementation": "SIMPLE_MODEL"}]}},
}


@pytest.mark.parametrize("case", sorted(SPECS))
def test_spec_round_trip_and_problems(case):
    d = SPECS[case]
    js, ts = (spec_of(pkg, d) for pkg in PKGS)
    assert ts.to_dict() == js.to_dict()
    assert (tspec.PredictorSpec.from_dict(ts.to_dict()).to_dict()
            == jspec.PredictorSpec.from_dict(js.to_dict()).to_dict())
    assert tspec.validate_spec(ts) == jspec.validate_spec(js)
    assert ([u.name for u in ts.graph.walk()]
            == [u.name for u in js.graph.walk()])
    assert (twalk.PredictorEngine.sync_drivable(ts)
            == jwalk.PredictorEngine.sync_drivable(js))
    assert not twalk.PredictorEngine.sync_drivable(ts, batcher=object())
    expected_problems = {"router_without_children", "combiner_without_children",
                         "model_without_endpoint", "prepackaged_without_uri",
                         "duplicate_names"}
    assert bool(tspec.validate_spec(ts)) == (case in expected_problems)


@pytest.mark.parametrize("bad", [
    {"name": "m", "endpoint": {"content": "xml"}},
    {"name": "m", "type": "NOT_A_TYPE"},
    {"name": "m", "implementation": "NOT_AN_IMPL"},
])
def test_spec_rejects_bad_values_alike(bad):
    errs = []
    for pkg in PKGS:
        with pytest.raises(ValueError) as e:
            pkg.spec.PredictiveUnit.from_dict(bad)
        errs.append(str(e.value))
    assert errs[0] == errs[1]


def test_load_predictor_spec_env_file_default(tmp_path, monkeypatch):
    d = SPECS["abtest_params"]
    monkeypatch.setenv("ENGINE_PREDICTOR",
                       base64.b64encode(json.dumps(d).encode()).decode())
    assert (tspec.load_predictor_spec().to_dict()
            == jspec.load_predictor_spec().to_dict())
    monkeypatch.delenv("ENGINE_PREDICTOR")
    f = tmp_path / "deploymentdef.json"
    f.write_text(json.dumps(SPECS["network_chain"]))
    assert (tspec.load_predictor_spec(fallback_path=str(f)).to_dict()
            == jspec.load_predictor_spec(fallback_path=str(f)).to_dict())
    nowhere = str(tmp_path / "absent.json")
    assert (tspec.load_predictor_spec(fallback_path=nowhere).to_dict()
            == jspec.load_predictor_spec(fallback_path=nowhere).to_dict())
    f.write_text(json.dumps(SPECS["duplicate_names"]))
    for pkg in PKGS:
        with pytest.raises(ValueError, match="duplicate"):
            pkg.spec.load_predictor_spec(fallback_path=str(f))


# ---------------------------------------------------------------------------
# Hardcoded graphs (no network)
# ---------------------------------------------------------------------------

HARDCODED = {
    "simple": SPECS["simple"],
    "abtest": SPECS["abtest_params"],
    "combiner": SPECS["combiner_hardcoded"],
    "router": {"name": "p", "graph": {
        "name": "r", "implementation": "SIMPLE_ROUTER",
        "children": [{"name": "a", "implementation": "SIMPLE_MODEL"},
                     {"name": "b", "implementation": "SIMPLE_MODEL"}]}},
}


@pytest.mark.parametrize("kind", ["dense", "tensor", "ndarray"])
@pytest.mark.parametrize("graph", sorted(HARDCODED))
def test_hardcoded_graph_answers_equal(graph, kind):
    reqs = [([[1.0, 2.0]], f"puid-{i}", kind) for i in range(6)]
    want, got = (walk(pkg, HARDCODED[graph], reqs) for pkg in PKGS)
    assert [wire(m) for m in got] == [wire(m) for m in want]
    assert all(m.meta.requestPath for m in got)


def test_predict_sync_and_drive_sync_on_hardcoded_graphs():
    for d in HARDCODED.values():
        outs = []
        for pkg in PKGS:
            eng = pkg.walker.PredictorEngine(spec_of(pkg, d))
            assert eng.all_hardcoded
            outs.append(eng.predict_sync(request(pkg, [[3.0]], "p-sync")))
            fb = pkg.pb.Feedback(reward=1.0)
            fb.response.meta.puid = "p-sync"
            outs.append(eng.drive_sync(eng.send_feedback(fb)))
        assert wire(outs[2]) == wire(outs[0])
        assert wire(outs[3]) == wire(outs[1])


def test_drive_sync_raises_when_a_walk_suspends():
    async def suspends():
        await asyncio.sleep(0)

    for pkg in PKGS:
        with pytest.raises(RuntimeError, match="graph walk suspended"):
            pkg.walker.PredictorEngine.drive_sync(suspends())


@pytest.mark.parametrize("ratio,seed", [(0.5, 1337), (0.2, 7), (0.9, 42)])
def test_ab_branch_per_puid_equal(ratio, seed):
    ju = junits.RandomABTestUnit(ratio_a=ratio, seed=seed)
    tu = tunits.RandomABTestUnit(ratio_a=ratio, seed=seed)
    branches = []
    for i in range(200):
        jm, tm = jpb.SeldonMessage(), tpb.SeldonMessage()
        jm.meta.puid = tm.meta.puid = f"req-{i}"
        branches.append(tu.route(tm, 2))
        assert branches[-1] == ju.route(jm, 2)
    assert set(branches) == {0, 1}


def test_average_combiner_rejects_mismatched_shapes_alike():
    errs = []
    for pkg in PKGS:
        unit = pkg.units.make_hardcoded(
            pkg.spec.UnitImplementation.AVERAGE_COMBINER)
        with pytest.raises(ValueError) as e:
            unit.aggregate([request(pkg, [[1.0, 2.0]]),
                            request(pkg, [[1.0, 2.0, 3.0]])])
        errs.append(str(e.value))
        with pytest.raises(ValueError):
            pkg.units.make_hardcoded(
                pkg.spec.UnitImplementation.SKLEARN_SERVER)
    assert errs[0] == errs[1]


# ---------------------------------------------------------------------------
# Graphs over the port's microservices
# ---------------------------------------------------------------------------

GRAPH_REQS = [([[1.0, 2.0]], PUID_A, "dense"),
              ([[3.0, -1.5], [0.5, 4.0]], PUID_B, "ndarray"),
              ([[2.0, 2.0]], PUID_A, "tensor")]


@pytest.mark.parametrize("graph", ["router_grpc", "combiner_grpc",
                                   "abtest_rest_proto", "abtest_rest_json",
                                   "fast_lane", "combiner_mixed"])
def test_network_graph_answers_equal(units, graph):
    d = network_graphs(units.ports)[graph]
    want, got = (walk(pkg, d, GRAPH_REQS) for pkg in PKGS)
    if graph == "combiner_grpc":
        # The children answer concurrently and each tags "image": the walk
        # keeps whichever answer merged last, in either package.
        for m in want + got:
            assert m.meta.tags["image"].string_value in ("fixed:0.1",
                                                         "fixed:0.2")
            del m.meta.tags["image"]
    assert [wire(m) for m in got] == [wire(m) for m in want]
    if graph.startswith("abtest"):
        assert [m.meta.routing["ab"] for m in got] == [0, 1, 0]
        assert "d" in got[0].meta.requestPath
        assert "m2" in got[1].meta.requestPath
        np.testing.assert_array_equal(tpay.get_data_from_message(got[0]),
                                      [[2.0, 4.0]])
    if graph == "router_grpc":
        assert got[0].meta.routing["router"] == 1
        assert got[0].meta.requestPath["m2"] == "fixed:0.2"
        assert got[0].meta.tags["image"].string_value == "fixed:0.2"
    if graph == "combiner_grpc":
        np.testing.assert_array_equal(tpay.get_data_from_message(got[0]),
                                      [[3, 4, 5, 6]])


@pytest.mark.parametrize("fast", [True, False])
def test_sync_client_solo_walk_equal(units, fast):
    """The sync lane's blocking client (gRPC, or the fast lane) and the
    solo-MODEL fast walk give the JAX package's answer."""
    p = units.ports
    d = {"name": "p", "graph": model(
        "d", ep(p["d"], fast_port=p["d_fast"] if fast else 0), "dbl:2")}
    outs = []
    for pkg in PKGS:
        eng = pkg.walker.PredictorEngine(
            spec_of(pkg, d), client=pkg.client.SyncInternalClient(retries=1))
        assert eng._solo_unit is not None
        outs.append([wire(eng.predict_sync(request(pkg, rows, puid, kind)))
                     for rows, puid, kind in GRAPH_REQS])
        eng.drive_sync(eng.close())
    assert outs[1] == outs[0]


def test_feedback_follows_recorded_route(units):
    d = network_graphs(units.ports)["router_grpc"]
    seen = {}
    for pkg in PKGS:
        units.r.feedback_seen.clear()
        rewards = []

        async def go():
            eng = pkg.walker.PredictorEngine(
                spec_of(pkg, d),
                reward_hook=lambda unit, r: rewards.append((unit.name, r)))
            try:
                fb = pkg.pb.Feedback(reward=0.75)
                fb.request.CopyFrom(request(pkg, [[1.0]]))
                fb.response.meta.puid = "fb-1"
                fb.response.meta.routing["router"] = 1
                out = await asyncio.wait_for(eng.send_feedback(fb), TIMEOUT)
            finally:
                await eng.close()
            return out

        out = asyncio.run(go())
        assert out.meta.puid == "fb-1"
        seen[pkg.name] = (list(units.r.feedback_seen), rewards)
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0][0][0] == 0.75
    # The router and the branch the response took (m2), not m1.
    assert seen["torch"][1] == [("router", 0.75), ("m2", 0.75)]


# ---------------------------------------------------------------------------
# Identity headers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("image", [
    "repo/img:1.2", "repo/img", "", "localhost:5000/team/model",
    "localhost:5000/team/model:2.1", "repo/img@sha256:abc123"])
def test_identity_headers_equal(image):
    assert (tcli.identity_headers(tspec.PredictiveUnit(name="u", image=image))
            == jcli.identity_headers(jspec.PredictiveUnit(name="u",
                                                          image=image)))


def test_identity_headers_on_every_rest_hop():
    from aiohttp import web

    seen = {"jax": {}, "torch": {}}
    current = []

    async def handle(req):
        seen[current[0]][req.headers["seldon-model-name"]] = (
            req.headers.get("seldon-model-image"),
            req.headers.get("seldon-model-version"))
        out = tpay.build_message(np.array([[1.0]]), kind="dense")
        return web.Response(body=out.SerializeToString(),
                            content_type=thttp.PROTO_CONTENT_TYPE)

    app = web.Application()
    app.router.add_post("/predict", handle)
    app.router.add_post("/transform-input", handle)
    rest = RestServers(app)
    try:
        port = rest.ports[0]
        d = {"name": "p", "graph": {
            "name": "t", "type": "TRANSFORMER", "image": "trans:0.3",
            "endpoint": ep(port, "REST"),
            "children": [model("m", ep(port, "REST"), "model:0.7")]}}
        for pkg in PKGS:
            current[:] = [pkg.name]
            walk(pkg, d, [([[1.0, 2.0]], "id-1", "dense")])
    finally:
        rest.close()
    assert seen["torch"] == seen["jax"] == {"t": ("trans", "0.3"),
                                            "m": ("model", "0.7")}


def test_identity_metadata_on_grpc_hop():
    seen = []

    class Interceptor(grpc.ServerInterceptor):
        def intercept_service(self, continuation, details):
            md = dict(details.invocation_metadata)
            if "seldon-model-name" in md:
                seen.append((md["seldon-model-name"],
                             md.get("seldon-model-image"),
                             md.get("seldon-model-version")))
            return continuation(details)

    srv = twrap.build_grpc_server(FixedModel([[1.0, 2.0]], "fixed:0.1"),
                                  interceptors=[Interceptor()])
    port = srv.add_insecure_port("127.0.0.1:0")
    srv.start()
    try:
        d = {"name": "p", "graph": model("m", ep(port), "img:9.9")}
        outs = [walk(pkg, d, [([[1.0]], "id-2", "dense")])[0]
                for pkg in PKGS]
    finally:
        srv.stop(0)
    assert seen == [("m", "img", "9.9")] * 2
    assert wire(outs[1]) == wire(outs[0])


# ---------------------------------------------------------------------------
# The engine server over real sockets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def engines(units):
    """Per package: a sync-lane engine (solo gRPC MODEL with the fast
    lane, unbatched) and an asyncio-lane engine (an A/B test over REST and
    gRPC units, the batcher on)."""
    g = network_graphs(units.ports)
    out = {}
    try:
        for pkg in PKGS:
            out[pkg.name] = SimpleNamespace(
                sync=EngineThread(pkg.server.EngineServer(
                    spec=spec_of(pkg, g["fast_lane"]), http_port=0,
                    grpc_port=0, enable_batching=False,
                    metrics=pkg.metrics.ServerMetrics())),
                aio=EngineThread(pkg.server.EngineServer(
                    spec=spec_of(pkg, g["abtest_rest_proto"]), http_port=0,
                    grpc_port=0, metrics=pkg.metrics.ServerMetrics())))
        yield out
    finally:
        for e in out.values():
            e.sync.close()
            e.aio.close()


def grpc_predict(pkg, port, msg, timeout=TIMEOUT):
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        return pkg.grpc.SeldonStub(ch).Predict(msg, timeout=timeout)


def test_engine_grpc_lanes(engines):
    assert type(engines["torch"].sync.es._grpc_server).__name__ == "_Server"
    assert type(engines["torch"].aio.es._grpc_server).__name__ == "Server"
    for lane in ("sync", "aio"):
        outs = [[wire(grpc_predict(pkg, getattr(engines[pkg.name], lane).grpc,
                                   request(pkg, rows, puid, kind)))
                 for rows, puid, kind in GRAPH_REQS] for pkg in PKGS]
        assert outs[1] == outs[0], lane


@pytest.mark.parametrize("encoding", ["json", "proto", "multipart"])
def test_engine_rest_encodings(engines, encoding):
    def post(pkg, port):
        if encoding == "json":
            body = {"data": {"ndarray": [[1.0, 2.0]]},
                    "meta": {"puid": PUID_A}}
            status, raw = http_request(port, "POST", "/api/v0.1/predictions",
                                       body, timeout=TIMEOUT)
            return status, json.loads(raw)
        if encoding == "proto":
            status, raw = http_request(
                port, "POST", "/api/v0.1/predictions",
                wire(request(pkg, [[1.0, 2.0]], PUID_B)),
                {"Content-Type": thttp.PROTO_CONTENT_TYPE}, timeout=TIMEOUT)
            return status, raw
        boundary = "orchestrator-test-boundary"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="strData"; filename="doc.txt"\r\n'
                f"Content-Type: text/plain\r\n\r\nhello text\r\n"
                f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="meta"\r\n\r\n{{"puid": "mp-1", "tags": '
                f'{{"src": "upload"}}}}\r\n--{boundary}--\r\n').encode()
        status, raw = http_request(
            port, "POST", "/api/v0.1/predictions", body,
            {"Content-Type": f"multipart/form-data; boundary={boundary}"},
            timeout=TIMEOUT)
        return status, json.loads(raw)

    d_hardcoded = {"name": "p", "graph": {"name": "m",
                                          "implementation": "SIMPLE_MODEL"}}
    outs = []
    for pkg in PKGS:
        if encoding == "multipart":  # a unit with no array kind: SIMPLE_MODEL
            et = EngineThread(pkg.server.EngineServer(
                spec=spec_of(pkg, d_hardcoded), http_port=0, grpc_port=0,
                metrics=pkg.metrics.ServerMetrics()))
            try:
                outs.append(post(pkg, et.http))
            finally:
                et.close()
        else:
            outs.append(post(pkg, engines[pkg.name].aio.http))
    assert outs[0][0] == outs[1][0] == 200, outs
    assert outs[1][1] == outs[0][1]
    if encoding == "multipart":
        assert outs[1][1]["meta"]["tags"]["src"] == "upload"
        assert outs[1][1]["data"]["names"] == ["proba0", "proba1", "proba2"]


def test_engine_pause_ready_metrics_openapi(engines, units):
    port = engines["torch"].aio.http
    gport = engines["torch"].aio.grpc
    body = {"data": {"ndarray": [[1.0, 2.0]]}}
    assert http_request(port, "GET", "/live", timeout=TIMEOUT)[0] == 200
    assert http_request(port, "GET", "/ready", timeout=TIMEOUT)[0] == 200
    status, text = http_request(port, "GET", "/metrics", timeout=TIMEOUT)
    assert status == 200 and b"seldon_graph_ready 1.0" in text
    assert http_request(port, "POST", "/pause", timeout=TIMEOUT)[0] == 200
    assert http_request(port, "POST", "/api/v0.1/predictions", body,
                        timeout=TIMEOUT)[0] == 503
    assert http_request(port, "GET", "/ready", timeout=TIMEOUT)[0] == 503
    with pytest.raises(grpc.RpcError) as e:
        grpc_predict(T, gport, request(T, [[1.0]]))
    assert e.value.code() == grpc.StatusCode.UNAVAILABLE
    assert http_request(port, "GET", "/unpause", timeout=TIMEOUT)[0] == 200
    status, raw = http_request(port, "POST", "/api/v0.1/predictions", body,
                               timeout=TIMEOUT)
    assert status == 200 and json.loads(raw)["meta"]["puid"]
    status, text = http_request(port, "GET", "/prometheus", timeout=TIMEOUT)
    assert (b'seldon_api_executor_server_requests_total{method="predictions",'
            b'transport="rest"}' in text)
    assert b"doubler_calls" in text or b"seldon_graph_ready" in text
    status, raw = http_request(port, "GET", "/seldon.json", timeout=TIMEOUT)
    assert status == 200
    assert json.loads(raw) == json.loads(json.dumps(
        jopenapi.engine_openapi("p")))
    assert topenapi.engine_openapi("x") == jopenapi.engine_openapi("x")
    # A graph whose unit is gone is not ready, and the gauge says so.
    es = tsrv.EngineServer(
        spec=spec_of(T, {"name": "p", "graph": model("m",
                                                    ep(_free_port()))}),
        http_port=0, grpc_port=0, metrics=tmet.ServerMetrics())
    et = EngineThread(es)
    try:
        assert http_request(et.http, "GET", "/ready",
                            timeout=TIMEOUT)[0] == 503
        assert (b"seldon_graph_ready 0.0"
                in http_request(et.http, "GET", "/metrics",
                                timeout=TIMEOUT)[1])
    finally:
        et.close()


def test_engine_feedback_moves_reward_counter(engines, units):
    port = engines["torch"].aio.http
    body = {"reward": 0.5, "request": {"data": {"ndarray": [[1.0]]}},
            "response": {"meta": {"puid": "fb-2", "routing": {"ab": 0}}}}
    status, raw = http_request(port, "POST", "/api/v0.1/feedback", body,
                               timeout=TIMEOUT)
    assert status == 200 and json.loads(raw)["meta"]["puid"] == "fb-2"
    text = http_request(port, "GET", "/metrics", timeout=TIMEOUT)[1]
    assert b'seldon_api_model_feedback_reward_total{unit="ab"} 0.5' in text
    assert (b'seldon_api_executor_server_requests_total{method="feedback",'
            b'transport="rest"} 1.0' in text)


def test_engine_server_picks_up_annotations(tmp_path, monkeypatch):
    p = tmp_path / "annotations"
    p.write_text('seldon.io/grpc-max-message-size="7777777"\n'
                 'seldon.io/rest-connect-retries="9"\n'
                 'seldon.io/rest-read-timeout="2500"\n')
    monkeypatch.setenv("PODINFO_ANNOTATIONS", str(p))
    for pkg in PKGS:
        es = pkg.server.EngineServer(spec=spec_of(pkg, SPECS["simple"]),
                                     metrics=pkg.metrics.ServerMetrics())
        assert es.grpc_max_msg == 7777777
        assert es.engine.client.retries == 9
        assert es.engine.client.timeout_s == 2.5


def test_multiworker_engine_shares_port():
    """``--workers 2`` on one port (SO_REUSEPORT): both worker processes
    serve the default SIMPLE_MODEL graph. The supervisor runs with an
    import hook that refuses the JAX package, jax and torch (the
    orchestrator is host code); the forked workers inherit it, so a worker
    that imported any of them would not answer."""
    http_port, grpc_port = _free_port(), _free_port()
    code = (
        "import importlib.abc, runpy, sys\n"
        "class Refuse(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('seldon_tpu', 'jax', 'jaxlib',\n"
        "                                   'torch'):\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "sys.argv = ['server', '--workers', '2', '--http-port', "
        f"'{http_port}', '--grpc-port', '{grpc_port}', '--no-batching']\n"
        "runpy.run_module('seldon_tpu_torch.orchestrator.server', "
        "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env.pop("ENGINE_PREDICTOR", None)
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + 60
        out = None
        while time.time() < deadline and out is None:
            try:
                status, raw = http_request(
                    http_port, "POST", "/api/v0.1/predictions",
                    {"data": {"ndarray": [[1.0]]}}, timeout=5)
                if status == 200:
                    out = json.loads(raw)
            except OSError:
                assert proc.poll() is None, proc.stdout.read()[-2000:]
                time.sleep(0.3)
        assert out is not None, "engine never came up"
        assert out["meta"]["requestPath"] == {"simple-model": "simple-model"}
        # Many connections reach both workers; all answer.
        for _ in range(10):
            assert http_request(http_port, "GET", "/live", timeout=5)[0] == 200
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=15)
        proc.stdout.close()


# ---------------------------------------------------------------------------
# Micro-batcher
# ---------------------------------------------------------------------------


def _batched(pkg, unit_dict, msgs, **batcher_kw):
    async def go():
        batcher = pkg.batcher.MicroBatcher(**batcher_kw)
        client = pkg.client.InternalClient()
        unit = pkg.spec.PredictiveUnit.from_dict(unit_dict)
        try:
            outs = await asyncio.wait_for(asyncio.gather(
                *(batcher.call(unit, m, client) for m in msgs)), TIMEOUT)
        finally:
            await client.close()
        return outs, dict(batcher.stats)

    return asyncio.run(go())


def test_batcher_fuses_and_splits_per_puid(units):
    unit = model("d", ep(units.ports["d"]))
    results = []
    for pkg in PKGS:
        units.d.batches.clear()
        msgs = [request(pkg, np.full((1 + i % 2, 3), float(i)), f"b{i}",
                        kind="dense" if i % 3 else "ndarray")
                for i in range(8)]
        outs, stats = _batched(pkg, unit, msgs, max_batch_size=64,
                               window_ms=50.0)
        results.append(([wire(o) for o in outs], stats,
                         list(units.d.batches)))
        for i, o in enumerate(outs):
            assert o.meta.puid == f"b{i}"
            np.testing.assert_array_equal(
                pkg.payloads.get_data_from_message(o),
                np.full((1 + i % 2, 3), 2.0 * i))
    assert results[1] == results[0]
    stats, batches = results[1][1], results[1][2]
    assert stats["fused_calls"] >= 1 and stats["batched_requests"] > 1
    rows, tag = next(b for b in batches if b[1] is not None)
    bi = tpb.BatchIndex.FromString(bytes.fromhex(tag))
    assert sum(bi.row_counts) == rows
    assert list(bi.puids)[:2] == ["b0", "b1"]


def test_batcher_passes_through_requests_it_must_not_fuse(units):
    unit = model("d", ep(units.ports["d"]))
    results = []
    for pkg in PKGS:
        tagged = request(pkg, [[1.0, 2.0]], "t0")
        tagged.meta.tags["batch_index"].string_value = "00"
        one_d = request(pkg, [1.0, 2.0], "t1", kind="ndarray")
        a = request(pkg, [[1.0, 2.0]], "t2")
        a.meta.tags["tenant"].string_value = "x"
        b = request(pkg, [[3.0, 4.0]], "t3")
        b.meta.tags["tenant"].string_value = "y"
        c = request(pkg, [[5.0, 6.0, 7.0]], "t4")
        outs, stats = _batched(pkg, unit, [tagged, one_d, a, b, c],
                               window_ms=20.0)
        results.append(([wire(o) for o in outs], stats))
    assert results[1] == results[0]
    assert results[1][1]["direct_calls"] >= 2
    assert results[1][1]["tag_flushes"] >= 1


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8"])
def test_fuse_and_split_rows_bit_equal(dtype):
    rng = np.random.default_rng(3)
    parts = [(rng.standard_normal((n, 3, 5)) * 50).astype(dtype)
             for n in (1, 4, 2, 7)]
    want, got = jnative.fuse_rows(parts), tnative.fuse_rows(parts)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    counts = [3, 0, 8, 3]
    for w, g in zip(jnative.split_rows(want, counts),
                    tnative.split_rows(got, counts)):
        assert g.shape == w.shape and g.tobytes() == w.tobytes()
    with pytest.raises(ValueError):
        tnative.split_rows(got, [1, 2])


# ---------------------------------------------------------------------------
# The async fast client, annotations, tracing, the runtime helpers
# ---------------------------------------------------------------------------


def test_async_fast_client_stale_pool_survives_restart():
    srv, port = tfast.start_fast_server(Doubler(), "127.0.0.1", 0)

    async def go():
        c = tfast.AsyncFastClient(timeout_s=TIMEOUT)
        out = await c.call("127.0.0.1", port, "predict",
                           request(T, [[1.0, 2.0]]))
        np.testing.assert_array_equal(tpay.get_data_from_message(out),
                                      [[2.0, 4.0]])
        srv.shutdown()
        srv.server_close()
        srv2, _ = tfast.start_fast_server(Doubler(), "127.0.0.1", port)
        try:
            try:
                await c.call("127.0.0.1", port, "predict",
                             request(T, [[1.0, 2.0]]))
                stale = None  # the at_eof skim may already have dropped it
            except ConnectionError as e:
                stale = e
                await c.call("127.0.0.1", port, "predict",
                             request(T, [[1.0, 2.0]]))
            if stale is not None:
                assert isinstance(stale, tfast.StaleConnection), stale
        finally:
            await c.close()
            srv2.shutdown()
            srv2.server_close()

    asyncio.run(go())


@pytest.mark.parametrize("text", [
    'seldon.io/rest-read-timeout="10000"\nseldon.io/rest-connect-retries="5"'
    '\nkubernetes.io/config.seen="2026-01-01T00:00:00"\nweird="va\\"lue"\n',
    'path="C:\\\\network"\nnl="a\\nb\\tc"\n\nnoequals\nbare=value\n',
    'seldon.io/grpc-max-message-size="1048576"\n'
    'seldon.io/rest-connect-retries="notanint"\n',
])
def test_annotations_equal(tmp_path, text):
    assert tann.parse_downward_api(text) == jann.parse_downward_api(text)
    p = tmp_path / "annotations"
    p.write_text(text)
    cfgs = [tann.AnnotationsConfig(path=str(p)),
            jann.AnnotationsConfig(path=str(p))]
    for getter in ("rest_timeout_s", "connect_retries", "grpc_timeout_s",
                   "grpc_max_msg_bytes"):
        assert (getattr(cfgs[0], getter)() == getattr(cfgs[1], getter)()), (
            getter)
    missing = tann.AnnotationsConfig(path=str(tmp_path / "nope"))
    assert missing.rest_timeout_s(3000) == 3.0 and missing.annotations == {}


def _two_hop_spec(pkg, port_a, port_b):
    return spec_of(pkg, {"name": "p", "graph": {
        "name": "transformer-a", "type": "TRANSFORMER", "endpoint": ep(port_a),
        "children": [model("model-b", ep(port_b))]}})


class _Times2:
    def transform_input(self, X, names, meta=None):
        return np.asarray(X) * 2.0


class _Plus1:
    def predict(self, X, names, meta=None):
        return np.asarray(X) + 1.0


def test_one_trace_spans_engine_and_units(tmp_path, monkeypatch):
    names = {}
    for pkg in PKGS:
        trace_file = tmp_path / f"{pkg.name}.jsonl"
        monkeypatch.setenv("TRACING", "1")
        monkeypatch.setenv("TRACING_FILE", str(trace_file))
        sa, pa = grpc_server(pkg.wrapper, _Times2())
        sb, pb_ = grpc_server(pkg.wrapper, _Plus1())
        try:
            eng = pkg.walker.PredictorEngine(_two_hop_spec(pkg, pa, pb_))
            out = asyncio.run(eng.predict(request(pkg, [[1.0, 2.0]], "tr")))
            np.testing.assert_array_equal(
                pkg.payloads.get_data_from_message(out), [[3.0, 5.0]])
        finally:
            sa.stop(0)
            sb.stop(0)
        spans = [json.loads(line)
                 for line in trace_file.read_text().splitlines()]
        by_name = {s["name"]: s for s in spans}
        names[pkg.name] = sorted(by_name)
        assert len({s["trace_id"] for s in spans}) == 1, spans
        assert (by_name["unit.predict"]["parent_id"]
                == by_name["unit.model-b"]["span_id"])
        assert (by_name["unit.transform-input"]["parent_id"]
                == by_name["unit.transformer-a"]["span_id"])
        assert by_name["engine.predict"]["parent_id"] is None
        assert by_name["engine.predict"]["service"] == "engine"
    assert names["torch"] == names["jax"]
    assert {"engine.predict", "unit.transformer-a", "unit.model-b",
            "unit.transform-input", "unit.predict"} <= set(names["torch"])


def test_incoming_traceparent_becomes_root(tmp_path, monkeypatch):
    trace_file = tmp_path / "spans.jsonl"
    monkeypatch.setenv("TRACING", "1")
    monkeypatch.setenv("TRACING_FILE", str(trace_file))
    eng = twalk.PredictorEngine(spec_of(T, SPECS["simple"]))
    ctx = ttr.SpanContext("ee" * 16, "ff" * 8)
    asyncio.run(eng.predict(request(T, [[1.0]]), trace_parent=ctx))
    spans = [json.loads(line) for line in trace_file.read_text().splitlines()]
    root = next(s for s in spans if s["name"] == "engine.predict")
    assert root["trace_id"] == "ee" * 16 and root["parent_id"] == "ff" * 8
    assert ttr.inject_current({}) == {}
    with ttr.get_tracer("t").span("outer") as span:
        carrier = ttr.inject_current({"x": "1"})
    assert carrier["traceparent"] == span.context.to_traceparent()
    tp = ttr.new_traceparent()
    parsed = ttr.SpanContext.from_traceparent(tp)
    assert parsed is not None and tp == parsed.to_traceparent()
    assert jtr.SpanContext.from_traceparent(tp) is not None


def test_runtime_helpers_equal():
    rows = np.array([[1.5, -2.0], [3.0, 4.25]])
    for kind in ("dense", "tensor", "ndarray"):
        assert (thttp.to_json_bytes(tpay.build_message(rows, kind=kind))
                == jhttp.to_json_bytes(jpay.build_message(rows, kind=kind)))
        for enc in ("proto", "json"):
            assert (thttp.reply(tpay.build_message(rows, kind=kind), enc).body
                    == jhttp.reply(jpay.build_message(rows, kind=kind),
                                   enc).body)
    fb = {"request": {"data": {"ndarray": [[1.0]]}}, "reward": 0.5,
          "truth": {"data": {"ndarray": [[0.0]]}}}
    tfb, jfb = tpay.json_to_feedback(fb), jpay.json_to_feedback(fb)
    assert wire(tfb) == wire(jfb)
    assert tpay.feedback_to_dict(tfb) == jpay.feedback_to_dict(jfb)
    payload = {"data": {"tensor": {"shape": [2, 2], "values": [1, 2, 3, 4]}}}
    np.testing.assert_array_equal(tpay.ndarray_from_json_payload(payload),
                                  jpay.ndarray_from_json_payload(payload))
    assert tpay.b64_bytes(b"\x00\xffab") == jpay.b64_bytes(b"\x00\xffab")
    sm = tmet.ServerMetrics()
    sm.set_graph_ready(True)
    assert b"seldon_graph_ready 1.0" in sm.export()[0]
    sm.set_graph_ready(False)
    assert b"seldon_graph_ready 0.0" in sm.export()[0]


# ---------------------------------------------------------------------------
# Across the packages: either engine in front of either package's unit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("transport", ["GRPC", "REST"])
def test_cross_package_engines_and_units(units, transport):
    """The JAX EngineServer calls a port unit and the port's EngineServer
    calls a JAX unit (and each its own package's); every answer equal."""
    p = units.ports
    unit_ports = {"torch": p["d"] if transport == "GRPC" else p["d_rest"],
                  "jax": p["jd"] if transport == "GRPC" else p["jd_rest"]}
    answers = {}
    for eng_pkg in PKGS:
        for unit_pkg in ("jax", "torch"):
            d = {"name": "p", "graph": model(
                "d", ep(unit_ports[unit_pkg], transport), "dbl:3")}
            et = EngineThread(eng_pkg.server.EngineServer(
                spec=spec_of(eng_pkg, d), http_port=0, grpc_port=0,
                enable_batching=False,
                metrics=eng_pkg.metrics.ServerMetrics()))
            try:
                got = [wire(grpc_predict(eng_pkg, et.grpc,
                                         request(eng_pkg, rows, puid, kind)))
                       for rows, puid, kind in GRAPH_REQS]
                status, raw = http_request(
                    et.http, "POST", "/api/v0.1/predictions",
                    {"data": {"ndarray": [[1.0, 2.0]]},
                     "meta": {"puid": "x-1"}}, timeout=TIMEOUT)
                assert status == 200, raw
                got.append(json.loads(raw))
            finally:
                et.close()
            answers[(eng_pkg.name, unit_pkg)] = got
    want = answers[("jax", "jax")]
    for key, got in answers.items():
        assert got == want, key
    assert want[-1]["data"]["ndarray"] == [[2.0, 4.0]]
