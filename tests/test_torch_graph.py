"""Inference graphs in front of LLM units: the port's engine server over a
tiny TorchServer against the JAX package's engine server over a tiny
JAXServer, on shared weights.

The two servers score with the same weights (``params_pair``). Each sits
behind its own package's unit servers (gRPC, REST, the fast lane) and its
own package's ``EngineServer``, in the graph shapes chip_smoke's ``graph``
phase drives on the card: g1 a solo MODEL over gRPC with the fast lane on
the sync lane, g2 a solo MODEL over REST (proto, then JSON) on the asyncio
lane, g3 ``RANDOM_ABTEST`` and g4 ``AVERAGE_COMBINER`` over the same unit
reached over gRPC and over REST, g5 g1's graph with the micro-batcher on.
Held: NLLs within ``NLL_ATOL`` between the packages, equal
``requestPath`` and ``routing``; inside the port, graph answers bit-equal
to ``TorchServer.predict`` on the same rows, and the fused answer to the
matching row of ``predict`` on the fused array."""

import dataclasses
import json
from types import SimpleNamespace

import grpc
import numpy as np
import pytest

from seldon_tpu.core import payloads as jpay
from seldon_tpu.orchestrator import server as jsrv
from seldon_tpu.orchestrator import spec as jspec
from seldon_tpu.proto import prediction_grpc as jgrpc
from seldon_tpu.runtime import fastpath as jfast
from seldon_tpu.runtime import metrics_server as jmet
from seldon_tpu.runtime import wrapper as jwrap
from seldon_tpu.servers.jaxserver import JAXServer
from seldon_tpu_torch.core import payloads as tpay
from seldon_tpu_torch.models.config import ModelConfig as TModelConfig
from seldon_tpu_torch.orchestrator import server as tsrv
from seldon_tpu_torch.orchestrator import spec as tspec
from seldon_tpu_torch.proto import prediction_grpc as tgrpc
from seldon_tpu_torch.proto import prediction_pb2 as tpb
from seldon_tpu_torch.runtime import fastpath as tfast
from seldon_tpu_torch.runtime import metrics_server as tmet
from seldon_tpu_torch.runtime import wrapper as twrap
from seldon_tpu_torch.servers.torchserver import TorchServer
from tests.test_torch_forward import NLL_ATOL
from tests.torch_port_helpers import (EngineThread, RestServers, grpc_server,
                                      http_request, params_pair)

TIMEOUT = 60
S = 24  # tokens per row
ROWS = np.random.default_rng(7).integers(3, 250, (2, S))

J = SimpleNamespace(name="jax", server=jsrv, spec=jspec, payloads=jpay,
                    grpc=jgrpc, metrics=jmet, wrapper=jwrap, fast=jfast)
T = SimpleNamespace(name="torch", server=tsrv, spec=tspec, payloads=tpay,
                    grpc=tgrpc, metrics=tmet, wrapper=twrap, fast=tfast)


class Recording:
    """A unit that records each ``predict`` call (the rows, the request's
    ``batch_index`` tag, the answer) and delegates everything to the
    server it wraps."""

    def __init__(self, srv):
        self.srv = srv
        self.calls = []

    def predict(self, X, names, meta=None):
        out = self.srv.predict(X, names, meta)
        tags = (meta or {}).get("tags", {})
        self.calls.append((np.array(X), tags.get("batch_index"), out))
        return out

    def __getattr__(self, name):
        return getattr(self.srv, name)


@pytest.fixture(scope="module")
def units():
    """Per package: its tiny server on shared weights behind its own
    package's gRPC, REST and fast-lane servers."""
    jserver = JAXServer(preset="tiny", max_slots=2, max_seq_len=64)
    jserver.load()
    jserver.engine.stop()
    jp, tp = params_pair(jserver.cfg, seed=21)
    jserver.params = jp
    tserver = TorchServer(preset="tiny", device="cpu")
    tserver.cfg = TModelConfig(**dataclasses.asdict(jserver.cfg))
    tserver.params = tp
    out, closers = {}, []
    try:
        for pkg, srv in ((J, jserver), (T, tserver)):
            unit = Recording(srv)
            g, gport = grpc_server(pkg.wrapper, unit)
            closers.append(lambda g=g: g.stop(grace=0.5))
            rest = RestServers(pkg.wrapper.build_rest_app(unit))
            closers.append(rest.close)
            fast, fport = pkg.fast.start_fast_server(unit, "127.0.0.1", 0)
            closers.append(lambda f=fast: (f.shutdown(), f.server_close()))
            out[pkg.name] = SimpleNamespace(srv=srv, unit=unit, grpc=gport,
                                            rest=rest.ports[0], fast=fport)
        yield out
    finally:
        for close in reversed(closers):
            close()


def ep(port, type_="GRPC", **kw):
    return {"service_host": "127.0.0.1", "service_port": port, "type": type_,
            **kw}


def graphs(u):
    """g1-g5 over one package's units ``u``."""
    solo_grpc = {"name": "llm", "type": "MODEL", "image": "llm:1",
                 "endpoint": ep(u.grpc, fast_port=u.fast)}
    by_grpc = {"name": "via-grpc", "type": "MODEL",
               "endpoint": ep(u.grpc)}
    by_rest = {"name": "via-rest", "type": "MODEL",
               "endpoint": ep(u.rest, "REST")}
    return {
        "g1": ({"name": "g1", "graph": solo_grpc}, False),
        "g2_proto": ({"name": "g2", "graph": dict(
            by_rest, name="llm")}, False),
        "g2_json": ({"name": "g2", "graph": dict(
            by_rest, name="llm", endpoint=ep(u.rest, "REST",
                                              content="json"))}, False),
        "g3": ({"name": "g3", "graph": {
            "name": "ab", "implementation": "RANDOM_ABTEST",
            "children": [by_grpc, by_rest]}}, False),
        "g4": ({"name": "g4", "graph": {
            "name": "mean", "implementation": "AVERAGE_COMBINER",
            "children": [by_grpc, by_rest]}}, False),
        "g5": ({"name": "g5", "graph": solo_grpc}, True),
    }


def engine(pkg, u, graph, window_s=None):
    d, batching = graphs(u)[graph]
    spec = pkg.spec.PredictorSpec.from_dict(json.loads(json.dumps(d)))
    pkg.spec.default_unit_types(spec.graph)
    es = pkg.server.EngineServer(
        spec=spec, http_port=0, grpc_port=0, enable_batching=batching,
        metrics=pkg.metrics.ServerMetrics())
    if window_s is not None:
        es.batcher.window_s = window_s
    return EngineThread(es)


def ask(pkg, et, rows, puid, transport):
    """(NLLs, requestPath, routing) of one prediction through the engine."""
    if transport == "grpc":
        msg = pkg.payloads.build_message(np.asarray(rows, np.float64))
        msg.meta.puid = puid
        with grpc.insecure_channel(f"127.0.0.1:{et.grpc}") as ch:
            out = pkg.grpc.SeldonStub(ch).Predict(msg, timeout=TIMEOUT)
        return (pkg.payloads.get_data_from_message(out),
                dict(out.meta.requestPath), dict(out.meta.routing))
    status, raw = http_request(
        et.http, "POST", "/api/v0.1/predictions",
        {"data": {"ndarray": np.asarray(rows).tolist()},
         "meta": {"puid": puid}}, timeout=TIMEOUT)
    assert status == 200, raw
    body = json.loads(raw)
    return (np.asarray(body["data"]["ndarray"], np.float32),
            body["meta"]["requestPath"], body["meta"].get("routing", {}))


PUIDS = ["graph-0", "graph-1", "graph-2", "graph-3"]


@pytest.mark.parametrize("transport", ["grpc", "rest"])
@pytest.mark.parametrize("graph", ["g1", "g2_proto", "g2_json", "g3", "g4"])
def test_graph_answers(units, graph, transport):
    answers = {}
    for pkg in (J, T):
        et = engine(pkg, units[pkg.name], graph)
        try:
            if graph == "g1":
                assert type(et.es._grpc_server).__name__ == "_Server"
            else:
                assert type(et.es._grpc_server).__name__ == "Server"
            answers[pkg.name] = [ask(pkg, et, ROWS[i % 2: i % 2 + 1 + i // 2],
                                     puid, transport)
                                 for i, puid in enumerate(PUIDS)]
        finally:
            et.close()
    tsrv_ = units["torch"].srv
    for i, ((jn, jpath, jroute), (tn, tpath, troute)) in enumerate(
            zip(answers["jax"], answers["torch"])):
        rows = ROWS[i % 2: i % 2 + 1 + i // 2]
        assert tpath == jpath and troute == jroute, (i, tpath, jpath)
        np.testing.assert_allclose(tn, jn, rtol=0, atol=NLL_ATOL)
        # Inside the port: bit-equal to the unit's own predict.
        np.testing.assert_array_equal(
            np.asarray(tn, np.float32),
            tsrv_.predict(rows.astype(np.float64), names=[]))
    routes = [r for _, _, r in answers["torch"]]
    if graph == "g3":
        assert {r["ab"] for r in routes} <= {0, 1}
        for (_, path, r) in answers["torch"]:
            assert ("via-grpc" if r["ab"] == 0 else "via-rest") in path
    if graph == "g4":
        assert all(set(p) == {"mean", "via-grpc", "via-rest"}
                   for _, p, _ in answers["torch"])


def test_graph_microbatcher_fuses_llm_rows(units):
    """g5: 8 concurrent requests carrying the same row fuse. Each answer
    of a fused call equals its row of ``predict`` on that call's fused
    array, bit for bit, and the solo answer to rtol 1e-6 (B 1 and B k rows
    agree only that far on the CPU)."""
    row = ROWS[:1]
    for pkg in (J, T):
        u = units[pkg.name]
        u.unit.calls.clear()
        # A window wide enough that all 8 requests land in it on a loaded
        # test host (the default is 2 ms).
        et = engine(pkg, u, "g5", window_s=0.25)
        try:
            with grpc.insecure_channel(f"127.0.0.1:{et.grpc}") as ch:
                stub = pkg.grpc.SeldonStub(ch)
                msgs = []
                for i in range(8):
                    msg = pkg.payloads.build_message(
                        np.asarray(row, np.float64))
                    msg.meta.puid = f"b{i}"
                    msgs.append(msg)
                futs = [stub.Predict.future(m, timeout=TIMEOUT) for m in msgs]
                got = {m.meta.puid: pkg.payloads.get_data_from_message(
                    f.result()) for m, f in zip(msgs, futs)}
            stats = dict(et.es.batcher.stats)
        finally:
            et.close()
        assert stats["fused_calls"] >= 1 and stats["batched_requests"] > 1
        fused = [(X, tpb.BatchIndex.FromString(bytes.fromhex(tag)))
                 for X, tag, _ in u.unit.calls if tag]
        assert len(fused) == stats["fused_calls"]
        assert sum(len(bi.puids) for _, bi in fused) == (
            stats["batched_requests"])
        if pkg is not T:
            continue
        solo = u.srv.predict(row.astype(np.float64), names=[])
        in_fused = set()
        for X, bi in fused:
            want = u.srv.predict(X, names=[])
            start = 0
            for puid, n in zip(bi.puids, bi.row_counts):
                np.testing.assert_array_equal(got[puid],
                                              want[start: start + n])
                start += n
                in_fused.add(puid)
        for puid, nll in got.items():
            if puid not in in_fused:
                np.testing.assert_array_equal(nll, solo)
            np.testing.assert_allclose(nll, solo, rtol=1e-6)


def test_graph_feedback_and_readiness(units):
    et = engine(T, units["torch"], "g3")
    try:
        assert http_request(et.http, "GET", "/ready",
                            timeout=TIMEOUT)[0] == 200
        body = {"reward": 1.0, "request": {"data": {"ndarray": ROWS[:1]
                                                     .tolist()}},
                "response": {"meta": {"puid": "fb", "routing": {"ab": 1}}}}
        status, raw = http_request(et.http, "POST", "/api/v0.1/feedback",
                                   body, timeout=TIMEOUT)
        assert status == 200, raw
        text = http_request(et.http, "GET", "/metrics", timeout=TIMEOUT)[1]
    finally:
        et.close()
    assert b"seldon_graph_ready 1.0" in text
    assert b'seldon_api_model_feedback_reward_total{unit="ab"} 1.0' in text
    assert (b'seldon_api_model_feedback_reward_total{unit="via-rest"} 1.0'
            in text)
