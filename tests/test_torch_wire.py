"""TorchServer over the wire against JAXServer over the wire.

A tiny JAXServer (ragged, its masked leg) and a tiny TorchServer on the
CPU (ragged, the kernel leg's plain version) share one set of weights:
the JAX server's, through the port's convert, assigned before load().
Each sits behind its own package's REST and gRPC servers on real
sockets. Greedy tokens over REST /generate, NDJSON /generate_stream and
gRPC Generate / GenerateStream must be equal, or part only at a near-tie
of the reference (reported). Also: the JAX package's gRPC stub served by
the port, a mid-stream disconnect cancelling its engine request, a
traceparent header reaching the engine's span, drain flipping /ready,
the lifecycle status mapping, the metric keys, and the port's
microservice CLI in a subprocess."""

import contextlib
import dataclasses
import http.client
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from seldon_tpu.proto import prediction_grpc as jgrpc
from seldon_tpu.proto import prediction_pb2 as jpb
from seldon_tpu.runtime import wrapper as jwrap
from seldon_tpu.servers.jaxserver import JAXServer
from seldon_tpu_torch.core import tracing as ttr
from seldon_tpu_torch.models import convert
from seldon_tpu_torch.models.config import ModelConfig as TModelConfig
from seldon_tpu_torch.proto import prediction_grpc as tgrpc
from seldon_tpu_torch.proto import prediction_pb2 as tpb
from seldon_tpu_torch.runtime import fastpath as tfast
from seldon_tpu_torch.runtime import wrapper as twrap
from seldon_tpu_torch.servers.torchserver import TorchServer
from tests.torch_port_helpers import (RestServers, _copying,
                                      assert_streams_match, grpc_server,
                                      http_request, ndjson_stream)

ROOT = pathlib.Path(__file__).resolve().parents[1]
KNOBS = dict(preset="tiny", max_slots=4, max_seq_len=128, prefill_chunk=16,
             ragged=1)
NEW = 8
PROMPTS = [[5, 17, 99, 3, 250, 41, 7], list(b"hello wire"),
           list(range(30, 60))]


def _copy_weights(jsrv, tsrv):
    """The JAX server's weights and config into the port's server, before
    its load() (which then keeps them)."""
    tree = jax.tree.map(np.asarray, jsrv.params)
    tsrv.cfg = TModelConfig(**dataclasses.asdict(jsrv.cfg))
    tsrv.params = convert.params_from_numpy(tree, tsrv.cfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    with pytest.MonkeyPatch.context() as mp:
        # ROADMAP.md C3: on the CPU the JAX engine's `jnp.asarray` may
        # alias its live host block table; a copying asarray changes no
        # value.
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        jsrv = JAXServer(**KNOBS)
        jsrv.load()
        tsrv = TorchServer(ragged_kernel="pallas", device="cpu", **KNOBS)
        _copy_weights(jsrv, tsrv)
        tsrv.load()
        rest = RestServers(jwrap.build_rest_app(jsrv),
                           twrap.build_rest_app(tsrv))
        jg, jgport = grpc_server(jwrap, jsrv)
        tg, tgport = grpc_server(twrap, tsrv)
        try:
            yield dict(jsrv=jsrv, tsrv=tsrv, rest=rest.ports,
                       grpc=(jgport, tgport))
        finally:
            jg.stop(grace=1)
            tg.stop(grace=1)
            rest.close()
            jsrv.engine.stop()
            tsrv.stop()


def _body(ids, n=NEW):
    return {"prompt_token_ids": ids, "max_new_tokens": n,
            "temperature": 0.0}


def _rest_generate(port, ids):
    status, raw = http_request(port, "POST", "/generate", _body(ids))
    assert status == 200, raw
    return json.loads(raw)["token_ids"]


def _rest_stream(port, ids):
    status, lines = ndjson_stream(port, _body(ids))
    assert status == 200, lines
    assert all("error" not in line for line in lines), lines
    return [t for line in lines for t in line["token_ids"]]


def _grpc_request(pb, ids):
    return pb.GenerateRequest(prompt_token_ids=ids, max_new_tokens=NEW,
                              temperature=0.0)


def _grpc_generate(port, ids, grpc_mod=tgrpc, pb=tpb):
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        out = grpc_mod.TextGenStub(ch).Generate(_grpc_request(pb, ids),
                                                timeout=120)
    return list(out.token_ids)


def _grpc_stream(port, ids):
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        chunks = list(tgrpc.TextGenStub(ch).GenerateStream(
            _grpc_request(tpb, ids), timeout=120))
    return [t for c in chunks for t in c.token_ids]


ROUTES = {
    "rest-generate": (_rest_generate, "rest"),
    "ndjson-stream": (_rest_stream, "rest"),
    "grpc-generate": (_grpc_generate, "grpc"),
    "grpc-stream": (_grpc_stream, "grpc"),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_route_returns_the_jax_servers_tokens(pair, route):
    fn, kind = ROUTES[route]
    jport, tport = pair[kind]
    want = [fn(jport, ids) for ids in PROMPTS]
    got = [fn(tport, ids) for ids in PROMPTS]
    assert all(1 <= len(w) <= NEW for w in want), want
    assert_streams_match(got, want, pair["jsrv"].params, pair["jsrv"].cfg,
                         PROMPTS, route)
    # One request at a time: the port's wire answer is its in-process one.
    inproc = [pair["tsrv"].generate(_body(ids))["token_ids"]
              for ids in PROMPTS]
    assert got == inproc


def test_jax_stub_is_served_by_the_port(pair):
    """The JAX package's own TextGenStub and messages, unchanged, against
    the port's gRPC server."""
    _, tport = pair["grpc"]
    got = [_grpc_generate(tport, ids, jgrpc, jpb) for ids in PROMPTS]
    assert got == [_grpc_generate(tport, ids) for ids in PROMPTS]


def test_fast_lane_scores_as_in_process(pair):
    tsrv = pair["tsrv"]
    server, port = tfast.start_fast_server(tsrv, "127.0.0.1", 0)
    client = tfast.FastClient(timeout_s=60)
    try:
        from seldon_tpu_torch.core import payloads

        toks = np.asarray([PROMPTS[0], PROMPTS[0][::-1]], np.int32)
        out = client.call("127.0.0.1", port, "predict",
                          payloads.build_message(toks))
        got = payloads.get_data_from_message(out)
    finally:
        client.close()
        server.shutdown()
        server.server_close()
    np.testing.assert_array_equal(got, tsrv.predict(toks, names=[]))


def _wait_for(cond, timeout=30.0):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


def test_hard_close_mid_stream_cancels_the_request(pair):
    tsrv, (_, tport) = pair["tsrv"], pair["rest"]
    eng = tsrv.engine
    before = eng.stats.snapshot()["cancelled_total"]
    conn = http.client.HTTPConnection("127.0.0.1", tport, timeout=120)
    conn.request("POST", "/generate_stream",
                 body=json.dumps(_body([5, 6, 7, 8], n=112)),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    assert resp.status == 200
    first = json.loads(resp.readline())
    assert first["token_ids"]
    # Hard close: the client is gone after its first chunk.
    conn.sock.shutdown(socket.SHUT_RDWR)
    conn.close()
    assert _wait_for(lambda: eng.stats.snapshot()["cancelled_total"]
                     == before + 1), eng.stats.snapshot()
    assert _wait_for(lambda: eng.debug_lifecycle_check() == {}), \
        eng.debug_lifecycle_check()


def test_traceparent_header_reaches_the_engine_span(pair):
    tsrv, (_, tport) = pair["tsrv"], pair["rest"]
    exp = ttr.InMemoryExporter()
    saved = tsrv.engine._tracer
    tsrv.engine._tracer = ttr.get_tracer("engine", exporter=exp)
    tp = "00-" + "ef" * 16 + "-" + "01" * 8 + "-01"
    try:
        for path in ("/generate", "/generate_stream"):
            status, _ = http_request(tport, "POST", path, _body([9, 8, 7], 3),
                                     headers={"traceparent": tp})
            assert status == 200
        assert _wait_for(lambda: len(
            [s for s in exp.spans if s.name == "engine.request"]) == 2)
    finally:
        tsrv.engine._tracer = saved
    roots = [s for s in exp.spans if s.name == "engine.request"]
    for root in roots:
        assert (root.trace_id, root.parent_id) == ("ef" * 16, "01" * 8)
        assert root.attributes["outcome"] == "ok"
        kids = {s.name for s in exp.spans if s.parent_id == root.span_id}
        assert kids == {"engine.queued", "engine.prefill", "engine.decode"}


@pytest.mark.parametrize("call", ["generate", "generate_stream"])
def test_engine_spans_adopt_the_servers_span(pair, call):
    """Without a traceparent, the engine's lifecycle root is a child of
    the server's own span, as in the JAX server."""
    tsrv = pair["tsrv"]
    exp = ttr.InMemoryExporter()
    saved = tsrv._tracer, tsrv.engine._tracer
    tsrv._tracer = ttr.get_tracer("torchserver", exporter=exp)
    tsrv.engine._tracer = ttr.get_tracer("engine", exporter=exp)
    try:
        out = getattr(tsrv, call)(_body([4, 5, 6], 3))
        if call == "generate_stream":
            out = [c for c in out if c is not None]
        assert out
        assert _wait_for(lambda: any(s.name == "engine.request"
                                     for s in exp.spans))
    finally:
        tsrv._tracer, tsrv.engine._tracer = saved
    (server,) = [s for s in exp.spans if s.name == f"torchserver.{call}"]
    (root,) = [s for s in exp.spans if s.name == "engine.request"]
    assert server.attributes["prompt_tokens"] == 3
    assert (root.trace_id, root.parent_id) == (server.trace_id,
                                               server.span_id)


def test_metric_keys_are_the_jax_servers(pair):
    jsrv, tsrv = pair["jsrv"], pair["tsrv"]
    jkeys = [m["key"] for m in jsrv.metrics()]
    observatory = {m["key"] for m in jsrv._observatory_metrics(
        jsrv.engine.stats.snapshot())}
    tkeys = [m["key"] for m in tsrv.metrics()]
    assert tkeys == [k.replace("jaxserver_", "torchserver_")
                     for k in jkeys if k not in observatory]
    jtags = [m.get("tags") for m in jsrv.metrics()
             if m["key"] not in observatory]
    assert [m.get("tags") for m in tsrv.metrics()] == jtags
    # The REST server absorbs them after a generate; /metrics shows them.
    _, tport = pair["rest"]
    _rest_generate(tport, PROMPTS[0])
    status, text = http_request(tport, "GET", "/metrics")
    assert status == 200
    for name in (b"torchserver_itl_p50_ms", b"torchserver_goodput",
                 b'torchserver_deadline_margin_ms_bucket{le="+Inf"}'):
        assert name in text, name
    snap = tsrv.engine.stats.snapshot()
    assert snap["itl_count"] > 0 and snap["budget_utilization"] > 0
    assert snap["completed_no_deadline_total"] > 0


def test_deadline_feeds_the_slo_histogram(pair):
    tsrv, (_, tport) = pair["tsrv"], pair["rest"]
    before = tsrv.engine.stats.snapshot()
    body = dict(_body(PROMPTS[1], 3), meta={"tags": {"deadline_ms": 60000}})
    status, _ = http_request(tport, "POST", "/generate", body)
    assert status == 200
    snap = tsrv.engine.stats.snapshot()
    assert snap["deadline_met_total"] == before["deadline_met_total"] + 1
    assert sum(snap["deadline_margin_counts"]) == \
        sum(before["deadline_margin_counts"]) + 1
    status, raw = http_request(
        tport, "POST", "/generate",
        dict(_body(PROMPTS[1], 3), meta={"tags": {"deadline_ms": 1}}))
    if status == 504:  # expired in the queue or mid-decode
        assert json.loads(raw)["status"]["info"].startswith(
            "generation failed")
    else:  # finished within 1 ms: a normal answer
        assert status == 200, raw


def test_drain_flips_readiness():
    tsrv = TorchServer(ragged_kernel="pallas", device="cpu",
                       **dict(KNOBS, max_slots=2, max_seq_len=64))
    tsrv.load()
    rest = RestServers(twrap.build_rest_app(tsrv))
    (port,) = rest.ports
    try:
        assert http_request(port, "GET", "/ready")[0] == 200
        meta = json.loads(http_request(port, "GET", "/metadata")[1])
        assert meta["name"] == "torchserver" and meta["device"] == "cpu"
        assert tsrv.drain(timeout=10) is True
        status, raw = http_request(port, "GET", "/ready")
        assert status == 503 and b"draining" in raw
        status, raw = http_request(port, "POST", "/generate", _body([3, 4]))
        assert status == 503
        assert json.loads(raw)["status"]["retriable"] is True
    finally:
        rest.close()
        tsrv.stop()


class _Shedding:
    def __init__(self, status):
        self._status = status

    def _err(self):
        e = RuntimeError("no capacity")
        e.http_status = self._status
        e.retriable = True
        return e

    def generate(self, req):
        raise self._err()

    def generate_stream(self, req):
        raise self._err()
        yield  # pragma: no cover


GRPC_CODES = {429: grpc.StatusCode.RESOURCE_EXHAUSTED,
              503: grpc.StatusCode.UNAVAILABLE}


@pytest.mark.parametrize("status", [429, 503])
def test_lifecycle_errors_map_as_jax(status):
    """Typed lifecycle errors surface as the JAX wrapper's HTTP statuses
    and gRPC codes, before any stream bytes."""
    rest = RestServers(twrap.build_rest_app(_Shedding(status)),
                       jwrap.build_rest_app(_Shedding(status)))
    gsrv, gport = grpc_server(twrap, _Shedding(status))
    try:
        answers = []
        for port in rest.ports:
            for path in ("/generate", "/generate_stream"):
                code, raw = http_request(port, "POST", path, {"prompt": "x"})
                answers.append((code, json.loads(raw)))
        assert answers[:2] == answers[2:]
        for code, body in answers:
            assert code == status
            assert body["status"]["retriable"] is True
        with grpc.insecure_channel(f"127.0.0.1:{gport}") as ch:
            stub = tgrpc.TextGenStub(ch)
            for call in (lambda r: stub.Generate(r, timeout=30),
                         lambda r: list(stub.GenerateStream(r, timeout=30))):
                with pytest.raises(grpc.RpcError) as err:
                    call(tpb.GenerateRequest(prompt="x"))
                assert err.value.code() == GRPC_CODES[status]
    finally:
        gsrv.stop(grace=1)
        rest.close()


def _free_port():
    with contextlib.closing(socket.socket()) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_serves_torchserver_over_rest():
    """The port's microservice CLI in a subprocess, with the device given
    as a unit parameter; its greedy tokens are an in-process
    TorchServer's on the same knobs (the same seeded weights)."""
    params = dict(preset="tiny", max_slots=2, max_seq_len=64,
                  prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                  device="cpu")
    types = {int: "INT", str: "STRING"}
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(ROOT), SELDON_TPU_FASTPATH="0",
               PREDICTIVE_UNIT_PARAMETERS=json.dumps(
                   [{"name": k, "value": str(v), "type": types[type(v)]}
                    for k, v in params.items()]))
    proc = subprocess.Popen(
        [sys.executable, "-m", "seldon_tpu_torch.runtime.microservice",
         "seldon_tpu_torch.servers.torchserver.TorchServer",
         "--api-type", "REST", "--http-port", str(port),
         "--host", "127.0.0.1", "--log-level", "WARNING"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        def up():
            assert proc.poll() is None, proc.stdout.read().decode()
            try:
                return http_request(port, "GET", "/ready", timeout=5)[0] \
                    == 200
            except OSError:
                return False

        assert _wait_for(up, timeout=60), "CLI never became ready"
        body = {"prompt": "cli", "max_new_tokens": 5, "temperature": 0.0}
        status, raw = http_request(port, "POST", "/generate", body)
        assert status == 200, raw
        local = TorchServer(**params)
        try:
            want = local.generate(body)["token_ids"]
        finally:
            local.stop()
        assert json.loads(raw)["token_ids"] == want
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=10)
