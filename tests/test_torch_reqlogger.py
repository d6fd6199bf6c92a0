"""The port's request logger (seldon_tpu_torch/orchestrator/reqlogger.py)
against the JAX package's: the CloudEvents each one posts for the same
request and response pairs (one pair, then a batched pair carrying a
``batch_index`` tag), the documents each one's sink flattens them into,
and an engine server of each package logging a prediction to its sink.
Every socket binds port 0 and every wait is bounded."""

import asyncio
import json
import threading
import time

import numpy as np
import pytest
from aiohttp import web

from seldon_tpu.core import payloads as jpay
from seldon_tpu.orchestrator import reqlogger as jrl
from seldon_tpu.orchestrator import server as jsrv
from seldon_tpu.orchestrator import spec as jspec
from seldon_tpu.proto import prediction_pb2 as jpb
from seldon_tpu.runtime import metrics_server as jmet
from seldon_tpu_torch.core import payloads as tpay
from seldon_tpu_torch.orchestrator import reqlogger as trl
from seldon_tpu_torch.orchestrator import server as tsrv
from seldon_tpu_torch.orchestrator import spec as tspec
from seldon_tpu_torch.proto import prediction_pb2 as tpb
from seldon_tpu_torch.runtime import metrics_server as tmet
from tests.torch_port_helpers import EngineThread, http_request

PKGS = {"jax": (jrl, jpay, jpb), "torch": (trl, tpay, tpb)}
# Headers that name the moment or the connection, not the event.
VOLATILE = {"ce-time", "host", "date", "user-agent", "accept",
            "accept-encoding"}


def test_wire_constants_equal():
    for name in ("ENV_SINK", "ENV_LOG_REQUESTS", "ENV_LOG_RESPONSES",
                 "CE_TYPE_REQUEST", "CE_TYPE_RESPONSE"):
        assert getattr(trl, name) == getattr(jrl, name), name


BODIES = {
    "ndarray_names": {"data": {"names": ["a", "b"],
                               "ndarray": [[1, 2], [3, 4]]}},
    "ndarray_no_names": {"data": {"ndarray": [[1, 2, 3]]}},
    "tensor_2d": {"data": {"tensor": {"shape": [2, 2],
                                      "values": [1, 2, 3, 4]}}},
    "tensor_1d": {"data": {"tensor": {"shape": [3], "values": [1, 2, 3]}}},
    "dense": {"data": {"dense": {"dtype": "DT_BFLOAT16", "shape": [4, 2],
                                 "data": "AAAA"}}},
    "str_data": {"strData": "hello", "meta": {"puid": "x"}},
    "json_data": {"jsonData": {"k": [1, 2]}},
}


@pytest.mark.parametrize("ce_type", [jrl.CE_TYPE_REQUEST,
                                     jrl.CE_TYPE_RESPONSE])
@pytest.mark.parametrize("case", sorted(BODIES))
def test_flatten_equal(case, ce_type):
    headers = {"Ce-Deploymentname": "dep", "Ce-Predictorname": "pred"}
    want = jrl._flatten(json.loads(json.dumps(BODIES[case])), ce_type, "p1",
                        headers)
    got = trl._flatten(json.loads(json.dumps(BODIES[case])), ce_type, "p1",
                       headers)
    assert got == want


def _pairs(pay, pb, batched):
    """[(request, response, puid)]: one pair, or a pair of a fused batch."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((3 if batched else 1, 2)).astype(np.float32)
    y = rng.standard_normal((3 if batched else 1, 1)).astype(np.float32)
    req = pay.build_message(x, names=["x", "y"], kind="ndarray")
    resp = pay.build_message(y, names=["p"], kind="ndarray")
    resp.meta.puid = req.meta.puid = "puid-1"
    if batched:
        bi = pb.BatchIndex(puids=["a", "b"], row_counts=[1, 2])
        req.meta.tags["batch_index"].string_value = (
            bi.SerializeToString().hex())
        resp.meta.tags["batch_index"].string_value = (
            bi.SerializeToString().hex())
        return [(req, resp, "puid-1"),
                (pay.build_message(x[:1], kind="tensor"),
                 pay.build_message(y[:1], kind="dense"), "puid-2")]
    return [(req, resp, "puid-1")]


async def _serve(app):
    runner = web.AppRunner(app)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    return runner, site._server.sockets[0].getsockname()[1]


def _ship(pkg, batched):
    """The events ``pkg``'s RequestLogger posts for the pairs: (headers
    without the volatile ones, JSON body) per event, in order, and the
    docs the package's own sink flattens the same events into."""
    rl_mod, pay, pb = PKGS[pkg]

    async def go():
        seen = []

        async def capture(request):
            seen.append(({k.lower(): v for k, v in request.headers.items()
                          if k.lower() not in VOLATILE},
                         await request.json()))
            return web.json_response({"ok": True})

        app = web.Application()
        app.router.add_post("/", capture)
        cap_runner, cap_port = await _serve(app)
        docs = []
        sink_runner, sink_port = await _serve(rl_mod.build_sink_app(
            store=docs))
        pairs = _pairs(pay, pb, batched)
        loggers = [rl_mod.RequestLogger(sink_url=f"http://127.0.0.1:{port}/",
                                        deployment="dep", predictor="pred")
                   for port in (cap_port, sink_port)]
        try:
            for rl in loggers:
                for req, resp, puid in pairs:
                    rl.log_pair(req, resp, puid)
            for _ in range(500):
                if all(rl.sent >= 2 * len(pairs) for rl in loggers):
                    break
                await asyncio.sleep(0.01)
            assert [(rl.sent, rl.dropped) for rl in loggers] == [
                (2 * len(pairs), 0)] * 2
            status, dump = await asyncio.get_running_loop().run_in_executor(
                None, lambda: http_request(sink_port, "GET", "/dump",
                                           timeout=10))
            assert status == 200 and json.loads(dump) == docs
        finally:
            for rl in loggers:
                await rl.close()
            await cap_runner.cleanup()
            await sink_runner.cleanup()
        return seen, docs

    return asyncio.run(go())


@pytest.mark.parametrize("batched", [False, True])
def test_cloudevents_and_sink_docs_equal(batched):
    (jseen, jdocs), (tseen, tdocs) = _ship("jax", batched), _ship("torch",
                                                                  batched)
    assert tseen == jseen
    assert tdocs == jdocs
    ids = [h["ce-id"] for h, _ in tseen]
    assert ids[:2] == ["puid-1-request", "puid-1-response"]
    assert all(h["ce-source"] == "seldon-tpu-engine" for h, _ in tseen)
    rows = [d for d in tdocs if d["kind"] == "request"
            and d["request_id"] == "puid-1"]
    assert [d["batch_index"] for d in rows] == list(range(3 if batched
                                                          else 1))
    if batched:
        assert (tseen[0][1]["meta"]["tags"]["batch_index"]
                == jseen[0][1]["meta"]["tags"]["batch_index"])


def test_disabled_logger_is_free():
    rl = trl.RequestLogger(sink_url="", log_requests=False,
                           log_responses=False)
    assert not rl.enabled
    # No loop running; it must not touch asyncio at all.
    rl.log_pair(tpay.build_message(np.zeros((1, 1))),
                tpay.build_message(np.zeros((1, 1))), "p")
    assert rl.sent == 0 and rl._queue is None


def test_unreachable_sink_drops_not_blocks():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        dead = s.getsockname()[1]

    async def go():
        rl = trl.RequestLogger(sink_url=f"http://127.0.0.1:{dead}/",
                               max_queue=4)
        msg = tpay.build_message(np.zeros((1, 1), np.float32))
        t0 = time.perf_counter()
        for i in range(10):
            rl.log_pair(msg, msg, f"p{i}")
        hot_path_s = time.perf_counter() - t0
        await asyncio.sleep(0.3)
        await rl.close()
        return hot_path_s, rl

    hot_path_s, rl = asyncio.run(go())
    assert hot_path_s < 0.2  # enqueue only; never awaits the sink
    assert rl.sent == 0
    assert rl.dropped >= 6  # 20 events, a queue of 4


def test_stdout_raw_logging_equal(capsys):
    outs = []
    for rl_mod, pay, _ in PKGS.values():
        async def go():
            rl = rl_mod.RequestLogger(sink_url="", log_requests=True,
                                      log_responses=True)
            msg = pay.build_message(np.ones((1, 1), np.float32),
                                    kind="ndarray")
            rl.log_pair(msg, msg, "p")
            await rl.close()

        asyncio.run(go())
        outs.append(capsys.readouterr().out)
    assert outs[1] == outs[0]
    assert outs[1].count("Request: ") == 1
    assert outs[1].count("Response: ") == 1


def test_engine_server_logs_predictions_to_sink(monkeypatch):
    """Each package's engine server, with the sink env set, logs one
    prediction's pair; the flattened docs are equal."""
    docs = {}
    for name, srv_mod, spec_mod, met_mod in (
            ("jax", jsrv, jspec, jmet), ("torch", tsrv, tspec, tmet)):
        rl_mod = PKGS[name][0]
        store = []
        holder = {}

        async def sink_main(stop):
            runner, holder["port"] = await _serve(rl_mod.build_sink_app(
                store=store))
            holder["ready"].set()
            while not stop.is_set():
                await asyncio.sleep(0.02)
            await runner.cleanup()

        stop, holder["ready"] = threading.Event(), threading.Event()
        t = threading.Thread(target=lambda: asyncio.run(sink_main(stop)),
                             daemon=True)
        t.start()
        assert holder["ready"].wait(30)
        monkeypatch.setenv(rl_mod.ENV_SINK,
                           f"http://127.0.0.1:{holder['port']}/")
        spec = spec_mod.PredictorSpec.from_dict(
            {"name": "pred", "graph": {"name": "m",
                                       "implementation": "SIMPLE_MODEL"}})
        spec_mod.default_unit_types(spec.graph)
        et = EngineThread(srv_mod.EngineServer(
            spec=spec, http_port=0, grpc_port=0,
            metrics=met_mod.ServerMetrics()))
        try:
            status, raw = http_request(
                et.http, "POST", "/api/v0.1/predictions",
                {"data": {"names": ["f"], "ndarray": [[1.0], [2.0]]},
                 "meta": {"puid": "eng-1"}}, timeout=30)
            assert status == 200, raw
            for _ in range(500):
                if len(store) >= 3:  # 2 request rows, 1 response row
                    break
                time.sleep(0.01)
        finally:
            et.close()
            stop.set()
            t.join(timeout=30)
            assert not t.is_alive()
        docs[name] = sorted(store, key=lambda d: json.dumps(d, sort_keys=True))
    assert docs["torch"] == docs["jax"]
    assert {d["kind"] for d in docs["torch"]} == {"request", "response"}
    assert all(d["request_id"] == "eng-1" and d["predictor"] == "pred"
               for d in docs["torch"])
