"""seldon_tpu_torch.loadtester against seldon_tpu.loadtester: the decode
length parser, the report and main's JSON keys, the request bodies and
the seeded cancel / deadline decisions of one client against a stub
server, a short generate run against a tiny TorchServer whose engine
counters must agree with the outcome ledger, and the /debug/* readers
against the port's server."""

import asyncio
import contextlib
import io
import json
import time
import urllib.request

import numpy as np
import pytest
from aiohttp import web

from seldon_tpu import loadtester as jlt
from seldon_tpu_torch import loadtester as tlt
from torch_port_helpers import RestServers
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("spec", ["", "uniform:8,256", "uniform:1,1",
                                  "normal:1,2", "uniform:3", "uniform:0,4",
                                  "uniform:5,4", "uniform:a,b"])
def test_parse_decode_len_dist_matches_jax(spec):
    try:
        want = jlt.parse_decode_len_dist(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tlt.parse_decode_len_dist(spec)
        assert str(got.value) == str(e)
        return
    assert tlt.parse_decode_len_dist(spec) == want


@pytest.mark.parametrize("lats,extra", [
    ([0.010, 0.020, 0.035, 0.5], None),
    ([], {"completion_tokens": 7, "outcomes": {"completed": 1}}),
])
def test_report_matches_jax(lats, extra, capsys):
    want = jlt.report("rest", len(lats), 2.0, lats, 1, 4, extra=extra)
    want_out = capsys.readouterr().out
    got = tlt.report("rest", len(lats), 2.0, lats, 1, 4, extra=extra)
    assert got == want
    assert capsys.readouterr().out == want_out


class _Stub:
    """A stub serving surface: NDJSON /generate_stream (three token lines
    a few ms apart), /generate, the predictions route and a gRPC Seldon
    Predict; it records every body it receives."""

    def __init__(self):
        self.bodies = []

        async def stream(request):
            self.bodies.append(await request.read())
            resp = web.StreamResponse(
                headers={"Content-Type": "application/x-ndjson"})
            await resp.prepare(request)
            try:
                for i in range(3):
                    line = {"token_ids": [i + 1], "completion_tokens": i + 1}
                    if i == 0:
                        line["ttft_ms"] = 1.0
                    await resp.write(json.dumps(line).encode() + b"\n")
                    await asyncio.sleep(0.003)
                await resp.write_eof()
            except ConnectionError:
                pass
            return resp

        async def unary(request):
            self.bodies.append(await request.read())
            return web.json_response({"completion_tokens": 3})

        async def predict(request):
            await request.read()
            return web.json_response({"data": {"ndarray": [[1.0]]}})

        app = web.Application()
        app.router.add_post("/generate_stream", stream)
        app.router.add_post("/generate", unary)
        app.router.add_post("/api/v0.1/predictions", predict)
        self.servers = RestServers(app)
        self.url = f"http://127.0.0.1:{self.servers.ports[0]}"

        import grpc
        from concurrent import futures

        from seldon_tpu_torch.proto import prediction_grpc
        from seldon_tpu_torch.proto import prediction_pb2 as pb

        class Seldon:
            def Predict(self, request, context):
                return pb.SeldonMessage(strData="ok")

        self.gserver = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        prediction_grpc.add_servicer(self.gserver, "Seldon", Seldon())
        self.grpc_port = self.gserver.add_insecure_port("127.0.0.1:0")
        self.gserver.start()

    def close(self):
        self.gserver.stop(0)
        self.servers.close()


@pytest.fixture(scope="module")
def stub():
    s = _Stub()
    yield s
    s.close()


def _strip_trace(body):
    d = json.loads(body)
    tags = d.get("meta", {}).get("tags", {})
    if "traceparent" in tags:
        tags["traceparent"] = "sampled"
    return d


def _one_client_run(mod, url, **kw):
    return asyncio.run(mod.run_generate(url, 1, 0.8, **kw))


@pytest.mark.parametrize("kw", [
    dict(cancel_frac=0.4, deadline_ms=250, deadline_frac=0.5,
         decode_len_dist="uniform:2,9"),
    dict(shared_prefix_frac=0.5, temperature=0.7, trace_sample=0.5),
    dict(stream=False, deadline_ms=100),
])
def test_one_client_bodies_and_decisions_match_jax(stub, kw):
    """One client: the i-th request's body (prompt, decode length,
    deadline tag, sampled traceparent) is the JAX tool's i-th body, and
    the cancels follow the seeded draws of default_rng(2)."""
    runs = {}
    for name, mod in (("jax", jlt), ("torch", tlt)):
        stub.bodies.clear()
        out = _one_client_run(mod, stub.url, **kw)
        runs[name] = (list(stub.bodies), out)
    (jb, jout), (tb, tout) = runs["jax"], runs["torch"]
    n = min(len(jb), len(tb))
    assert n >= 5, (len(jb), len(tb))
    assert [_strip_trace(b) for b in tb[:n]] == \
        [_strip_trace(b) for b in jb[:n]]
    for body in tb[:n]:
        tags = json.loads(body).get("meta", {}).get("tags", {})
        if "traceparent" in tags:
            assert tags["traceparent"].startswith("00-")
    total, dt, lats, errors, toks, stats, outcomes = tout
    assert sum(outcomes.values()) == total + errors
    assert outcomes["error"] == 0
    assert set(stats) == set(jout[5])
    if kw.get("cancel_frac"):
        # Every stream of the stub completes unless the client cancels
        # it, so the cancels are exactly the seeded draws.
        draws = np.random.default_rng(2).random(len(tb))
        assert outcomes["cancelled"] == int(
            np.sum(draws < kw["cancel_frac"])) >= 1


def _main_json(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    return type(d).__name__


@pytest.mark.parametrize("transport", ["generate", "rest", "grpc"])
def test_main_json_keys_match_jax(stub, transport):
    argv = [stub.url, "--clients", "2", "--seconds", "0.3",
            "--transport", transport]
    if transport == "generate":
        argv += ["--cancel-frac", "0.3", "--deadline-ms", "200",
                 "--decode-len-dist", "uniform:2,4",
                 "--shared-prefix-frac", "0.5"]
    if transport == "grpc":
        argv += ["--grpc-host", f"127.0.0.1:{stub.grpc_port}"]
    want = _main_json(jlt, argv)
    got = _main_json(tlt, argv)
    assert _key_tree(got) == _key_tree(want)
    assert got["metric"] == want["metric"] == \
        f"loadtest_{transport}_req_per_s"
    assert got["detail"]["requests"] >= 1
    assert got["detail"]["errors"] == 0 or transport == "generate"


@pytest.fixture(scope="module")
def tiny_server():
    """A tiny TorchServer (the dense default engine, CPU) behind REST,
    with the observatory's pollable ledgers armed."""
    import os

    from seldon_tpu_torch.runtime import wrapper
    from seldon_tpu_torch.servers.torchserver import TorchServer

    knobs = ("COMPILE_LEDGER", "SCHED_LEDGER", "ROOF_LEDGER", "PILOT")
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update({k: "1" for k in knobs})
    try:
        srv = TorchServer(preset="tiny", max_slots=4, max_seq_len=128,
                          device="cpu")
        srv.load()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    servers = RestServers(wrapper.build_rest_app(srv))
    yield srv, f"http://127.0.0.1:{servers.ports[0]}"
    servers.close()
    srv.stop()


def test_generate_run_against_torchserver(tiny_server):
    """A short streamed run with cancels and deadlines: every request
    lands in one outcome, the engine's counters agree with the ledger,
    and nothing leaks once idle."""
    srv, url = tiny_server
    before = srv.engine.stats.snapshot()
    total, dt, lats, errors, toks, stats, outcomes = asyncio.run(
        tlt.run_generate(url, 4, 2.0, prompt="p" * 40, max_new_tokens=64,
                         cancel_frac=0.3, deadline_ms=10,
                         deadline_frac=0.3,
                         # A fixed decode length through the per-request
                         # body: with one static body the deadline draw
                         # is made once per run (ROADMAP.md C16).
                         decode_len_dist="uniform:64,64"))
    # The engine reaps the last cancels at its next boundaries.
    deadline = time.time() + 30
    while srv.engine.debug_lifecycle_check() and time.time() < deadline:
        time.sleep(0.02)
    after = srv.engine.stats.snapshot()
    assert sum(outcomes.values()) == total + errors
    assert outcomes["error"] == 0, outcomes
    assert outcomes["completed"] == total and total >= 1
    assert outcomes["cancelled"] >= 1 and outcomes["deadline"] >= 1
    assert toks > 0 and stats["ttft_p50_ms"] > 0
    d_cancel = after["cancelled_total"] - before["cancelled_total"]
    d_deadline = (after["deadline_expired_total"]
                  - before["deadline_expired_total"])
    # Every deadline the client saw the engine counted; a client's cancel
    # reaches the engine unless its stream ended first, by finishing or by
    # its deadline passing before the hang-up was noticed.
    expired_first = d_deadline - outcomes["deadline"]
    assert expired_first >= 0, (d_deadline, outcomes)
    assert 1 <= d_cancel <= outcomes["cancelled"] - expired_first, (
        d_cancel, d_deadline, outcomes)
    assert srv.engine.debug_lifecycle_check() == {}


def test_debug_readers_match_jax(tiny_server):
    """The /debug/* readers on the port's server's own snapshots: served
    frozen from a stub (the live ledgers keep counting idle ticks between
    two polls), both tools' readers give equal dicts; on the live server
    the port's readers give the same keys."""
    srv, url = tiny_server
    srv.generate({"prompt": "abc", "max_new_tokens": 3, "temperature": 0.0})
    snaps = {}
    for kind in ("compile", "sched", "pilot", "roof"):
        with urllib.request.urlopen(f"{url}/debug/{kind}", timeout=30) as r:
            snaps[kind] = json.loads(r.read())

    async def frozen(request):
        return web.json_response(snaps[request.match_info["kind"]])

    app = web.Application()
    app.router.add_get("/debug/{kind}", frozen)
    stub = RestServers(app)
    frozen_url = f"http://127.0.0.1:{stub.ports[0]}"
    try:
        for name in ("_compile_counts", "_sched_counts", "_pilot_counts",
                     "_roof_counts"):
            want = getattr(jlt, name)(frozen_url)
            assert getattr(tlt, name)(frozen_url) == want, name
            assert want, name
            assert set(getattr(tlt, name)(url)) == set(want), name
    finally:
        stub.close()
    # A route that does not answer: the readers give {}.
    assert tlt._compile_counts("http://127.0.0.1:9") == {}
