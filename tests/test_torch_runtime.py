"""The serving runtime of seldon_tpu_torch against the JAX package's:
the wire protocol (descriptor bytes, both import orders), the payload
codecs, tracing, the engine's stats, the unit-method dispatch, Prometheus
metrics, persistence, the framed fast lane and the REST wrapper's routes.
The same inputs go through both packages; every result must be equal
(protobuf bytes are compared with deterministic serialization)."""

import json
import os
import pathlib
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest

from seldon_tpu.core import payloads as jpay
from seldon_tpu.core import tracing as jtr
from seldon_tpu.proto import prediction_pb2 as jpb
from seldon_tpu.runtime import fastpath as jfast
from seldon_tpu.runtime import metrics_server as jms
from seldon_tpu.runtime import persistence as jpers
from seldon_tpu.runtime import seldon_methods as jsm
from seldon_tpu.runtime import wrapper as jwrap
from seldon_tpu.servers import engine as jeng
from seldon_tpu_torch.core import payloads as tpay
from seldon_tpu_torch.core import tracing as ttr
from seldon_tpu_torch.proto import prediction_pb2 as tpb
from seldon_tpu_torch.runtime import fastpath as tfast
from seldon_tpu_torch.runtime import metrics_server as tms
from seldon_tpu_torch.runtime import persistence as tpers
from seldon_tpu_torch.runtime import seldon_methods as tsm
from seldon_tpu_torch.runtime import wrapper as twrap
from seldon_tpu_torch.servers import engine as teng
from tests.torch_port_helpers import RestServers, http_request

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _bytes(msg) -> bytes:
    return msg.SerializeToString(deterministic=True)


# ---------------------------------------------------------------------------
# The wire protocol
# ---------------------------------------------------------------------------


def test_descriptor_bytes_equal_the_jax_package():
    assert tpb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert tpb.DESCRIPTOR.package == "seldon_tpu.protos"
    from seldon_tpu.proto import prediction_grpc as jgrpc
    from seldon_tpu_torch.proto import prediction_grpc as tgrpc

    assert tgrpc.method_path("TextGen", "GenerateStream") == \
        "/seldon_tpu.protos.TextGen/GenerateStream"
    assert {s: {m: (a[0].DESCRIPTOR.full_name, a[1].DESCRIPTOR.full_name,
                    a[2]) for m, a in ms.items()}
            for s, ms in tgrpc._SERVICES.items()} == \
        {s: {m: (a[0].DESCRIPTOR.full_name, a[1].DESCRIPTOR.full_name,
                 a[2]) for m, a in ms.items()}
         for s, ms in jgrpc._SERVICES.items()}


IMPORT_PROBE = r"""
import importlib, json, sys
mods = [importlib.import_module(m) for m in sys.argv[1:]]
a, b = mods
msg = a.GenerateRequest(prompt="x", prompt_token_ids=[1, 2], seed=7)
back = b.GenerateRequest.FromString(msg.SerializeToString())
print(json.dumps({"same": a.DESCRIPTOR.serialized_pb
                  == b.DESCRIPTOR.serialized_pb,
                  "ids": list(back.prompt_token_ids), "seed": back.seed}))
"""


@pytest.mark.parametrize("order", ["jax-first", "torch-first"])
def test_both_packages_import_in_either_order(order):
    mods = ["seldon_tpu.proto.prediction_pb2",
            "seldon_tpu_torch.proto.prediction_pb2"]
    if order == "torch-first":
        mods.reverse()
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", IMPORT_PROBE, *mods],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"same": True, "ids": [1, 2], "seed": 7}


# ---------------------------------------------------------------------------
# Payload codecs
# ---------------------------------------------------------------------------


class _Named:
    def class_names(self):
        return ["a", "b"]


_rng = np.random.default_rng(3)
_X = _rng.standard_normal((2, 3))

# (id, request payload, request kind, raw response)
PAYLOAD_CASES = [
    (f"dense-{dt}", _X.astype(dt), "dense", (_X * 2).astype(dt))
    for dt in ("float32", "float64", "float16", "int8", "int16", "int32",
               "int64", "uint8", "uint16", "uint32", "uint64", "bool")
] + [
    ("dense-bfloat16", _X.astype(ml_dtypes.bfloat16), "dense",
     (_X * 3).astype(ml_dtypes.bfloat16)),
    ("dense-complex-falls-back", _X.astype(np.float32), "dense",
     _X.astype(np.complex64)),
    ("tensor", _X, "tensor", _X[::-1]),
    ("ndarray", _X.round(3), "ndarray", _X.round(2)),
    ("ndarray-labels", _X, "ndarray", np.array(["cat", "dog"])),
    ("dense-labels-fall-back", _X.astype(np.float32), "dense",
     np.array(["cat", "dog"])),
    ("str", "hello", "dense", "world"),
    ("bytes", b"\x00\x01raw", "dense", b"\xffout"),
    ("json", {"a": [1, 2], "b": "c"}, "jsonData", {"out": {"x": 1.5}}),
    ("json-list", [1, 2, 3], "jsonData", [3, 2, 1]),
]


def _codec_run(pay, pb, payload, kind, out):
    req = pay.build_message(payload, names=["f0", "f1", "f2"], kind=kind)
    req.meta.puid = "p-1"
    resp = pay.construct_response(
        _Named(), False, req, out,
        tags={"n": 3, "flag": True, "none": None, "s": "x",
              "nested": {"k": [1, "two"]}},
        metrics=[{"key": "m", "value": 2, "type": "GAUGE",
                  "tags": {"t": 1}}, {"key": "c", "value": 1.5}])
    d = pay.message_to_dict(resp)
    back = pay.dict_to_message(json.dumps(d))
    got = pay.get_data_from_message(back)
    if isinstance(got, np.ndarray):
        got = (got.dtype.str, got.shape, got.tobytes())
    fb = pay.dict_to_message({"request": pay.message_to_dict(req),
                              "reward": 0.5}, pb.Feedback)
    return {"req": _bytes(req), "resp": _bytes(resp),
            "dict": json.dumps(d, sort_keys=True), "back": _bytes(back),
            "data": got, "kind": pay.data_kind(back),
            "parts": pay.extract_request_parts(req)[3],
            "feedback": _bytes(fb), "fb_dict": pay.message_to_dict(fb)}


@pytest.mark.parametrize("case", PAYLOAD_CASES, ids=[c[0] for c in PAYLOAD_CASES])
def test_payload_codecs_match_jax(case):
    _, payload, kind, out = case
    want = _codec_run(jpay, jpb, payload, kind, out)
    got = _codec_run(tpay, tpb, payload, kind, out)
    assert got == want


def test_dense_tensor_round_trip_and_raw_views():
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)
    dense = tpay.array_to_dense(arr)
    assert _bytes(dense) == _bytes(jpay.array_to_dense(arr))
    view = tpay.dense_to_array(dense, writable=False)
    np.testing.assert_array_equal(view, arr)
    assert not view.flags.writeable
    assert tpay.dense_to_array(dense).flags.writeable
    with pytest.raises(ValueError, match="unknown data kind"):
        tpay.array_to_data(arr, kind="csv")


# ---------------------------------------------------------------------------
# Tracing
# ---------------------------------------------------------------------------


TRACEPARENTS = [
    "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01",
    "  00-" + "12" * 16 + "-" + "34" * 8 + "-00  ",
    "00-" + "ab" * 15 + "-" + "cd" * 8 + "-01",
    "00-" + "ab" * 16 + "-" + "cd" * 7 + "-01",
    "garbage",
    "00-abc",
]


@pytest.mark.parametrize("tp", TRACEPARENTS)
def test_traceparent_round_trip_matches_jax(tp):
    j = jtr.SpanContext.from_traceparent(tp)
    t = ttr.SpanContext.from_traceparent(tp)
    assert (t is None) == (j is None)
    if j is not None:
        assert (t.trace_id, t.span_id) == (j.trace_id, j.span_id)
        assert t.to_traceparent() == j.to_traceparent()
    for carrier in ({"TraceParent": tp}, [("traceparent", tp.encode())],
                    {"other": tp}, None):
        je, te = jtr.Tracer.extract(carrier), ttr.Tracer.extract(carrier)
        assert (te is None) == (je is None)
        if je is not None:
            assert te.to_traceparent() == je.to_traceparent()


def test_tracer_spans_nest_and_export():
    exp = ttr.InMemoryExporter()
    tracer = ttr.get_tracer("svc", exporter=exp)
    parent = ttr.SpanContext.from_traceparent(TRACEPARENTS[0])
    with tracer.span("outer", parent=parent) as outer:
        with tracer.span("inner"):
            carrier = tracer.inject({})
    ctx = tracer.emit_span("retro", 10, 20, parent=outer.context)
    spans = {s.name: s for s in exp.spans}
    assert spans["outer"].trace_id == "ab" * 16
    assert spans["outer"].parent_id == "cd" * 8
    assert spans["inner"].parent_id == spans["outer"].span_id
    assert carrier["traceparent"] == spans["inner"].context.to_traceparent()
    assert spans["retro"].parent_id == spans["outer"].span_id
    assert ctx.trace_id == "ab" * 16
    assert sorted(exp.by_trace()) == ["ab" * 16]
    assert ttr.get_tracer("off").span("x") is ttr._NOOP_CM


# ---------------------------------------------------------------------------
# Engine stats: the ITL histogram, the SLO accounting, budget utilization
# ---------------------------------------------------------------------------


ITL_MS = [0.5, 2.0, 3.5, 7.0, 15.0, 20.0, 60.0, 150.0, 400.0, 999.0, 1000.0,
          5000.0, 4.0, 4.0, 4.0]
MARGINS = [(None, True), (None, False), (-2000.0, True), (-600.0, True),
           (-150.0, False), (-30.0, True), (0.0, True), (0.0, False),
           (10.0, True), (40.0, True), (80.0, False), (150.0, True),
           (300.0, True), (800.0, True), (5000.0, True), (1000.0, True)]
# The ledgers' mirror in the stats: per-boundary padding fractions and
# per-variant boundary times.
WASTE = [0.0, 0.01, 0.03, 0.2, 0.5, 0.9, 1.0]
VARIANTS = [("ragged/128", 0.4), ("decode/8", 3.0), ("ragged/128", 700.0),
            ("admit/32/1", 12.0)]


@pytest.mark.parametrize("n_itl", [0, 1, 5, len(ITL_MS)])
def test_engine_stats_snapshots_match_jax(n_itl):
    stats = [jeng.EngineStats(), teng.EngineStats()]
    for st in stats:
        with st.lock:
            for ms in ITL_MS[:n_itl]:
                st.record_itl_locked(ms)
            for margin, ok in MARGINS[:n_itl]:
                st.record_slo_locked(margin, ok)
            st.budget_dispatches, st.budget_tokens = 3, 40
            st.budget_limit = 32 if n_itl else 0
            st.ttft_sum, st.ttft_count = 0.25, 2
            for frac in WASTE[:n_itl]:
                st.record_waste_locked(frac)
            for key, ms in VARIANTS[:n_itl]:
                st.record_variant_locked(key, ms)
            st.sched_useful_tokens = 3 * n_itl
            st.sched_bucket_pad_tokens = n_itl
    want, got = (st.snapshot() for st in stats)
    assert set(want) <= set(got)
    assert set(got) - set(want) == teng.PORT_FIELDS
    assert {k: got[k] for k in want if k in got} == \
        {k: v for k, v in want.items() if k in got}
    for key in ("itl_p50_ms", "itl_p95_ms", "itl_p99_ms", "mean_itl_ms",
                "itl_count", "goodput", "deadline_margin_counts",
                "deadline_margin_sum_ms", "budget_utilization"):
        assert key in got


# ---------------------------------------------------------------------------
# Unit-method dispatch
# ---------------------------------------------------------------------------


def _gen_request(pb, tags):
    req = pb.GenerateRequest(prompt="hi", prompt_token_ids=[4, 5],
                             max_new_tokens=0, temperature=0.5, top_p=0.9,
                             top_k=7, seed=11, stop_token_ids=[2])
    req.meta.puid = "u"
    for k, v in tags.items():
        if isinstance(v, str):
            req.meta.tags[k].string_value = v
        else:
            req.meta.tags[k].number_value = v
    return req


GEN_TAGS = [{}, {"deadline_ms": 250}, {"deadline_ms": "125"},
            {"deadline_ms": "soon"}, {"traceparent": TRACEPARENTS[0]},
            {"traceparent": ""}, {"deadline_ms": 9, "traceparent": "x"}]


@pytest.mark.parametrize("tags", GEN_TAGS, ids=range(len(GEN_TAGS)))
def test_generate_request_and_response_match_jax(tags):
    out = {"text": "ok", "token_ids": [7, 8, 9], "ttft_ms": 1.25,
           "total_ms": 3.5, "prompt_tokens": 2}
    assert tsm._generate_request_dict(_gen_request(tpb, tags)) == \
        jsm._generate_request_dict(_gen_request(jpb, tags))
    assert _bytes(tsm._generate_response(_gen_request(tpb, tags), out)) == \
        _bytes(jsm._generate_response(_gen_request(jpb, tags), out))


class _Unit:
    """A unit with every high-level hook the dispatch table serves."""

    def predict(self, X, names, meta=None):
        return np.asarray(X) * 2

    def transform_output(self, X, names):
        return np.asarray(X) + 1

    def route(self, X, names):
        return 1

    def aggregate(self, Xs, names):
        return np.concatenate([np.asarray(x) for x in Xs], axis=-1)

    def send_feedback(self, X, names, reward, truth, routing=None):
        return np.asarray([[reward, -1 if routing is None else routing]])

    def tags(self):
        return {"unit": "u"}

    def metrics(self):
        return [{"key": "calls", "value": 1, "type": "COUNTER"}]

    def generate(self, request):
        return {"token_ids": list(request["prompt_token_ids"])[::-1]}

    def generate_stream(self, request):
        for t in request["prompt_token_ids"]:
            yield None
            yield {"token_ids": [t]}


def _dispatch_all(sm, pay, pb):
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    msg = pay.build_message(x, names=["a", "b", "c"])
    lst = pb.SeldonMessageList(seldonMessages=[msg, msg])
    fb = pb.Feedback(request=msg, reward=0.75, truth=msg)
    fb.response.meta.routing["router"] = 2
    gen = pb.GenerateRequest(prompt_token_ids=[3, 4, 5])
    unit = _Unit()
    out = [sm.predict(unit, msg), sm.transform_input(unit, msg),
           sm.transform_output(unit, msg), sm.route(unit, msg),
           sm.aggregate(unit, lst), sm.send_feedback(unit, fb, "router"),
           sm.generate(unit, gen)]
    out += [c for c in sm.generate_stream(unit, gen) if c is not None]
    return [_bytes(m) for m in out]


def test_unit_method_dispatch_matches_jax():
    assert _dispatch_all(tsm, tpay, tpb) == _dispatch_all(jsm, jpay, jpb)


# ---------------------------------------------------------------------------
# Prometheus metrics and persistence
# ---------------------------------------------------------------------------


def _metrics_text(ms, pb):
    m = ms.ServerMetrics()
    resp = pb.SeldonMessage()
    for key, typ, val, tags in (("g", pb.Metric.GAUGE, 3.0, {"a": "1"}),
                                ("c", pb.Metric.COUNTER, 2.0, {}),
                                ("t", pb.Metric.TIMER, 40.0, {}),
                                ("g", pb.Metric.COUNTER, 1.0, {"a": "1"})):
        metric = resp.meta.metrics.add(key=key, type=typ, value=val)
        for k, v in tags.items():
            metric.tags[k] = v
    m.observe("predict", "rest", 0.0123, resp)
    m.record_reward("unit", -0.5)
    m.record_reward("unit", 2.0)
    body, ctype = m.export()
    # `_created` samples are creation timestamps.
    return [line for line in body.splitlines()
            if b"_created" not in line], ctype


def test_server_metrics_export_matches_jax():
    assert _metrics_text(tms, tpb) == _metrics_text(jms, jpb)


class _State:
    def __init__(self):
        self.counts = {"arm": 3}


def test_persistence_round_trip(tmp_path, monkeypatch):
    monkeypatch.setattr(tpers, "_STATE_DIR", str(tmp_path))
    monkeypatch.setenv("PREDICTIVE_UNIT_ID", "bandit")
    monkeypatch.delenv("REDIS_SERVICE_HOST", raising=False)
    assert tpers.state_key() == jpers.state_key()
    assert tpers.restore(_State()) is None
    obj = _State()
    obj.counts["arm"] = 9
    thread = tpers.start_persist_thread(obj, frequency_s=3600)
    thread.stop()
    thread.join(timeout=10)
    assert not thread.is_alive()
    assert tpers.restore(_State()).counts == {"arm": 9}


# ---------------------------------------------------------------------------
# The framed fast lane
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("client_pkg", ["jax", "torch"])
def test_fast_lane_serves_either_client(client_pkg):
    server, port = tfast.start_fast_server(_Unit(), "127.0.0.1", 0)
    fast = (jfast if client_pkg == "jax" else tfast).FastClient(timeout_s=30)
    try:
        x = np.arange(4, dtype=np.float32).reshape(2, 2)
        req = tpay.build_message(x)
        got = fast.call("127.0.0.1", port, "predict", req)
        assert _bytes(got) == _bytes(jsm.predict(_Unit(), req))
        lst = tpb.SeldonMessageList(seldonMessages=[req, req])
        agg = fast.call("127.0.0.1", port, "aggregate", lst)
        assert tpay.get_data_from_message(agg).shape == (2, 4)
        with pytest.raises(RuntimeError):  # the unit's error, framed
            fast.call("127.0.0.1", port, "predict",
                      tpb.SeldonMessage(strData="x"))
    finally:
        fast.close()
        server.shutdown()
        server.server_close()


# ---------------------------------------------------------------------------
# The REST wrapper: the same unit behind both packages' apps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def unit_apps():
    servers = RestServers(jwrap.build_rest_app(_Unit()),
                          twrap.build_rest_app(_Unit()))
    yield servers.ports
    servers.close()


def _proto_body(pb):
    return pb.SeldonMessage(
        data=pb.DefaultData(names=["a"], tensor=pb.Tensor(
            shape=[1, 2], values=[1.0, 2.0]))).SerializeToString()


_X_JSON = {"data": {"ndarray": [[1.0, 2.0]]}}
REST_CASES = [
    ("predict-json", "POST", "/predict", _X_JSON, None),
    ("predict-v1", "POST", "/api/v1.0/predict", _X_JSON, None),
    ("predict-form", "POST", "/predict",
     b"json=" + json.dumps(_X_JSON).encode(),
     {"Content-Type": "application/x-www-form-urlencoded"}),
    ("predict-get", "GET", "/predict?json=" + json.dumps(
        _X_JSON).replace(" ", ""), None, None),
    ("predict-proto", "POST", "/predict", _proto_body(tpb),
     {"Content-Type": "application/x-protobuf"}),
    ("predict-bad-json", "POST", "/predict", b"{nope",
     {"Content-Type": "application/json"}),
    ("transform-input", "POST", "/transform-input", _X_JSON, None),
    ("transform-output", "POST", "/transform-output", _X_JSON, None),
    ("route", "POST", "/route", _X_JSON, None),
    ("aggregate", "POST", "/aggregate",
     {"seldonMessages": [_X_JSON, _X_JSON]}, None),
    ("feedback", "POST", "/send-feedback",
     {"request": _X_JSON, "reward": 1.5}, None),
    ("generate", "POST", "/generate", {"prompt_token_ids": [5, 6, 7]}, None),
    ("generate-stream", "POST", "/generate_stream",
     {"prompt_token_ids": [5, 6, 7]}, None),
    ("generate-bad", "POST", "/generate", b"[",
     {"Content-Type": "application/json"}),
    ("live", "GET", "/live", None, None),
    ("ready", "GET", "/ready", None, None),
    ("metadata", "GET", "/metadata", None, None),
    ("openapi", "GET", "/seldon.json", None, None),
    ("debug-index", "GET", "/debug", None, None),
    ("debug-timeline", "GET", "/debug/timeline", None, None),
    ("debug-health", "GET", "/debug/health", None, None),
]


@pytest.mark.parametrize("case", REST_CASES, ids=[c[0] for c in REST_CASES])
def test_rest_routes_answer_as_jax(unit_apps, case):
    _, method, path, body, headers = case
    jport, tport = unit_apps
    want = http_request(jport, method, path, body, headers)
    got = http_request(tport, method, path, body, headers)
    assert got == want
