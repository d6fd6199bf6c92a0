"""The engine's observatory in seldon_tpu_torch: the ledgers wired into the
port's engine and server, held to the port's own ledgers-off path and to
the JAX engine where its tests are green (``tiny`` preset, CPU).

 * Heisenberg: greedy streams with every ledger armed (flight recorder,
   compile ledger, dispatch timing, HBM, sched and roof ledgers, the
   pilot) and the lattice warmed equal the streams with every ledger off,
   token for token, on the ragged kernel leg (its plain version on the
   CPU), the paged and dense bucketed engines, chunked prefill and
   speculative decoding. With the ledgers on, the warmed lattice leaves
   zero live retraces, every dispatched key lies in ``static_lattice()``
   and the sched and roof conservation audits stay clean.
 * Against JAX, on one fixed schedule (every request queued before the
   engine starts, the synchronous loop): the dispatched variants and
   their dispatch counts, and the sched ledger's token and boundary
   counters, equal the JAX engine's (dense, dense chunked, paged, the
   ragged wave).
 * ``kv_live`` is positive while a request holds its blocks or slot,
   read between a dispatch and its boundary (no race).
 * ``PILOT=hold`` freezes every knob; ``PILOT=1`` leaves the greedy
   streams of the JAX pilot test's three modes unchanged.
 * Over REST, the wrapper's ``/debug/*`` routes answer 200 with the
   frozen key sets when their knob is armed and 404 naming the knob when
   it is not; ``/debug/health`` answers 404 (its knob is ``HEAL=1``).
   ``TorchServer.metrics()`` gives the keys ``JAXServer.metrics()``
   gives under the same knobs, ``torchserver_`` for ``jaxserver_``."""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from seldon_tpu.models.config import PRESETS
from seldon_tpu.models.sampling import SamplingParams as JSamplingParams
from seldon_tpu.servers import engine as jeng
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import engine as teng
from tests.test_torch_ledgers import check_goldens
from tests.torch_port_helpers import (RestServers, _copying, http_request,
                                      params_pair)

KNOBS = {"FLIGHT_RECORDER": "1", "COMPILE_LEDGER": "1",
         "DISPATCH_TIMING": "1", "HBM_LEDGER": "1", "SCHED_LEDGER": "1",
         "ROOF_LEDGER": "1", "PILOT": "hold"}
BASE = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32),
            async_fetch=False)
MODES = {
    "ragged": dict(paged_kv=True, kv_block=8, kv_pool_blocks=4 * 8 + 1,
                   chunked_prefill=True, prefill_chunk=16, prefix_block=8,
                   ragged=True, ragged_kernel="pallas",
                   dispatch_token_budget=4 * 16),
    "paged": dict(paged_kv=True, kv_block=16),
    "dense": {},
    "chunked": dict(chunked_prefill=True, prefill_chunk=8, prefix_block=8),
    "spec": dict(paged_kv=True, kv_block=16, spec_decode=True, spec_k=2,
                 ragged_kernel="pallas"),
}
LENGTHS = (12, 26, 7, 30, 16, 3)
NEW = 6


@pytest.fixture(scope="module")
def weights():
    cfg, tcfg = PRESETS["tiny"], TPRESETS["tiny"]
    jparams, tparams = params_pair(cfg, seed=0)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
               for n in LENGTHS]
    return dict(cfg=cfg, tcfg=tcfg, jp=jparams, tp=tparams,
                prompts=prompts)


def _arm(monkeypatch, on, pilot="hold"):
    for var, val in KNOBS.items():
        if on:
            monkeypatch.setenv(var, pilot if var == "PILOT" else val)
        else:
            monkeypatch.delenv(var, raising=False)


def _drain(q):
    toks = []
    while True:
        item = q.get(timeout=120)
        if item is None:
            return toks
        assert "error" not in item, item
        toks.extend(item["tokens"])


def run_port(w, ekw, warmup=False):
    """Every prompt queued before start (one fixed schedule on the
    synchronous loop); returns (greedy streams, stopped engine)."""
    eng = teng.InferenceEngine(w["tp"], w["tcfg"],
                               teng.EngineConfig(**BASE, **ekw),
                               device="cpu")
    if warmup:
        eng.warmup()
    qs = [eng.submit(p, SamplingParams(seed=i, temperature=0.0,
                                       max_new_tokens=NEW))
          for i, p in enumerate(w["prompts"])]
    eng.start()
    try:
        streams = [_drain(q) for q in qs]
        assert eng.drain(timeout=60)
    finally:
        eng.stop()
    assert eng.debug_lifecycle_check() == {}
    return streams, eng


def run_jax(w, ekw, monkeypatch):
    ekw = {k: v for k, v in ekw.items() if k != "ragged_kernel"}
    with monkeypatch.context() as mp:
        # ROADMAP.md C3: a copying asarray changes no value.
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(w["jp"], w["cfg"],
                                   jeng.EngineConfig(**BASE, **ekw))
        qs = [eng.submit(p, JSamplingParams(seed=i, temperature=0.0,
                                            max_new_tokens=NEW))
              for i, p in enumerate(w["prompts"])]
        eng.start()
        try:
            streams = [_drain(q) for q in qs]
            assert eng.drain(timeout=120)
        finally:
            eng.stop()
    return streams, eng


@pytest.mark.parametrize("mode", sorted(MODES))
def test_streams_equal_with_every_ledger_on(weights, mode, monkeypatch):
    _arm(monkeypatch, False)
    want, off = run_port(weights, MODES[mode])
    assert off.debug_compile() is None and off._observe is False
    _arm(monkeypatch, True, pilot="1")
    got, eng = run_port(weights, MODES[mode], warmup=True)
    assert got == want, f"{mode}: the observatory changed the streams"
    comp = eng.debug_compile()
    assert comp["warmup_complete"]
    assert comp["live_retrace_count"] == 0, comp["live_retraces"]
    assert set(e["key"] for e in comp["lattice"]) <= set(
        eng.static_lattice())
    assert comp["declared_variants"] == len(eng.static_lattice())
    sched, roof = eng.debug_sched(), eng.debug_roof()
    assert sched["conservation"]["breaches"] == 0, sched["conservation"]
    assert roof["conservation"]["breaches"] == 0, roof["conservation"]
    assert sched["useful_tokens"] > 0 and roof["waves"] > 0
    for kind in ("compile", "hbm", "sched", "pilot", "roof", "timeline"):
        check_goldens(kind, getattr(eng, f"debug_{kind}")())
    stats = eng.stats.snapshot()
    assert stats["sched_boundaries"] == sched["dispatch_boundaries"]
    assert set(stats["variant_timing"]) == {
        e["key"] for e in comp["lattice"] if e["dispatches"] > 1}


JAX_MODES = ("dense", "chunked", "paged", "ragged")
SCHED_FIELDS = ("dispatch_boundaries", "dispatch_cells", "useful_tokens",
                "bucket_pad_tokens", "group_pad_tokens",
                "spec_rejected_tokens", "frag_tokens",
                "budget_offered_tokens", "budget_used_tokens",
                "budget_starved_passes", "padding_waste_frac",
                "budget_utilization", "pool_stall_events", "preemptions",
                "preempted_tokens", "by_shape")


@pytest.mark.parametrize("mode", JAX_MODES)
def test_dispatched_keys_and_sched_counters_equal_jax(weights, mode,
                                                      monkeypatch):
    monkeypatch.setenv("COMPILE_LEDGER", "1")
    monkeypatch.setenv("SCHED_LEDGER", "1")
    want_streams, jengine = run_jax(weights, MODES[mode], monkeypatch)
    got_streams, tengine = run_port(weights, MODES[mode])
    assert got_streams == want_streams, mode

    def lattice(eng):
        return {e["key"]: e["dispatches"]
                for e in eng.debug_compile()["lattice"]}

    assert lattice(tengine) == lattice(jengine)
    tsched, jsched = tengine.debug_sched(), jengine.debug_sched()
    assert {k: tsched[k] for k in SCHED_FIELDS} == \
        {k: jsched[k] for k in SCHED_FIELDS}
    assert tsched["wait"]["requests"] == jsched["wait"]["requests"]
    js, ts = jengine.stats.snapshot(), tengine.stats.snapshot()
    for key in ("sched_boundaries", "sched_useful_tokens",
                "sched_bucket_pad_tokens", "sched_group_pad_tokens",
                "sched_frag_tokens", "padding_waste_frac", "waste_counts"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("mode", ["paged", "dense"])
def test_kv_live_while_a_request_holds_its_cache(weights, mode,
                                                 monkeypatch):
    monkeypatch.setenv("HBM_LEDGER", "1")
    eng = teng.InferenceEngine(weights["tp"], weights["tcfg"],
                               teng.EngineConfig(**BASE, **MODES[mode]),
                               device="cpu")
    cats = eng.debug_hbm()["categories"]
    assert cats["kv_live"]["bytes"] == 0
    reserved = cats["kv_cache"]["bytes"]
    assert reserved == sum(t.numel() * t.element_size()
                           for t in eng._state["cache"].values())
    assert cats["weights"]["bytes"] == sum(
        t.numel() * t.element_size() for t in weights["tp"].parameters())
    q = eng.submit(weights["prompts"][3], SamplingParams(
        temperature=0.0, max_new_tokens=NEW))
    # One boundary dispatched by hand: the request holds its blocks (or
    # slot) until that boundary is processed.
    with eng._book:
        wave = eng._dispatch_once()
    live = eng.debug_hbm()["categories"]["kv_live"]["bytes"]
    if mode == "paged":
        snap = eng._allocator.snapshot()
        # 30 prompt tokens and the decode chunk's growth, in blocks of 16.
        assert snap["used"] == 3
        assert live == reserved * snap["used"] // snap["total"] > 0
    else:
        assert live == reserved // BASE["max_slots"] > 0
    with eng._book:
        eng._process_boundary(wave)
    eng.start()
    try:
        assert len(_drain(q)) == NEW
    finally:
        eng.stop()
    cats = eng.debug_hbm()["categories"]
    assert cats["kv_live"]["bytes"] == 0
    assert cats["kv_live"]["high_bytes"] == live


def test_pilot_hold_freezes_every_knob(weights, monkeypatch):
    _arm(monkeypatch, False)
    monkeypatch.setenv("PILOT", "hold")
    ekw = dict(MODES["chunked"], dispatch_token_budget=16)
    eng = teng.InferenceEngine(weights["tp"], weights["tcfg"],
                               teng.EngineConfig(**BASE, **ekw),
                               device="cpu")
    before = eng.debug_pilot()
    streams, eng = run_port(weights, ekw)
    snap = eng.debug_pilot()
    assert snap["mode"] == "hold" and snap["boundaries"] > 0
    assert snap["knobs"] == before["knobs"] == {
        "dispatch_token_budget": 16, "max_admit": 4, "chunk_bias": 0,
        "spec_k": 0}
    assert snap["decisions_total"] == 0 and snap["ledger"] == []
    # PILOT implies the sched ledger.
    assert eng.debug_sched()["dispatch_boundaries"] > 0


@pytest.mark.parametrize("mode", ["dense", "paged", "chunked"])
def test_pilot_on_vs_off_streams_equal(weights, mode, monkeypatch):
    _arm(monkeypatch, False)
    want, _ = run_port(weights, MODES[mode])
    monkeypatch.setenv("PILOT", "1")
    got, eng = run_port(weights, MODES[mode])
    assert got == want, f"{mode}: the pilot changed the streams"
    pilot = eng.debug_pilot()
    assert pilot["mode"] == "auto" and pilot["boundaries"] > 0
    assert eng.debug_sched()["conservation"]["breaches"] == 0


# ---------------------------------------------------------------------------
# The server surface: /debug/* over REST and the metrics' keys
# ---------------------------------------------------------------------------

ROUTES = {"timeline": "FLIGHT_RECORDER", "compile": "COMPILE_LEDGER",
          "hbm": "HBM_LEDGER", "sched": "SCHED_LEDGER", "pilot": "PILOT",
          "roof": "ROOF_LEDGER"}
SERVER = dict(preset="tiny", max_slots=4, max_seq_len=128,
              prefill_chunk=16, ragged=1)


def _debug_payloads(srv):
    from seldon_tpu_torch.runtime import wrapper

    rest = RestServers(wrapper.build_rest_app(srv))
    try:
        port = rest.ports[0]
        status, raw = http_request(port, "POST", "/generate", {
            "prompt_token_ids": [5, 17, 99, 3, 250], "max_new_tokens": 4,
            "temperature": 0.0})
        assert status == 200, raw
        out = {}
        for kind in (*ROUTES, "health"):
            status, raw = http_request(port, "GET", f"/debug/{kind}")
            out[kind] = (status, json.loads(raw))
        return out
    finally:
        rest.close()


def test_debug_routes_answer_with_the_frozen_schema(monkeypatch):
    from seldon_tpu_torch.servers.torchserver import TorchServer

    _arm(monkeypatch, True)
    srv = TorchServer(ragged_kernel="pallas", warmup=1, device="cpu",
                      **SERVER)
    try:
        got = _debug_payloads(srv)
    finally:
        srv.stop()
    for kind in ROUTES:
        status, snap = got[kind]
        assert status == 200, (kind, snap)
        check_goldens(kind, snap)
    assert got["compile"][1]["live_retrace_count"] == 0
    assert got["compile"][1]["warmup_complete"] is True
    assert got["health"][0] == 404
    assert "heal supervisor" in got["health"][1]["error"]

    _arm(monkeypatch, False)
    srv = TorchServer(ragged_kernel="pallas", device="cpu", **SERVER)
    try:
        got = _debug_payloads(srv)
    finally:
        srv.stop()
    for kind, knob in ROUTES.items():
        status, body = got[kind]
        assert status == 404 and f"set {knob}=1" in body["error"], body


def test_metrics_keys_equal_jax_server(monkeypatch):
    from seldon_tpu.servers.jaxserver import JAXServer
    from seldon_tpu_torch.servers.torchserver import TorchServer

    _arm(monkeypatch, True)
    keys = {}
    for name, cls, kw in (("jax", JAXServer, {}),
                          ("port", TorchServer,
                           dict(ragged_kernel="pallas", device="cpu"))):
        with monkeypatch.context() as mp:
            mp.setattr(jnp, "asarray", _copying(jnp.asarray))
            srv = cls(warmup=1, **SERVER, **kw)
            srv.load()
            try:
                srv.generate({"prompt_token_ids": [5, 17, 99, 3, 250],
                              "max_new_tokens": 4, "temperature": 0.0})
                metrics = srv.metrics()
            finally:
                srv.engine.stop()
        prefix = f"{name == 'jax' and 'jaxserver' or 'torchserver'}_"
        keys[name] = {(m["key"][len(prefix):],
                       tuple(sorted(m.get("tags", {}).items())))
                      for m in metrics}
        assert all(m["key"].startswith(prefix) for m in metrics)
    assert keys["port"] == keys["jax"]
    assert ("live_retraces", ()) in keys["port"]
    assert ("mfu", (("variant", "ragged/16"),)) in keys["port"]
