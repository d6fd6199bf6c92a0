"""The checks of the JAX package's tools/heal_audit.py, on the port: the
tiny TorchServer (its default engine, warmed) behind REST with HEAL=1 and
CHAOS=1 arming the audit's storm of dispatch faults, slow boundaries,
fetch hangs past the watchdog and poisoned ids, the port's loadtester
driving the server over HTTP while the storm wave runs.

 * idle: the frozen /debug/health schema, "healthy", every counter zero;
 * a greedy + sampled wave through the storm equals the same wave on a
   clean engine sharing the weights, with zero error items, and the storm
   fired (topped up until a dispatch fault or a hang landed);
 * the supervisor recovered and resurrected, quarantined and exhausted
   nothing; /healthz stays ready; the loadtester completes its requests
   with no error outcome;
 * zero live retraces (replays land in the warmed lattice); "heal"
   records in /debug/timeline carry state and error, the
   torchserver_heal_* gauges are exported, and tools/trace_view renders
   the heal lane and its verdict counters;
 * with GRAFTSAN=1 armed beside the storm, the runtime sanitizer records
   zero lock-contract violations under recovery (the JAX audit's last
   check) and its boundary audits ran."""

import asyncio
import contextlib
import dataclasses
import io
import json
import threading
import urllib.request

import pytest

from seldon_tpu_torch import loadtester
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.runtime import wrapper
from seldon_tpu_torch.servers.chaos import ChaosConfig
from seldon_tpu_torch.servers.engine import InferenceEngine
from seldon_tpu_torch.servers.torchserver import TorchServer
from tools import trace_view
from torch_port_helpers import RestServers
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)

# The frozen /debug/health key set (tools/heal_audit.py keeps the same).
HEALTH_TOP_KEYS = frozenset({
    "enabled", "state", "mode", "max_retries", "watchdog_ms",
    "resurrected", "quarantined", "watchdog_trips", "retry_exhausted",
    "sentinel_trips", "recoveries", "consecutive_faults",
    "clean_boundaries", "pen", "suspects", "probing", "pressure",
})

AUDIT_ENV = {
    "HEAL": "1", "HEAL_MAX_RETRIES": "6", "HEAL_WATCHDOG_MS": "1000",
    "GRAFTSAN": "1",
    "FLIGHT_RECORDER": "1", "COMPILE_LEDGER": "1",
    "CHAOS": "1", "CHAOS_SEED": "17", "CHAOS_DISPATCH_FAIL": "0.05",
    "CHAOS_SLOW_BOUNDARY": "0.05", "CHAOS_SLOW_MS": "2",
    "CHAOS_HANG": "0.02", "CHAOS_HANG_MS": "1500",
    "CHAOS_NAN_INJECT": "0.02",
}


def _drain(q):
    toks, err = [], None
    while True:
        item = q.get(timeout=300)
        if item is None:
            return toks, err
        if "error" in item:
            err = item
        else:
            toks.extend(item.get("tokens", []))


def _params_for(i):
    if i % 2 == 0:
        return SamplingParams(temperature=0.0, top_k=0, top_p=1.0,
                              max_new_tokens=12, seed=i)
    return SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                          max_new_tokens=12, seed=i)


def test_heal_audit_on_the_port(monkeypatch):
    for k, v in AUDIT_ENV.items():
        monkeypatch.setenv(k, v)
    srv = TorchServer(preset="tiny", max_slots=4, max_seq_len=128,
                      warmup=1, device="cpu")
    srv.load()
    eng = srv.engine
    assert eng._chaos is not None and eng._heal is not None
    servers = RestServers(wrapper.build_rest_app(srv))
    url = f"http://127.0.0.1:{servers.ports[0]}"

    def get(path):
        with urllib.request.urlopen(url + path, timeout=30) as resp:
            return json.loads(resp.read())

    try:
        idle = get("/debug/health")
        assert set(idle) == HEALTH_TOP_KEYS
        assert idle["enabled"] is True and idle["state"] == "healthy"
        for key in ("resurrected", "quarantined", "watchdog_trips",
                    "retry_exhausted", "sentinel_trips", "recoveries",
                    "pen"):
            assert idle[key] == 0, key
        assert idle["pressure"] == 0.0

        vocab = eng.cfg.vocab_size
        prompts = [[3 + (7 * i + j) % (vocab - 4) for j in range(16)]
                   for i in range(24)]

        def run_wave(engine):
            qs = [engine.submit(p, _params_for(i))
                  for i, p in enumerate(prompts)]
            drained = [_drain(q) for q in qs]
            return [t for t, _ in drained], [e for _, e in drained]

        # The loadtester drives the faulting server over HTTP meanwhile.
        ledger = {}

        def load():
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                loadtester.main([url, "--transport", "generate",
                                 "--clients", "4", "--seconds", "2",
                                 "--prompt", "p" * 64,
                                 "--max-new-tokens", "8"])
            ledger.update(json.loads(buf.getvalue().strip().splitlines()[-1]))

        lt = threading.Thread(target=load)
        lt.start()
        storm_streams, storm_errs = run_wave(eng)
        ready = get("/healthz")
        lt.join(timeout=120)
        assert not lt.is_alive()
        extra_waves = 0
        while (eng.chaos_counts()["dispatch_faults"] == 0
               and eng.chaos_counts()["hangs"] == 0 and extra_waves < 20):
            extra_waves += 1
            more, more_errs = run_wave(eng)
            storm_streams += more
            storm_errs += more_errs
        chaos = eng.chaos_counts()
        assert sum(chaos.values()) > 0, "the storm never fired"

        ref = InferenceEngine(eng.params, eng.cfg,
                              dataclasses.replace(eng.ecfg,
                                                  chaos=ChaosConfig()),
                              device="cpu")
        assert ref._chaos is None
        ref.start()
        try:
            ref_streams, ref_errs = run_wave(ref)
            for _ in range(extra_waves):
                more, more_errs = run_wave(ref)
                ref_streams += more
                ref_errs += more_errs
        finally:
            ref.stop()
        assert not [e for e in ref_errs if e]
        assert not [e for e in storm_errs if e], storm_errs
        assert storm_streams == ref_streams

        health = get("/debug/health")
        assert health["recoveries"] >= 1 and health["resurrected"] >= 1
        assert health["quarantined"] == 0 and health["retry_exhausted"] == 0
        assert ready.get("status") == "ready", ready
        detail = ledger["detail"]
        assert detail["requests"] >= 1
        assert detail["outcomes"]["error"] == 0, detail["outcomes"]
        snap = get("/debug/timeline")
    finally:
        servers.close()

    assert srv.debug_compile()["live_retrace_count"] == 0
    gauges = {m["key"]: m["value"] for m in srv.metrics()}
    for key in ("torchserver_heal_resurrected", "torchserver_heal_quarantined",
                "torchserver_heal_watchdog_trips",
                "torchserver_heal_retry_exhausted",
                "torchserver_heal_pressure"):
        assert key in gauges, key
    assert gauges["torchserver_heal_resurrected"] >= 1

    heal_recs = [r for r in snap["records"] if r["kind"] == "heal"]
    assert heal_recs
    for r in heal_recs:
        assert {"state", "error"} <= set(r["detail"])
    out = json.loads(json.dumps(trace_view.convert(snap)))
    lanes = {e["args"]["name"] for e in out["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert "seldon-tpu heal" in lanes
    assert "heal_verdicts" in {e["name"] for e in out["traceEvents"]
                               if e["ph"] == "C"}
    srv.stop()
    assert eng.debug_lifecycle_check() == {}
    # The books stay clean under recovery.
    assert eng._san is not None and eng._san.audits > 0
    assert not eng._san.violations, [v.render() for v in eng._san.violations]


def test_health_route_404_without_heal(monkeypatch):
    monkeypatch.delenv("HEAL", raising=False)
    srv = TorchServer(preset="tiny", max_slots=2, max_seq_len=64,
                      device="cpu")
    srv.load()
    servers = RestServers(wrapper.build_rest_app(srv))
    try:
        from torch_port_helpers import http_request

        status, body = http_request(servers.ports[0], "GET", "/debug/health")
        assert status == 404 and b"HEAL=1" in body
        status, body = http_request(servers.ports[0], "GET", "/healthz")
        assert status == 200 and b"heal" not in body
    finally:
        servers.close()
        srv.stop()
    assert not [m for m in srv.metrics()
                if m["key"].startswith("torchserver_heal_")]
