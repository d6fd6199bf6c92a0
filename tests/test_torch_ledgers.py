"""The observatory's ledgers of seldon_tpu_torch against the JAX package's.

 * Module twins: for the compile ledger, the flight recorder, the HBM
   ledger, the sched ledger, the pilot controller and the roof ledger,
   the same call sequence into the JAX module and the port's gives
   equal snapshots (the clocks both read are stubbed to the same
   sequence); the contract is equality, no tolerance.
 * The cost model: ``cost_of_key`` for every key of every certifier
   grid spec and ``predict`` over a grid of requests are bit-equal to
   JAX's, on ``tiny`` and on the llama3-8b config (float equality).
 * The frozen ``/debug/*`` key sets of ``tests/test_debug_schema.py``
   hold for the port's snapshots, empty and filled.
 * The peak table is the card's: the three NVIDIA H100 names resolve to
   their datasheet entries, the environment overrides win, any other
   name calibrates on its device; where the JAX ledgers swallow an
   error (a broken gauge, an unpriceable key, a bad override) the port
   raises."""

import collections
import itertools
import types

import pytest

from seldon_tpu.models.config import PRESETS
from seldon_tpu.servers import (compile_ledger as jcl, controller as jctl,
                                cost_model as jcm, flight_recorder as jfr,
                                hbm_ledger as jhl, sched_ledger as jsl)
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.servers import (compile_ledger as tcl,
                                      controller as tctl, cost_model as tcm,
                                      flight_recorder as tfr,
                                      hbm_ledger as thl, sched_ledger as tsl,
                                      shape_lattice as tlat)
from tests import test_debug_schema as golden

JAX = types.SimpleNamespace(cl=jcl, fr=jfr, hl=jhl, sl=jsl, ctl=jctl, cm=jcm)
PORT = types.SimpleNamespace(cl=tcl, fr=tfr, hl=thl, sl=tsl, ctl=tctl, cm=tcm)
PEAKS = {"tflops": 989.4, "gbs": 3350.0, "source": "table"}


class Clock:
    """A deterministic clock: every call returns the next tick."""

    def __init__(self, start=1000.0, step=0.0125):
        self.t, self.step = start, step

    def __call__(self):
        self.t += self.step
        return self.t


@pytest.fixture
def clocks(monkeypatch):
    """Stub every clock the ledgers read (both packages' modules), each
    package's on its own but identical sequence."""

    def stub(ns):
        for mod in (ns.cl, ns.fr, ns.sl, ns.ctl):
            fake = types.SimpleNamespace(
                monotonic=Clock(), perf_counter=Clock(), time=Clock(5e8))
            monkeypatch.setattr(mod, "time", fake)

    def run(populate):
        stub(JAX)
        want = populate(JAX)
        stub(PORT)
        got = populate(PORT)
        return got, want

    return run


# ---------------------------------------------------------------------------
# One call sequence per ledger, written once, run on either package
# ---------------------------------------------------------------------------


def compile_seq(m):
    led = m.cl.CompileLedger()
    led.declare(("admit", 64, 4, 1))
    led.declare(("ragged", 8))
    led.dispatch(("admit", 64, 4, 1), rid=-1, seconds=0.5)
    led.dispatch(("decode", 8), rid=-1, seconds=0.2)
    led.dispatch(("ragged", 8), rid=-1, seconds=0.4)
    led.warmup_done()
    led.dispatch(("admit", 64, 4, 1), rid=1, seconds=0.001)
    led.dispatch(("ragged", 8), rid=3, seconds=0.0)
    led.dispatch(("admit", 128, 8, 1), rid=2, seconds=0.7)
    for i in range(3):
        led.dispatch(("chunk", 16, 2, 16 * i), rid=4 + i, seconds=0.01 * i)
    return led.snapshot()


def recorder_seq(m):
    rec = m.fr.FlightRecorder(size=8)
    for i in range(11):
        rec.record("boundary" if i % 3 else "submit", i,
                   {"admits": i, "chunk": 4})
    rec.record("drain", -1)
    return rec.snapshot()


def hbm_seq(m):
    led = m.hl.HbmLedger()
    live = [4096]
    led.set_static("weights", 1 << 20)
    led.gauge("kv_cache", lambda: 1 << 18)
    led.gauge("kv_live", lambda: live[0])
    led.note_workspace(2048)
    led.note_workspace(1024)
    first = led.snapshot()
    live[0] = 1024
    return first, led.snapshot()


def sched_seq(m):
    led = m.sl.SchedLedger()
    led.note_group(("admit", 64, 4), 256, 100, 92, 64)
    led.note_group(("chunk", 128, 2, 0), 256, 200, 56, 0)
    led.note_group(("ragged", 8), 46, 46, 0, 0)
    led.note_group(("verify", 4), 10, 7, 0, 0, spec_rejected=3)
    led.note_spec(8, 5, 3)
    led.note_budget(512, 400, starved=True)
    led.note_budget(512, 512, starved=False)
    led.note_pool_stall(7)
    led.note_bucket_defer(7)
    led.note_preempt(9, tokens=48)
    led.note_boundary()
    waste = led.boundary_waste()
    led.note_idle()
    led.note_first_dispatch(7, submitted_at=999.0, now=1001.0,
                            predicted_ms=12.5)
    led.note_first_dispatch(8, submitted_at=1000.5, now=1001.0)
    led.audit()
    # An inconsistent feed breaches the same way in both.
    led.note_spec(4, 3, 0)
    led.note_group(("admit", 32, 1), 32, 40, 0, 0)
    led.audit()
    return waste, led.snapshot()


def _signals(**over):
    base = {k: 0 for k in jctl._DELTA_KEYS}
    base.update(goodput=1.0, queue_depth=0, free_slots=4,
                roof_backlog_ms=0.0, heal_pressure=0.0)
    base.update(over)
    return base


def pilot_seq(m, hold=False):
    pilot = m.ctl.PilotController(hold=hold)
    pilot.bind(chunked=True, prefill_chunk=8, max_slots=4, max_admit=4,
               dispatch_token_budget=8, spec=True, spec_rungs=(1, 2, 4))
    Req = collections.namedtuple("Req", "deadline submitted_at")
    q = collections.deque([Req(9.0, 0.0), Req(1.0, 0.0), Req(None, 0.5)])
    ordered = [tuple(r) for r in pilot.order_queue(q)]
    fifo = collections.deque([Req(None, 0.0), Req(None, 1.0)])
    same = pilot.order_queue(fifo) is fifo
    pilot.note_expired_pop()
    cum = _signals()
    decisions = []

    def window(**delta):
        for k, v in delta.items():
            if k in jctl._DELTA_KEYS:
                cum[k] += v
            else:
                cum[k] = v
        for _ in range(pilot.period):
            decisions.extend(d["knob"] for d in
                             pilot.on_boundary(lambda: dict(cum)))

    window()  # baselines only
    window(budget_dispatches=4, budget_starved_passes=4,
           budget_offered_tokens=32, budget_used_tokens=32, queue_depth=6,
           pool_stall_events=2, deadline_expired=1, spec_drafted=40,
           spec_accepted=4, dispatch_cells=64, useful_tokens=40)
    window(goodput=0.75, dispatch_cells=64, useful_tokens=60)
    for _ in range(4):  # calm windows: the recovery rules
        window(budget_dispatches=4, budget_offered_tokens=64,
               budget_used_tokens=8, spec_drafted=40, spec_accepted=36,
               dispatch_cells=64, useful_tokens=64)
    return ordered, same, decisions, pilot.snapshot(), (
        pilot.dispatch_budget(), pilot.admit_cap(), pilot.chunk_bias(),
        pilot.spec_k(2))


def roof_seq(m, monkeypatch, cfg, draft_cfg):
    monkeypatch.setenv("ROOF_PEAK_TFLOPS", "989.4")
    monkeypatch.setenv("ROOF_PEAK_GBS", "3350")
    led = m.cm.RoofLedger()
    led.bind(cfg, max_slots=4, max_seq_len=64, kv_block=16, ragged_chunk=16,
             draft_cfg=draft_cfg, platform="test-card")
    led.note_ragged_occupancy(40, 120, 900)
    led.note_wave([("ragged", 16)], device_ms=3.0)
    led.note_wave([("ragged", 16)], device_ms=2.0)  # capacity-priced
    led.note_wave([("admit", 32, 2), ("cow",)], device_ms=5.0)
    led.note_wave([("decode", 8), ("draft", 2), ("verify", 2)], 20.0)
    led.note_step(host_pre_ms=1.0, device_ms=25.0, host_post_ms=2.0,
                  span_ms=30.0)
    led.audit()
    led.note_step(host_pre_ms=1.0, device_ms=2.0, host_post_ms=2.0,
                  span_ms=2.0)
    led.audit()
    pred = [led.predict_request_ms(p, n) for p in (1, 17, 60)
            for n in (0, 1, 32)]
    return pred, led.snapshot()


# ---------------------------------------------------------------------------
# Twins: equal snapshots on the same call sequence
# ---------------------------------------------------------------------------


def test_compile_ledger_equals_jax(clocks):
    got, want = clocks(compile_seq)
    assert got == want
    assert got["live_retrace_count"] == 4
    assert tcl.key_str(("chunk", 16, 2, 0)) == jcl.key_str(
        ("chunk", 16, 2, 0)) == "chunk/16/2/0"


def test_flight_recorder_equals_jax(clocks):
    got, want = clocks(recorder_seq)
    assert got == want
    assert got["dropped"] == 4 and len(got["records"]) == 8


def test_hbm_ledger_equals_jax():
    assert hbm_seq(PORT) == hbm_seq(JAX)


def test_sched_ledger_equals_jax(clocks):
    got, want = clocks(sched_seq)
    assert got == want
    assert got[1]["conservation"]["breaches"] == 2


@pytest.mark.parametrize("hold", [False, True], ids=["auto", "hold"])
def test_pilot_equals_jax(clocks, hold):
    got, want = clocks(lambda m: pilot_seq(m, hold))
    assert got == want
    decisions, snap = got[2], got[3]
    if hold:
        assert decisions == [] and snap["decisions_total"] == 0
        assert snap["knobs"] == {"dispatch_token_budget": 8,
                                 "max_admit": 4, "chunk_bias": 0,
                                 "spec_k": 4}
    else:
        # Every rule fired, both ways where its envelope allows.
        assert set(decisions) == set(golden.PILOT_KNOB_KEYS), decisions


def test_roof_ledger_equals_jax(monkeypatch):
    draft = (PRESETS["tiny"], TPRESETS["tiny"])
    want = roof_seq(JAX, monkeypatch, PRESETS["tiny"], draft[0])
    got = roof_seq(PORT, monkeypatch, TPRESETS["tiny"], draft[1])
    assert got == want
    assert got[1]["peaks"]["source"] == "env"
    assert got[1]["conservation"]["breaches"] == 1


# ---------------------------------------------------------------------------
# The cost model, bit for bit over the lattice grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("preset", ["tiny", "llama3-8b", "tiny-moe"])
def test_cost_of_key_and_predict_bit_equal(preset):
    jcfg, tcfg = PRESETS[preset], TPRESETS[preset]
    jdraft, tdraft = PRESETS["tiny"], TPRESETS["tiny"]
    n = 0
    for spec in tlat.grid():
        geom = dict(max_slots=spec.max_slots, max_seq_len=spec.max_seq_len,
                    kv_block=16, ragged_chunk=spec.ragged_chunk)
        for key in tlat.dispatch_keys(spec):
            for tp in (1, 2):
                got = tcm.cost_of_key(key, tcfg, draft_cfg=tdraft, tp=tp,
                                      **geom)
                want = jcm.cost_of_key(key, jcfg, draft_cfg=jdraft, tp=tp,
                                       **geom)
                assert got == want, (key, tp)
                n += 1
    assert n > 500
    for prompt, new, slots, tp in itertools.product(
            (0, 1, 31, 400, 2047), (0, 1, 32, 512), (1, 8, 32), (1, 2)):
        got = tcm.predict(prompt, new, tcfg, max_slots=slots, peaks=PEAKS,
                          tp=tp)
        want = jcm.predict(prompt, new, jcfg, max_slots=slots, peaks=PEAKS,
                           tp=tp)
        assert got == want, (prompt, new, slots, tp)
    for q, kv, qk in ((1, 0, 0), (40, 120, 900), (4096, 65536, 10 ** 7)):
        assert tcm.ragged_occupancy_cost(
            tcfg, q_tokens=q, kv_read_tokens=kv, attn_qk=qk) == \
            jcm.ragged_occupancy_cost(jcfg, q_tokens=q, kv_read_tokens=kv,
                                      attn_qk=qk)


def test_every_family_priced_and_unknown_raises():
    cfg = TPRESETS["tiny"]
    for fam, width in tlat.FAMILIES.items():
        key = (fam,) + (8,) * (width - 1)
        tcm.cost_of_key(key, cfg, max_slots=4, max_seq_len=64, kv_block=16,
                        ragged_chunk=8)
    with pytest.raises(ValueError, match="unknown dispatch family"):
        tcm.cost_of_key(("nope",), cfg, max_slots=4, max_seq_len=64)
    led = tcm.RoofLedger()
    led.bind(cfg, max_slots=4, max_seq_len=64, platform="NVIDIA H100")
    # The JAX ledger prices an unknown key zero; the port raises.
    with pytest.raises(ValueError):
        led.note_wave([("nope",)], device_ms=1.0)


# ---------------------------------------------------------------------------
# The frozen /debug/* key sets
# ---------------------------------------------------------------------------


def _check_roof(snap):
    assert set(snap) == golden.ROOF_TOP_KEYS
    assert set(snap["peaks"]) == golden.ROOF_PEAKS_KEYS
    assert set(snap["step"]) == golden.ROOF_STEP_KEYS
    assert set(snap["conservation"]) == golden.ROOF_CONSERVATION_KEYS
    assert set(snap["totals"]) == golden.ROOF_TOTALS_KEYS
    for v in snap["variants"]:
        assert set(v) == golden.ROOF_VARIANT_KEYS


def check_goldens(kind, snap):
    """The frozen key sets of tests/test_debug_schema.py for one
    ``/debug/<kind>`` payload (timeline: the JAX recorder's keys)."""
    if kind == "compile":
        assert set(snap) == golden.COMPILE_TOP_KEYS
        for w in snap["live_retraces"]:
            assert set(w) == golden.COMPILE_WITNESS_KEYS
        for e in snap["lattice"]:
            assert set(e) == golden.COMPILE_LATTICE_KEYS
    elif kind == "hbm":
        assert set(snap) == golden.HBM_TOP_KEYS
        for c in snap["categories"].values():
            assert set(c) == golden.HBM_CATEGORY_KEYS
    elif kind == "sched":
        assert set(snap) == golden.SCHED_TOP_KEYS
        assert set(snap["goodput_gap"]) == golden.SCHED_GAP_KEYS
        assert set(snap["spec"]) == golden.SCHED_SPEC_KEYS
        assert set(snap["wait"]) == golden.SCHED_WAIT_KEYS
        assert set(snap["conservation"]) == golden.SCHED_CONSERVATION_KEYS
        for e in snap["by_shape"]:
            assert set(e) == golden.SCHED_SHAPE_KEYS
    elif kind == "pilot":
        assert set(snap) == golden.PILOT_TOP_KEYS
        assert set(snap["knobs"]) == golden.PILOT_KNOB_KEYS
        assert set(snap["decisions_by_knob"]) == golden.PILOT_KNOB_KEYS
        assert set(snap["envelope"]) == golden.PILOT_ENVELOPE_KEYS
        assert set(snap["edf"]) == golden.PILOT_EDF_KEYS
        assert set(snap["counterfactual"]) == golden.PILOT_CF_KEYS
        for e in snap["ledger"]:
            assert set(e) == golden.PILOT_LEDGER_KEYS
            assert set(e["signal_snapshot"]) == golden.PILOT_SIGNAL_KEYS
            if e["effect"] is not None:
                assert set(e["effect"]) == golden.PILOT_EFFECT_KEYS
    elif kind == "roof":
        _check_roof(snap)
    elif kind == "timeline":
        want = jfr.FlightRecorder(size=2)
        want.record("x")
        assert set(snap) == set(want.snapshot())
        for r in snap["records"]:
            assert set(r) == set(want.snapshot()["records"][0])
    else:
        raise AssertionError(kind)


def test_goldens_hold_for_port_snapshots(clocks, monkeypatch):
    empty = {"compile": tcl.CompileLedger().snapshot(),
             "hbm": thl.HbmLedger().snapshot(),
             "sched": tsl.SchedLedger().snapshot(),
             "timeline": tfr.FlightRecorder(size=2).snapshot(),
             "roof": tcm.RoofLedger().snapshot()}
    pilot = tctl.PilotController()
    pilot.bind(chunked=True, prefill_chunk=8, max_slots=4, max_admit=4,
               dispatch_token_budget=8)
    empty["pilot"] = pilot.snapshot()
    filled = {"compile": clocks(compile_seq)[0],
              "hbm": hbm_seq(PORT)[0],
              "sched": clocks(sched_seq)[0][1],
              "timeline": clocks(recorder_seq)[0],
              "pilot": clocks(lambda m: pilot_seq(m))[0][3],
              "roof": roof_seq(PORT, monkeypatch, TPRESETS["tiny"],
                               TPRESETS["tiny"])[1]}
    assert filled["pilot"]["ledger"] and filled["compile"]["live_retraces"]
    assert filled["roof"]["variants"] and filled["sched"]["by_shape"]
    for kind in empty:
        check_goldens(kind, empty[kind])
        check_goldens(kind, filled[kind])


# ---------------------------------------------------------------------------
# The card's peak table, the overrides, and no swallowed errors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, peaks", [
    ("NVIDIA H100 80GB HBM3", (989.4, 3350.0)),
    ("NVIDIA H100 NVL", (835.0, 3900.0)),
    ("NVIDIA H100 PCIe", (756.0, 2000.0)),
])
def test_peak_table_matches_h100_names(monkeypatch, name, peaks):
    monkeypatch.delenv("ROOF_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("ROOF_PEAK_GBS", raising=False)
    assert tcm.resolve_peaks(name) == {"tflops": peaks[0], "gbs": peaks[1],
                                       "source": "table"}
    monkeypatch.setenv("ROOF_PEAK_TFLOPS", "500")
    got = tcm.resolve_peaks(name)
    assert got == {"tflops": 500.0, "gbs": peaks[1], "source": "env"}
    monkeypatch.setenv("ROOF_PEAK_GBS", "1000")
    assert tcm.resolve_peaks(name) == {"tflops": 500.0, "gbs": 1000.0,
                                       "source": "env"}
    monkeypatch.setenv("ROOF_PEAK_GBS", "fast")
    with pytest.raises(ValueError):
        tcm.resolve_peaks(name)


def test_unknown_platform_calibrates_on_its_device(monkeypatch):
    monkeypatch.delenv("ROOF_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("ROOF_PEAK_GBS", raising=False)
    for name in ("cpu", "NVIDIA A100-SXM4-80GB", "TPU v5 lite"):
        got = tcm.resolve_peaks(name, "cpu")
        assert got["source"] == "microbench"
        assert got["tflops"] > 0.0 and got["gbs"] > 0.0
    assert tcm.match_peaks("tpu v5p") is None


def test_broken_gauge_raises_where_jax_reads_zero():
    def broken():
        raise KeyError("half-built")

    jled, tled = jhl.HbmLedger(), thl.HbmLedger()
    jled.gauge("kv_live", broken)
    tled.gauge("kv_live", broken)
    assert jled.snapshot()["categories"]["kv_live"]["bytes"] == 0
    with pytest.raises(KeyError):
        tled.snapshot()


def test_from_env_gating(monkeypatch):
    knobs = {"COMPILE_LEDGER": tcl, "FLIGHT_RECORDER": tfr,
             "HBM_LEDGER": thl, "SCHED_LEDGER": tsl, "ROOF_LEDGER": tcm}
    for var, mod in knobs.items():
        monkeypatch.delenv(var, raising=False)
        assert mod.from_env() is None
        monkeypatch.setenv(var, "1")
        assert mod.from_env() is not None
    monkeypatch.setenv("FLIGHT_RECORDER_SIZE", "16")
    assert tfr.from_env().size == 16
    for val, want in (("0", None), ("1", "auto"), ("hold", "hold")):
        monkeypatch.setenv("PILOT", val)
        pilot = tctl.from_env()
        assert (pilot and pilot.snapshot()["mode"]) == want
