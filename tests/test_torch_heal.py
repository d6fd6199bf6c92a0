"""seldon_tpu_torch.servers.{chaos,supervisor} and the engine's recovery
paths, against the JAX package.

 * The env gates (CHAOS=1, HEAL=1) and ``supervisor.build`` decide as the
   JAX modules do; the ChaosMonkey's seeded draws and the HealSupervisor's
   state machine, driven by the same event scripts, give the JAX twins'
   faults, verdicts and snapshots.
 * Resurrection on every engine family x KV dtype: one mid-stream wave
   fault, and the delivered greedy and sampled streams equal the port's
   clean streams exactly and the JAX clean engine's under the near-tie
   rule.
 * Poison bisection convicts the sticky rid; retry exhaustion fails
   cleanly; the admission-group fault path requeues without a rebuild;
   the watchdog and the sentinel turn a hung fetch and a poisoned id into
   recoveries; heal off keeps the raw failure path.
"""

import dataclasses
import queue
import random
import time
import types

import numpy as np
import pytest
import torch

from seldon_tpu.models.config import PRESETS as JPRESETS
from seldon_tpu.servers import chaos as jchaos
from seldon_tpu.servers import supervisor as jsup
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import chaos as tchaos
from seldon_tpu_torch.servers import engine as teng
from seldon_tpu_torch.servers import supervisor as tsup
from seldon_tpu_torch.servers.chaos import ChaosConfig, ChaosMonkey
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)

# 24 tokens; the tiny model's greedy stream of it runs the full 20
# tokens (no early EOS), so a mid-stream fault has a stream to land in.
PROMPT = list(range(5, 29))
KNOBS = {"greedy": dict(temperature=0.0, max_new_tokens=20),
         "sampled": dict(temperature=0.9, top_k=8, top_p=0.95,
                         max_new_tokens=20, seed=7)}

# The JAX resurrection matrix's serving modes.
MODES = {
    "dense": dict(),
    "paged": dict(paged_kv=True, kv_block=16, kv_pool_blocks=9,
                  prompt_buckets=(16, 32)),
    "ragged": dict(paged_kv=True, chunked_prefill=True, prefill_chunk=8,
                   prefix_block=8, kv_block=8, ragged=True,
                   ragged_kernel="pallas"),
    "spec": dict(spec_decode=True, spec_k=4, paged_kv=True, kv_block=8,
                 prefix_block=8, ragged_kernel="pallas"),
}


@pytest.fixture(scope="module")
def tiny_pair():
    """(JAX params, the port's params) of the tiny preset, seed 0."""
    from torch_port_helpers import params_pair

    return params_pair(JPRESETS["tiny"], seed=0)


def _cfg(kv_dtype="bf16"):
    return dataclasses.replace(TPRESETS["tiny"], kv_cache_dtype=kv_dtype)


def _engine(tparams, cfg=None, start=True, **ekw):
    ekw.setdefault("max_slots", 4)
    ekw.setdefault("max_seq_len", 64)
    ekw.setdefault("prompt_buckets", (8, 32))
    eng = teng.InferenceEngine(tparams, cfg or _cfg(),
                               teng.EngineConfig(**ekw), device="cpu")
    if start:
        eng.start()
    return eng


def _collect(q, timeout=600):
    toks, err = [], None
    while True:
        item = q.get(timeout=timeout)
        if item is None:
            return toks, err
        if "error" in item:
            err = item
        else:
            toks.extend(item.get("tokens", []))


def _arm_nth(eng, mk, hook="on_dispatch", n=1):
    """Install `mk` so that its `hook` passes n - 1 calls and on the n-th
    disarms chaos, then runs: exactly one injected fault at a known point
    of the schedule, then a clean engine."""
    orig = getattr(mk, hook)
    calls = []

    def nth(*args):
        calls.append(args)
        if len(calls) == n:
            eng._chaos = None
            return orig(*args)

    setattr(mk, hook, nth)
    eng._chaos = mk
    return calls


# ---------------------------------------------------------------------------
# Env gating and construction
# ---------------------------------------------------------------------------

CHAOS_ENV = {"CHAOS_SEED": "9", "CHAOS_DISPATCH_FAIL": "0.25",
             "CHAOS_ALLOC_FAIL": "0.1", "CHAOS_SLOW_BOUNDARY": "0.5",
             "CHAOS_SLOW_MS": "3", "CHAOS_DISCONNECT": "0.05",
             "CHAOS_NAN_INJECT": "0.02", "CHAOS_HANG": "0.01",
             "CHAOS_HANG_MS": "700", "CHAOS_STICKY_RID": "4"}


@pytest.mark.parametrize("master,knobs", [
    (None, CHAOS_ENV), ("0", CHAOS_ENV), ("1", {}), ("1", CHAOS_ENV),
    ("yes", {"CHAOS_STICKY_RID": "2"}), ("true", {"CHAOS_HANG": "0.5"}),
])
def test_chaos_from_env_matches_jax(monkeypatch, master, knobs):
    for k in ["CHAOS", *CHAOS_ENV]:
        monkeypatch.delenv(k, raising=False)
    if master is not None:
        monkeypatch.setenv("CHAOS", master)
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    want, got = jchaos.ChaosConfig.from_env(), tchaos.ChaosConfig.from_env()
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.any_enabled()


def test_heal_from_env_and_build_match_jax(monkeypatch):
    for k in ("HEAL", "HEAL_MAX_RETRIES", "HEAL_WATCHDOG_MS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("HEAL_MAX_RETRIES", "7")
    assert tsup.from_env() is None and jsup.from_env() is None
    monkeypatch.setenv("HEAL", "1")
    monkeypatch.setenv("HEAL_WATCHDOG_MS", "25")
    got, want = tsup.from_env(), jsup.from_env()
    assert (got.max_retries, got.watchdog_ms) == (want.max_retries,
                                                 want.watchdog_ms) == (7, 25)
    monkeypatch.delenv("HEAL")
    off = types.SimpleNamespace(heal=False, heal_max_retries=4,
                                heal_watchdog_ms=0)
    assert tsup.build(off) is None
    on = types.SimpleNamespace(heal=True, heal_max_retries=2,
                               heal_watchdog_ms=30)
    assert tsup.build(on).describe() == jsup.build(on).describe()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_heal_and_chaos_build_on_every_family(tiny_pair, monkeypatch, mode):
    """EngineConfig(heal=True, chaos=...) builds on every engine family;
    without them (and without the env gates) the engine carries neither."""
    for k in ("HEAL", "CHAOS"):
        monkeypatch.delenv(k, raising=False)
    _, tparams = tiny_pair
    eng = _engine(tparams, start=False, heal=True, heal_max_retries=3,
                  chaos=ChaosConfig(seed=1, dispatch_fail=0.5), **MODES[mode])
    assert eng._heal is not None and eng._heal.max_retries == 3
    assert eng._chaos is not None and eng.debug_health()["enabled"]
    plain = _engine(tparams, start=False, **MODES[mode])
    assert plain._heal is None and plain._chaos is None
    assert plain.debug_health() is None
    assert set(plain.chaos_counts().values()) == {0}
    # An all-zero ChaosConfig arms nothing.
    assert _engine(tparams, start=False, chaos=ChaosConfig(),
                   **MODES[mode])._chaos is None


def test_pilot_reads_the_supervisors_pressure(tiny_pair, monkeypatch):
    """The pilot's heal_pressure signal is the supervisor's level: 0.0
    healthy, 0.5 recovering, 1.0 degraded; 0.0 without heal."""
    monkeypatch.setenv("PILOT", "1")
    _, tparams = tiny_pair
    eng = _engine(tparams, start=False, heal=True, **MODES["ragged"])
    assert eng._pilot is not None
    assert eng._pilot_signals()["heal_pressure"] == 0.0
    eng._heal.plan_recovery([1], 0.0)
    assert eng._pilot_signals()["heal_pressure"] == 0.5
    eng._heal.state = tsup.DEGRADED
    assert eng._pilot_signals()["heal_pressure"] == 1.0
    plain = _engine(tparams, start=False, **MODES["ragged"])
    assert plain._pilot_signals()["heal_pressure"] == 0.0


# ---------------------------------------------------------------------------
# The ChaosMonkey's draws, twin against twin
# ---------------------------------------------------------------------------


def _drive_monkey(mod, cfg, tensors):
    mk = mod.ChaosMonkey(cfg)
    rng = random.Random(5)
    log = []
    arrays = [np.zeros(6, np.int32), np.zeros((2, 3), np.int32)]
    for step in range(300):
        op = rng.randrange(6)
        if op == 0:
            rids = rng.sample(range(1, 9), rng.randrange(0, 4))
            site = rng.choice(["admit", "decode", "ragged", "prefill-chunk"])
            try:
                mk.on_dispatch(site, rids)
                log.append("ok")
            except mod.ChaosError as e:
                log.append(str(e))
        elif op == 1:
            log.append(mk.steal_alloc())
        elif op == 2:
            log.append(mk.pick_disconnect(rng.sample(range(1, 9), 3)))
        elif op == 3:
            mk.maybe_slow_boundary()
        elif op == 4:
            mk.maybe_hang()
        else:
            bufs = ([torch.from_numpy(a) for a in arrays] if tensors
                    else arrays)
            mk.poison_fetch([None, *bufs])
            log.append([a.tolist() for a in arrays])
            for a in arrays:
                a[...] = 0
    return log, mk.snapshot()


@pytest.mark.parametrize("tensors", [False, True])
def test_chaos_monkey_draws_match_jax(tensors):
    """Both RNG streams (scheduler: dispatch / alloc / disconnect;
    fetcher: slow / hang / poison) and the sticky trigger, on one call
    script; the port poisons CPU tensors in place as JAX poisons arrays."""
    cfg = dict(seed=17, dispatch_fail=0.2, alloc_fail=0.2,
               slow_boundary=0.3, slow_ms=0.0, disconnect=0.3,
               nan_inject=0.4, hang=0.2, hang_ms=0.0, sticky_rid=3)
    want, wsnap = _drive_monkey(jchaos, jchaos.ChaosConfig(**cfg), False)
    got, gsnap = _drive_monkey(tchaos, tchaos.ChaosConfig(**cfg), tensors)
    assert got == want
    assert gsnap == wsnap
    assert all(v > 0 for v in gsnap.values()), gsnap


# ---------------------------------------------------------------------------
# The HealSupervisor's state machine, twin against twin
# ---------------------------------------------------------------------------


def _drive_supervisor(mod, seed):
    sup = mod.HealSupervisor(max_retries=3, watchdog_ms=0)
    rng = random.Random(seed)
    reqs = {rid: types.SimpleNamespace(rid=rid, finished=False)
            for rid in range(1, 9)}
    log = []
    for step in range(400):
        op = rng.randrange(8)
        now = step * 0.01
        if op <= 1:
            cohort = rng.sample(sorted(reqs), rng.randrange(1, 5))
            log.append(sorted(sup.plan_recovery(cohort, now).items()))
        elif op == 2:
            sup.note_progress(rng.choice(sorted(reqs)))
        elif op == 3:
            rid = rng.choice(sorted(reqs))
            sup.note_done(rid)
        elif op == 4:
            sup.note_boundary_ok()
        elif op == 5:
            # The engine pens a request the bisection does not probe (the
            # race where it does is test_probe_penned_..._is_released).
            rid = rng.choice(sorted(reqs))
            if rid not in sup.probing:
                sup.pen_put(reqs[rid], now)
        elif op == 6:
            out = sup.pen_take(now, flush=rng.random() < 0.1)
            log.append([r.rid for r in out])
        else:
            log.append((sup.backoff_s(), sup.pressure(), sup.pen_empty(),
                        [r.rid for r in sup.pen_scan()]))
        if step % 7 == 0:
            log.append(sup.snapshot())
    return log, sup.snapshot()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_supervisor_state_machine_matches_jax(seed):
    want = _drive_supervisor(jsup, seed)
    got = _drive_supervisor(tsup, seed)
    assert got == want
    assert set(got[1]) == {
        "enabled", "state", "mode", "max_retries", "watchdog_ms",
        "resurrected", "quarantined", "watchdog_trips", "retry_exhausted",
        "sentinel_trips", "recoveries", "consecutive_faults",
        "clean_boundaries", "pen", "suspects", "probing", "pressure"}


def test_bisection_convicts_the_recurring_faulter():
    """The JAX supervisor's bisection case, on the port's twin."""
    sup = tsup.HealSupervisor(max_retries=8)
    sup.plan_recovery([1, 2], 0.0)
    v = sup.plan_recovery([1, 2], 0.0)
    assert sup.mode == "bisect"
    probe = next(r for r, verdict in v.items() if verdict == "resurrect")
    sup.pen_put(types.SimpleNamespace(rid=3 - probe, finished=False), 0.0)
    v = sup.plan_recovery([probe], 0.0)
    assert v[probe] == "poison"
    assert sup.quarantined == 1 and sup.mode == "normal"
    assert sup.state == tsup.DEGRADED
    assert [r.rid for r in sup.pen_take(0.0)] == [3 - probe]


def test_probe_penned_after_the_bisection_advanced_is_released():
    """A recovery's probes can finish (or spend their budget) while the
    engine still places the cohort, so the bisection advances onto a
    request the engine pens right after. The port releases it at the next
    tick; the JAX twin parks it with no release (ROADMAP.md C17)."""
    for mod, released in ((jsup, []), (tsup, [3])):
        sup = mod.HealSupervisor(max_retries=8)
        sup.plan_recovery([1, 2, 3, 4], 0.0)
        sup.plan_recovery([1, 2, 3, 4], 0.0)
        assert sup.mode == "bisect" and sup.probing == {1, 2}
        sup.note_done(1)
        sup.note_done(2)
        assert sup.probing == {3}
        for rid in (3, 4):
            sup.pen_put(types.SimpleNamespace(rid=rid, finished=False), 0.0)
        assert [r.rid for r in sup.pen_take(0.0)] == released, mod
    sup.note_progress(3)  # the released probe clears: 4 is probed next
    assert sup.probing == {4}
    assert [r.rid for r in sup.pen_take(0.0)] == [4]


def test_watchdog_bounds_a_hung_fetch():
    sup = tsup.HealSupervisor(watchdog_ms=40)
    with pytest.raises(tsup.WatchdogError):
        sup.bounded_fetch(lambda: time.sleep(0.5))
    assert sup.watchdog_trips == 1
    assert sup.bounded_fetch(lambda: 7) == 7

    def boom():
        raise ValueError("from the fetch")

    with pytest.raises(ValueError):
        sup.bounded_fetch(boom)
    assert sup.watchdog_trips == 1
    inline = tsup.HealSupervisor(watchdog_ms=0)
    assert inline.bounded_fetch(lambda: 11) == 11
    assert inline._wd_thread is None


@pytest.mark.parametrize("as_tensor", [False, True])
def test_sentinel_screens_host_buffers(as_tensor):
    conv = torch.tensor if as_tensor else np.array
    sup, ref = tsup.HealSupervisor(), jsup.HealSupervisor()
    sup.check_tokens([(conv([3, 250]), conv([True]))], None, vocab_size=256)
    cases = [([(conv([3, 1 << 30]), None)], None),
             ([(conv([-1]), None)], None),
             ([], (conv([[999]]), conv([[True]]), conv([True])))]
    for admit, chunk in cases:
        with pytest.raises(tsup.SentinelError) as got:
            sup.check_tokens(admit, chunk, vocab_size=256)
        with pytest.raises(jsup.SentinelError) as want:
            ref.check_tokens([(np.asarray(f), d) for f, d in admit],
                             None if chunk is None
                             else tuple(np.asarray(a) for a in chunk),
                             vocab_size=256)
        assert str(got.value) == str(want.value)
    assert sup.sentinel_trips == 3


# ---------------------------------------------------------------------------
# Resurrection across engine families: the migration gate
# ---------------------------------------------------------------------------


def _jax_clean(jparams, kv_dtype, mode):
    """The JAX clean engine's greedy and sampled streams of PROMPT (one
    request at a time, a copying asarray: ROADMAP.md C3)."""
    import jax.numpy as jnp

    from seldon_tpu.models.sampling import SamplingParams as JSP
    from seldon_tpu.servers import engine as jeng
    from torch_port_helpers import _copying

    cfg = dataclasses.replace(JPRESETS["tiny"], kv_cache_dtype=kv_dtype)
    ekw = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32))
    ekw.update(MODES[mode])
    if "ragged_kernel" in ekw:
        ekw["ragged_kernel"] = "masked"
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(jparams, cfg, jeng.EngineConfig(**ekw))
        eng.start()
        try:
            return {k: eng.generate_blocking(PROMPT, JSP(**kn))["token_ids"]
                    for k, kn in KNOBS.items()}
        finally:
            eng.stop()


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_resurrection_matches_clean_across_modes(tiny_pair, mode, kv_dtype):
    """A mid-stream wave fault under heal: both live streams (greedy and
    sampled) are resurrected, and the delivered tokens equal the port's
    fault-free streams exactly, and the JAX clean engine's except at
    reported near-ties."""
    from torch_port_helpers import assert_streams_match

    jparams, tparams = tiny_pair
    cfg = _cfg(kv_dtype)
    ref = _engine(tparams, cfg, **MODES[mode])
    try:
        want = {k: ref.generate_blocking(PROMPT, SamplingParams(**kn))[
            "token_ids"] for k, kn in KNOBS.items()}
    finally:
        ref.stop()
    eng = _engine(tparams, cfg, start=False, heal=True, **MODES[mode])
    # A decode (or verify) dispatch after the admission: the fifth wave
    # of the ragged engine (three prefill chunks of 8, then decode), the
    # second dispatch of the bucketed ones.
    n = 5 if mode == "ragged" else 2
    calls = _arm_nth(eng, ChaosMonkey(ChaosConfig(seed=0,
                                                  dispatch_fail=1.0)), n=n)
    qs = {k: eng.submit(PROMPT, SamplingParams(**kn))
          for k, kn in KNOBS.items()}
    eng.start()
    try:
        got = {}
        for k, q in qs.items():
            toks, err = _collect(q)
            assert err is None, err
            got[k] = toks
        assert len(calls) >= n
        health = eng.debug_health()
        assert health["recoveries"] >= 1, "the one-shot fault never fired"
        assert health["resurrected"] >= 1
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()
    assert got == want, (got, want)
    jwant = _jax_clean(jparams, kv_dtype, mode)
    jcfg = dataclasses.replace(JPRESETS["tiny"], kv_cache_dtype=kv_dtype)
    for k, kn in KNOBS.items():
        assert_streams_match([got[k]], [jwant[k]], jparams, jcfg, [PROMPT],
                             f"{mode}/{kv_dtype}/{k}", knobs=kn,
                             seeds=[kn.get("seed", 0)])


# ---------------------------------------------------------------------------
# Quarantine, exhaustion, admission groups, watchdog, sentinel, heal off
# ---------------------------------------------------------------------------


def test_poison_bisection_isolates_sticky_culprit(tiny_pair):
    _, tparams = tiny_pair
    greedy = SamplingParams(**KNOBS["greedy"])
    ref = _engine(tparams)
    try:
        want = ref.generate_blocking(PROMPT, greedy)["token_ids"]
    finally:
        ref.stop()
    eng = _engine(tparams, heal=True, heal_max_retries=8,
                  chaos=ChaosConfig(seed=0, sticky_rid=3))
    try:
        results = [_collect(q, timeout=300)
                   for q in [eng.submit(PROMPT, greedy) for _ in range(4)]]
        for rid, (toks, err) in enumerate(results, start=1):
            if rid == 3:
                assert err is not None and err["kind"] == "poison", err
                assert err["retriable"] is False
            else:
                assert err is None, (rid, err)
                assert toks == want, f"innocent rid {rid} diverged"
        health = eng.debug_health()
        assert health["quarantined"] == 1 and health["mode"] == "normal"
        assert eng.chaos_counts()["sticky_faults"] >= 2
        assert eng.debug_lifecycle_check() == {}
        assert eng.generate_blocking(PROMPT, greedy)["token_ids"] == want
    finally:
        eng.stop()


def test_retry_budget_exhaustion_fails_cleanly(tiny_pair):
    _, tparams = tiny_pair
    greedy = SamplingParams(**KNOBS["greedy"])
    eng = _engine(tparams, heal=True, heal_max_retries=1)
    try:
        want = eng.generate_blocking(PROMPT, greedy)["token_ids"]
        # A device that faults every decode dispatch: admissions pass, so
        # each resurrection re-admits and faults again.
        mk = ChaosMonkey(ChaosConfig(seed=0, dispatch_fail=1.0))
        orig = mk.on_dispatch

        def decodes(site, rids=()):
            if site != "admit":
                orig(site, rids)

        mk.on_dispatch = decodes
        eng._chaos = mk
        q = eng.submit(PROMPT, SamplingParams(temperature=0.0,
                                              max_new_tokens=36))
        toks, err = _collect(q, timeout=300)
        assert err is not None, "an exhausted request must error, not hang"
        assert err["kind"] == "internal" and err["retriable"] is False
        assert "exhausted" in err["error"]
        health = eng.debug_health()
        assert health["retry_exhausted"] >= 1
        assert health["state"] == "degraded"
        eng._chaos = None
        assert eng.generate_blocking(PROMPT, greedy)["token_ids"] == want
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()


@pytest.mark.parametrize("mode,site", [
    ("dense", "admit"), ("paged", "admit"),
    ("chunked", "prefill-chunk"),
])
def test_admission_group_fault_requeues_without_rebuild(tiny_pair, mode,
                                                        site):
    """A fault in an admission group's dispatch: the group goes back to
    the front of the queue through the supervisor (no device rebuild,
    the epoch stays), and its streams equal the clean ones."""
    _, tparams = tiny_pair
    # The paged pool at its default size: three concurrent requests in
    # MODES["paged"]'s 9 blocks would preempt.
    ekw = {"dense": {},
           "paged": dict(paged_kv=True, kv_block=16,
                         prompt_buckets=(16, 32)),
           "chunked": dict(chunked_prefill=True, prefill_chunk=8,
                           paged_kv=True, kv_block=8, prefix_block=8),
           }[mode]
    params = [SamplingParams(**dict(KNOBS["sampled" if i % 2 else
                                          "greedy"], seed=i))
              for i in range(3)]
    ref = _engine(tparams, **ekw)
    try:
        want = [ref.generate_blocking(PROMPT[i:], p)["token_ids"]
                for i, p in enumerate(params)]
    finally:
        ref.stop()
    eng = _engine(tparams, start=False, heal=True, **ekw)
    fired = []
    mk = ChaosMonkey(ChaosConfig(seed=0, dispatch_fail=1.0))
    orig = mk.on_dispatch

    def at_site(s, rids=()):
        if s == site and not fired:
            fired.append(sorted(rids))
            orig(s, rids)

    mk.on_dispatch = at_site
    eng._chaos = mk
    qs = [eng.submit(PROMPT[i:], p) for i, p in enumerate(params)]
    eng.start()
    try:
        got = [_collect(q) for q in qs]
        assert fired, "the admission fault never fired"
        assert all(err is None for _, err in got), got
        assert [t for t, _ in got] == want
        assert eng._wave_epoch == 0  # no rebuild on the group path
        health = eng.debug_health()
        assert health["recoveries"] == 1 and health["resurrected"] >= 1
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()


@pytest.mark.parametrize("fault", ["hang", "nan"])
def test_watchdog_and_sentinel_recover_the_stream(tiny_pair, fault):
    """One fetch hang past the watchdog (500 ms; the hang 1500 ms), or
    one out-of-vocab id in a fetched boundary: the wave is declared
    faulted and resurrected, no corrupt id reaches the client, and the
    stream equals the clean one."""
    _, tparams = tiny_pair
    greedy = SamplingParams(**KNOBS["greedy"])
    ref = _engine(tparams)
    try:
        want = ref.generate_blocking(PROMPT, greedy)["token_ids"]
    finally:
        ref.stop()
    # A top bucket that holds the prompt plus what a replay folds in.
    eng = _engine(tparams, start=False, heal=True,
                  heal_watchdog_ms=500 if fault == "hang" else 0,
                  prompt_buckets=(8, 32, 64))
    # The third boundary fetch: the stream has delivered tokens.
    if fault == "hang":
        _arm_nth(eng, ChaosMonkey(ChaosConfig(seed=0, hang=1.0,
                                              hang_ms=1500)),
                 "maybe_hang", n=3)
    else:
        _arm_nth(eng, ChaosMonkey(ChaosConfig(seed=0, nan_inject=1.0)),
                 "poison_fetch", n=3)
    q = eng.submit(PROMPT, greedy)
    eng.start()
    try:
        got, err = _collect(q)
        assert err is None, err
        health = eng.debug_health()
        key = "watchdog_trips" if fault == "hang" else "sentinel_trips"
        assert health[key] >= 1 and health["recoveries"] >= 1
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()
    assert got == want
    assert all(0 <= t < TPRESETS["tiny"].vocab_size for t in got)


@pytest.mark.parametrize("async_fetch", [True, False])
def test_heal_off_keeps_the_raw_failure_path(tiny_pair, monkeypatch,
                                             async_fetch):
    """Without heal, a wrecked wave fails every live stream with a
    retriable internal error and rebuilds the device state; the engine
    then serves the clean stream again."""
    monkeypatch.delenv("HEAL", raising=False)
    _, tparams = tiny_pair
    greedy = SamplingParams(**KNOBS["greedy"])
    eng = _engine(tparams, async_fetch=async_fetch, **MODES["ragged"])
    try:
        want = eng.generate_blocking(PROMPT, greedy)["token_ids"]
        mk = ChaosMonkey(ChaosConfig(seed=0, dispatch_fail=1.0))
        calls = []
        orig = mk.on_dispatch

        def nth(site, rids=()):
            calls.append(site)
            if len(calls) == 6:
                eng._chaos = None
                orig(site, rids)

        mk.on_dispatch = nth
        with eng._book:
            q = eng.submit(PROMPT, greedy)
            eng._chaos = mk
        toks, err = _collect(q)
        assert err is not None and err["kind"] == "internal"
        assert err["retriable"] is True
        assert eng._wave_epoch >= 1
        assert eng.generate_blocking(PROMPT, greedy)["token_ids"] == want
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()


@pytest.mark.parametrize("async_fetch", [False, True])
def test_storm_streams_equal_clean_except_c15_convictions(tiny_pair,
                                                         async_fetch):
    """The heal audit's storm (seed 17: dispatch faults, slow and hung
    fetches, poisoned ids) on the ragged kernel leg: every stream the
    supervisor did not fail equals the clean engine's. With no poison
    source armed, a failure is the storm's doing on this engine (one
    dispatch per token; ROADMAP.md C15, the JAX engine does the same): a
    quarantined innocent (kind "poison") or a spent retry budget; the
    supervisor's counters account for each, and what such a request
    delivered is a prefix of its clean stream."""
    _, tparams = tiny_pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 256, size=(n,)).tolist()
               for n in (12, 26, 7, 30, 16, 3, 20, 9)]
    params = [SamplingParams(seed=i, temperature=0.0 if i % 2 == 0 else 0.8,
                             top_k=20, max_new_tokens=24)
              for i in range(len(prompts))]
    ekw = dict(MODES["ragged"], max_seq_len=96, prompt_buckets=(16, 32, 64),
               async_fetch=async_fetch)

    def run(**extra):
        eng = _engine(tparams, start=False, **ekw, **extra)
        qs = [eng.submit(p, sp) for p, sp in zip(prompts, params)]
        eng.start()
        try:
            return [_collect(q) for q in qs], eng
        finally:
            eng.stop()

    clean, _ = run()
    storm = ChaosConfig(seed=17, dispatch_fail=0.05, slow_boundary=0.05,
                        slow_ms=2, hang=0.02, hang_ms=1500, nan_inject=0.02)
    healed, eng = run(heal=True, heal_max_retries=6, heal_watchdog_ms=1000,
                      chaos=storm)
    verdicts = {"poison": 0, "exhausted": 0}
    for (want, _), (got, err) in zip(clean, healed):
        if err is None:
            assert got == want
            continue
        assert not err["retriable"], err
        if err["kind"] == "poison":
            verdicts["poison"] += 1
        else:
            assert err["kind"] == "internal", err
            assert err["error"].startswith("resurrection budget exhausted")
            verdicts["exhausted"] += 1
        assert got == want[:len(got)]
    health = eng.debug_health()
    assert health["quarantined"] == verdicts["poison"]
    assert health["retry_exhausted"] == verdicts["exhausted"]
    assert health["recoveries"] >= 1 and health["resurrected"] >= 1
    assert eng.chaos_counts()["dispatch_faults"] >= 1
    assert eng.debug_lifecycle_check() == {}
    if any(verdicts.values()):
        print(f"C15: supervisor verdicts {verdicts} under the storm "
              f"(async_fetch={async_fetch})")


def test_heal_tick_reaps_a_cancel_in_the_pen(tiny_pair):
    _, tparams = tiny_pair
    eng = _engine(tparams, start=False, heal=True, **MODES["ragged"])
    req = teng._Request(7, list(PROMPT), SamplingParams(), queue.Queue(),
                        time.perf_counter())
    with eng._rid_lock:
        eng._requests[7] = req
    eng._heal.plan_recovery([7], 0.0)
    eng._heal.plan_recovery([7], 0.0)  # a repeat: the pen
    eng._heal.pen_put(req, time.perf_counter())
    req.cancelled = True
    with eng._book:
        eng._heal_tick()
    assert eng._heal.pen_empty()
    assert eng.stats.snapshot()["cancelled_total"] == 1
    assert req.out.get_nowait()["kind"] == "cancelled"
    assert eng.debug_lifecycle_check() == {}
