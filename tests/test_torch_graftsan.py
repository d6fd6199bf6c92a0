"""The port's runtime sanitizer (seldon_tpu_torch/servers/graftsan.py and
lock_order.py) against the JAX package's, and on the port's engine.

 * the lock table equals the JAX package's, edge for edge;
 * the twins of tests/test_graftsan.py: the same scripted lock sequences
   give the same violation kinds and invariant messages in both packages;
   the ``perturb`` sleep sequences are equal for a seed; the refcount and
   slot audits catch the same injected leak, double free and free-list
   corruption on the port's engine, which stays healthy once the damage
   is reverted;
 * with the sanitizer armed the port's streams equal its own streams with
   it off, on every engine family (ragged masked and kernel legs,
   bucketed dense, paged and chunked, spec), and a mixed soak ends with
   zero violations, no hung waiter and a clean lifecycle audit.

The JAX engine's own on/off twin is not an oracle here (its ``[dense]``
case has failed in full-suite runs: ROADMAP.md, "Reference red
tests")."""

import queue
import random
import threading
import time

import numpy as np
import pytest
import torch

from seldon_tpu.servers import graftsan as jsan
from seldon_tpu.servers import lock_order as jlo
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import PRESETS
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers import graftsan
from seldon_tpu_torch.servers import lock_order
from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine
from seldon_tpu_torch.servers.graftsan import (GraftsanViolation, Sanitizer,
                                               TerminalQueue)
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)

PROMPT = list(range(2, 26))
GREEDY = SamplingParams(temperature=0.0, max_new_tokens=8)

PAGED = dict(paged_kv=True, kv_block=16, kv_pool_blocks=12,
             prompt_buckets=(16, 32))
CHUNKED = dict(chunked_prefill=True, prefill_chunk=8, prefix_block=8)
RAGGED = dict(ragged=True, paged_kv=True, chunked_prefill=True,
              kv_block=8, kv_pool_blocks=4 * 8 + 1, prefill_chunk=16,
              prefix_block=8,
              prompt_buckets=(16, 32))
FAMILIES = {
    "ragged_masked": dict(RAGGED, ragged_kernel="masked"),
    "ragged_kernel": dict(RAGGED, ragged_kernel="pallas"),
    "dense": {},
    "paged": PAGED,
    "chunked": CHUNKED,
    "spec": dict(PAGED, spec_decode=True, spec_k=4, ragged_kernel="pallas"),
}


@pytest.fixture(scope="module")
def tiny_params():
    cfg = PRESETS["tiny"]
    gen = torch.Generator().manual_seed(0)
    return transformer.init_params(cfg, gen, torch.device("cpu")), cfg


def _engine(tiny_params, start=True, **ekw):
    params, cfg = tiny_params
    ekw.setdefault("max_slots", 4)
    ekw.setdefault("max_seq_len", 64)
    ekw.setdefault("prompt_buckets", (8, 32))
    eng = InferenceEngine(params, cfg, EngineConfig(**ekw), device="cpu")
    if start:
        eng.start()
    return eng


@pytest.fixture
def san_env(monkeypatch):
    monkeypatch.setenv("GRAFTSAN", "1")
    monkeypatch.setenv("GRAFTSAN_SEED", "0")


def _both(script):
    """Run a scripted lock sequence on a fresh sanitizer of each package;
    -> [(kind, message)] of each, port first."""
    out = []
    for mod in (graftsan, jsan):
        san = mod.Sanitizer()
        try:
            script(mod, san)
        except mod.GraftsanViolation:
            pass
        out.append([(v.kind, v.message) for v in san.violations])
    return out


# ---------------------------------------------------------------------------
# The lock table
# ---------------------------------------------------------------------------


def test_lock_table_equals_jax():
    assert lock_order.LOCK_RANK == jlo.LOCK_RANK
    assert lock_order.LEAF_LOCKS == jlo.LEAF_LOCKS
    assert lock_order.CANONICAL_ATTRS == jlo.CANONICAL_ATTRS
    names = sorted(jlo.LOCK_RANK) + ["Other.lock", "Engine._jit_lock"]
    for held in names:
        for acq in names:
            assert (lock_order.edge_violation(held, acq)
                    == jlo.edge_violation(held, acq)), (held, acq)
    for cls, attr in list(jlo.CANONICAL_ATTRS) + [("X", "_y")]:
        assert (lock_order.canonical_name(cls, attr)
                == jlo.canonical_name(cls, attr))


def test_port_lock_owners_carry_the_table_names(tiny_params):
    """Every row of CANONICAL_ATTRS names a lock the port's engine owns."""
    from seldon_tpu_torch.servers import block_pool, chaos, prefix_cache
    from seldon_tpu_torch.servers import engine as teng

    eng = _engine(tiny_params, start=False, prefix_cache=True,
                  chaos=chaos.ChaosConfig(seed=1, dispatch_fail=0.01),
                  **RAGGED)
    owners = {"InferenceEngine": eng, "EngineStats": eng.stats,
              "BlockAllocator": eng._allocator, "ChaosMonkey": eng._chaos,
              "PagedPrefixIndex": eng._paged_prefix,
              "PrefixIndex": prefix_cache.PrefixIndex(block=8)}
    classes = {"InferenceEngine": teng.InferenceEngine,
               "EngineStats": teng.EngineStats,
               "BlockAllocator": block_pool.BlockAllocator,
               "ChaosMonkey": chaos.ChaosMonkey,
               "PagedPrefixIndex": prefix_cache.PagedPrefixIndex,
               "PrefixIndex": prefix_cache.PrefixIndex}
    for cls, attr in lock_order.CANONICAL_ATTRS:
        assert isinstance(owners[cls], classes[cls])
        assert hasattr(getattr(owners[cls], attr), "acquire"), (cls, attr)


# ---------------------------------------------------------------------------
# Gating + zero overhead when off
# ---------------------------------------------------------------------------


def test_from_env_gate(monkeypatch):
    monkeypatch.delenv("GRAFTSAN", raising=False)
    assert Sanitizer.from_env() is None
    monkeypatch.setenv("GRAFTSAN", "0")
    assert Sanitizer.from_env() is None
    monkeypatch.setenv("GRAFTSAN", "1")
    monkeypatch.setenv("GRAFTSAN_SEED", "7")
    san = Sanitizer.from_env()
    assert san is not None and san.seed == 7
    assert jsan.Sanitizer.from_env().seed == san.seed


def test_zero_overhead_when_unset(monkeypatch, tiny_params):
    monkeypatch.delenv("GRAFTSAN", raising=False)
    eng = _engine(tiny_params, start=False)
    assert eng._san is None
    assert not isinstance(eng._book, graftsan._OrderedLock)
    assert not isinstance(eng._rid_lock, graftsan._OrderedLock)
    assert not isinstance(eng.stats.lock, graftsan._OrderedLock)
    q = eng.submit(PROMPT, GREEDY)
    assert type(q) is queue.Queue  # not TerminalQueue


def test_instrumented_engine_structures(san_env, tiny_params):
    eng = _engine(tiny_params, start=False, **PAGED)
    assert isinstance(eng._san, Sanitizer)
    assert isinstance(eng._book, graftsan._OrderedLock)
    assert isinstance(eng._rid_lock, graftsan._OrderedLock)
    assert isinstance(eng.stats.lock, graftsan._OrderedLock)
    assert isinstance(eng._allocator._lock, graftsan._OrderedLock)
    q = eng.submit(PROMPT, GREEDY)
    assert isinstance(q, TerminalQueue)


# ---------------------------------------------------------------------------
# Lock-order witness: the same scripts, the same verdicts in both packages
# ---------------------------------------------------------------------------


def test_documented_order_is_silent():
    def script(mod, san):
        book = san.wrap_lock(threading.Lock(), "_book")
        rid = san.wrap_lock(threading.Lock(), "_rid_lock")
        trie = san.wrap_lock(threading.Lock(), "trie._lock")
        alloc = san.wrap_lock(threading.Lock(), "allocator._lock")
        with book:
            with rid:
                pass
            with trie:
                with alloc:
                    pass

    port, ref = _both(script)
    assert port == ref == []


def test_order_witness_two_stack_report():
    san = Sanitizer()
    book = san.wrap_lock(threading.Lock(), "_book")
    stats = san.wrap_lock(threading.Lock(), "stats.lock")
    with stats:  # leaf held: acquiring ANYTHING under it is a violation
        with pytest.raises(GraftsanViolation) as ei:
            with book:
                pass
    v = ei.value.violation
    assert v.kind == "lock-order"
    assert "'_book'" in v.message and "'stats.lock'" in v.message
    assert "leaf" in v.message
    assert v.stack and v.other_stack  # both participating sites captured
    assert san.violations == [v]
    rendered = ei.value.args[0]
    assert "detected at" in rendered and "conflicting event" in rendered

    def script(mod, san):
        book = san.wrap_lock(threading.Lock(), "_book")
        stats = san.wrap_lock(threading.Lock(), "stats.lock")
        with stats:
            with book:
                pass

    port, ref = _both(script)
    assert port == ref == [(v.kind, v.message)]


def test_order_witness_rank_inversion():
    def script(mod, san):
        book = san.wrap_lock(threading.Lock(), "_book")
        trie = san.wrap_lock(threading.Lock(), "trie._lock")
        with trie:
            with book:
                pass

    port, ref = _both(script)
    assert port == ref and len(port) == 1
    assert port[0][0] == "lock-order" and "inverts" in port[0][1]


def test_reacquisition_self_deadlock():
    def script(mod, san):
        book = san.wrap_lock(threading.Lock(), "_book")
        with book:
            book.acquire()

    port, ref = _both(script)
    assert port == ref and len(port) == 1
    assert "self-deadlock" in port[0][1]


def test_rlock_reentry_is_legal():
    def script(mod, san):
        lk = san.wrap_lock(threading.RLock(), "Engine._jit_lock")
        with lk:
            with lk:
                pass

    port, ref = _both(script)
    assert port == ref == []


def test_wrap_lock_is_idempotent():
    san = Sanitizer()
    lk = san.wrap_lock(threading.Lock(), "_book")
    assert san.wrap_lock(lk, "_book") is lk


def test_assert_holds():
    san = Sanitizer()
    book = san.wrap_lock(threading.Lock(), "_book")
    with book:
        san.assert_holds("_book")  # satisfied, silent
    with pytest.raises(GraftsanViolation) as ei:
        san.assert_holds("_book")
    assert ei.value.violation.kind == "holds"

    def script(mod, san):
        book = san.wrap_lock(threading.Lock(), "_book")
        with book:
            san.assert_holds("_book")
        rid = san.wrap_lock(threading.Lock(), "_rid_lock")
        with rid:
            san.assert_holds("_book")

    port, ref = _both(script)
    assert port == ref and [k for k, _ in port] == ["holds"]


def test_held_stacks_are_per_thread():
    san = Sanitizer()
    book = san.wrap_lock(threading.Lock(), "_book")
    stats = san.wrap_lock(threading.Lock(), "stats.lock")
    errs = []

    def other():
        # This thread holds nothing: taking _book here is clean even
        # while the main thread holds the leaf.
        try:
            with book:
                pass
        except GraftsanViolation as e:  # pragma: no cover
            errs.append(e)

    with stats:
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and errs == []
    assert san.violations == []


# ---------------------------------------------------------------------------
# Terminal-item protocol
# ---------------------------------------------------------------------------


def test_terminal_queue_rejects_items_after_sentinel():
    def script(mod, san):
        q = mod.TerminalQueue(san)
        q.put({"tokens": [1]})
        q.put(None)
        for item in ({"tokens": [2]}, None):
            try:
                q.put(item)
            except mod.GraftsanViolation:
                pass

    port, ref = _both(script)
    assert port == ref and [k for k, _ in port] == ["terminal", "terminal"]
    assert "second terminal" in port[1][1]
    san = Sanitizer()
    q = TerminalQueue(san)
    q.put(None)
    with pytest.raises(GraftsanViolation) as ei:
        q.put({"tokens": [2]})
    assert ei.value.violation.other_stack  # where the sentinel was put


# ---------------------------------------------------------------------------
# Boundary audits with injected damage, on the port's engine
# ---------------------------------------------------------------------------


def test_slot_audit_catches_free_list_corruption(san_env, tiny_params):
    eng = _engine(tiny_params)
    try:
        eng.generate_blocking(PROMPT, GREEDY)
        with eng._book:
            eng._san.audit(eng)  # quiescent engine: clean
            eng._free.append(eng._free[0])  # inject a duplicate entry
            with pytest.raises(GraftsanViolation) as ei:
                eng._san.audit(eng)
            assert ei.value.violation.kind == "slot-audit"
            eng._free.pop()
            eng._san.violations.clear()
        eng.generate_blocking(PROMPT, GREEDY)  # engine still healthy
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()
    assert eng._san.violations == []


def test_refcount_audit_catches_injected_leak(san_env, tiny_params):
    eng = _engine(tiny_params, **PAGED)
    try:
        eng.generate_blocking(PROMPT, GREEDY)
        with eng._book:
            eng._san.audit(eng)
            # A ref the live tables know nothing about = leaked block.
            eng._allocator._refs[9999] = 1
            with pytest.raises(GraftsanViolation) as ei:
                eng._san.audit(eng)
            v = ei.value.violation
            assert v.kind == "refcount" and "leak" in v.message
            assert "{9999: 1}" in v.message
            del eng._allocator._refs[9999]
            eng._san.violations.clear()
        eng.generate_blocking(PROMPT, GREEDY)
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()
    assert eng._san.violations == []


def test_refcount_audit_catches_injected_double_free(san_env, tiny_params):
    eng = _engine(tiny_params, **PAGED)
    try:
        q = eng.submit(PROMPT, SamplingParams(
            temperature=0.0, max_new_tokens=32))
        # Catch the request mid-decode: poll under _book until it is
        # admitted and owns blocks, then tamper + audit in the SAME
        # _book hold so it cannot complete underneath us.
        deadline = time.monotonic() + 120
        caught = False
        while not caught and time.monotonic() < deadline:
            with eng._book:
                with eng._rid_lock:
                    reqs = list(eng._requests.values())
                if reqs and reqs[0].block_ids:
                    caught = True
                    req = reqs[0]
                    # A table ref the allocator never granted = double
                    # free waiting to happen on release.
                    req.block_ids.append(7777)
                    with pytest.raises(GraftsanViolation) as ei:
                        eng._san.audit(eng)
                    v = ei.value.violation
                    assert v.kind == "refcount"
                    assert "double free" in v.message
                    assert "{7777: 1}" in v.message
                    req.block_ids.pop()
                    eng._san.violations.clear()
            if not caught:
                time.sleep(0.005)
        assert caught, "request never observed mid-decode"
        while q.get(timeout=120) is not None:
            pass
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()
    assert eng._san.violations == []


def test_table_audit_catches_a_foreign_block(san_env, tiny_params):
    """A live slot's table row naming a block its request does not own:
    the audit's last check (the JAX audit's own message)."""
    eng = _engine(tiny_params, start=False, **PAGED)
    q = eng.submit(PROMPT, SamplingParams(temperature=0.0,
                                          max_new_tokens=32))
    eng.start()
    try:
        deadline = time.monotonic() + 120
        caught = None
        while caught is None and time.monotonic() < deadline:
            with eng._book:
                live = [i for i, r in enumerate(eng._slots)
                        if r is not None and r.block_ids]
                if live:
                    i = live[0]
                    saved = int(eng._table_host[i, 0])
                    foreign = max(eng._allocator.refs_snapshot()) + 1
                    eng._table_host[i, 0] = foreign
                    with pytest.raises(GraftsanViolation) as ei:
                        eng._san.audit(eng)
                    eng._table_host[i, 0] = saved
                    eng._san.violations.clear()
                    caught = ei.value.violation
            time.sleep(0.005)
        assert caught is not None, "request never observed mid-decode"
        v = caught
        assert v.kind == "refcount" and f"[{foreign}]" in v.message
        while q.get(timeout=120) is not None:
            pass
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()


# ---------------------------------------------------------------------------
# Determinism: perturbation streams + streams with the sanitizer on and off
# ---------------------------------------------------------------------------


def test_perturb_streams_split_and_deterministic(monkeypatch):
    a, b = Sanitizer(seed=3), Sanitizer(seed=3)
    for _ in range(50):
        a.perturb("dispatch")
        a.perturb("reap")
        b.perturb("dispatch")
        b.perturb("reap")
    assert a._sched_rng.random() == b._sched_rng.random()
    c, d = Sanitizer(seed=3), Sanitizer(seed=3)
    for _ in range(50):
        c.perturb("boundary")
    assert c._sched_rng.random() == d._sched_rng.random()
    assert c._fetch_rng.random() != d._fetch_rng.random()

    # The sleeps the JAX sanitizer takes on a site sequence, taken by the
    # port's for the same seed.
    slept = []
    monkeypatch.setattr(time, "sleep", slept.append)
    sites = random.Random(11).choices(("dispatch", "reap", "boundary"),
                                      k=400)
    got = {}
    for name, mod in (("port", graftsan), ("jax", jsan)):
        slept.clear()
        san = mod.Sanitizer(seed=5)
        for site in sites:
            san.perturb(site)
        got[name] = list(slept)
    assert got["port"] == got["jax"] and got["port"]


def _stream(eng, prompt, params):
    toks = []
    q = eng.submit(prompt, params)
    while True:
        item = q.get(timeout=120)
        if item is None:
            return toks
        assert "error" not in item, item
        toks.extend(item["tokens"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_streams_equal_with_sanitizer_on_and_off(family, monkeypatch,
                                                 tiny_params):
    """The port's own streams with the sanitizer off are the oracle: the
    seeded sleeps move thread interleavings, never a token."""
    ekw = FAMILIES[family]
    vocab = tiny_params[1].vocab_size
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, vocab, size=(n,)).tolist()
               for n in (24, 7, 13, 30)]
    knobs = [GREEDY, SamplingParams(temperature=0.8, top_k=20,
                                    max_new_tokens=8, seed=5)] * 2
    got = {}
    for armed in (False, True):
        if armed:
            monkeypatch.setenv("GRAFTSAN", "1")
            monkeypatch.setenv("GRAFTSAN_SEED", "0")
        else:
            monkeypatch.delenv("GRAFTSAN", raising=False)
        eng = _engine(tiny_params, start=False, **ekw)
        eng.start()
        try:
            got[armed] = [_stream(eng, p, k) for p, k in zip(prompts, knobs)]
        finally:
            eng.stop()
        assert eng.debug_lifecycle_check() == {}
        if armed:
            assert eng._san is not None
            assert eng._san.violations == []
            assert eng._san.audits > 0  # the boundary audit actually ran
        else:
            assert eng._san is None
    assert got[True] == got[False]
    assert all(got[False])


# ---------------------------------------------------------------------------
# Soak: mixed traffic under the sanitizer
# ---------------------------------------------------------------------------


def _run_soak(eng, n, seed, cancel_frac=0.1):
    """Submit n requests (sizes drawn main-thread from a fixed seed so
    a run replays exactly), consume each from its own waiter thread,
    cancel a fraction mid-stream. Returns (finished, hung)."""
    rng = random.Random(seed)
    threads = []

    def consume(q, want_cancel):
        sent = False
        while True:
            item = q.get(timeout=300)
            if item is None:
                return
            if want_cancel and not sent and "error" not in item:
                sent = True
                eng.cancel(q.rid)

    for i in range(n):
        plen = rng.choice((5, 8, 13, 21))
        prompt = [2 + (i + j) % 200 for j in range(plen)]
        sp = SamplingParams(temperature=0.0,
                            max_new_tokens=rng.choice((4, 8)))
        want_cancel = rng.random() < cancel_frac
        try:
            q = eng.submit(prompt, sp)
        except RuntimeError:  # shed under load: an outcome, not a hang
            continue
        t = threading.Thread(target=consume, args=(q, want_cancel),
                             daemon=True)
        t.start()
        threads.append(t)

    stop_by = time.monotonic() + 120
    hung = 0
    for t in threads:
        t.join(timeout=max(0.0, stop_by - time.monotonic()))
        if t.is_alive():
            hung += 1
    return len(threads), hung


@pytest.mark.parametrize("family", ["ragged_kernel", "paged", "chunked"])
def test_graftsan_soak_mixed(family, monkeypatch, tiny_params):
    """The JAX soak's contract at a tier-1 size: the witness and audits
    stay silent on the real engine, every waiter sees a sentinel, nothing
    leaks."""
    monkeypatch.setenv("GRAFTSAN", "1")
    monkeypatch.setenv("GRAFTSAN_SEED", "0")
    n = 24
    eng = _engine(tiny_params, max_slots=8, max_queue=4 * n,
                  **FAMILIES[family])
    try:
        finished, hung = _run_soak(eng, n, seed=0)
        assert hung == 0, f"{hung} waiters never saw a sentinel"
        assert finished > 0
        assert eng.drain(timeout=120) is True
        assert eng._san.audits > 0
        assert eng._san.violations == [], [
            v.render() for v in eng._san.violations]
        assert eng.debug_lifecycle_check() == {}
    finally:
        eng.stop()
