"""graftsan: env-gated runtime concurrency sanitizer for the engine — port
of ``seldon_tpu/servers/graftsan.py``, line for line.

It checks the canonical lock table (`seldon_tpu_torch.servers.lock_order`,
equal to the JAX package's) at run time: orders taken through callbacks,
state shared across the scheduler/fetcher boundary, refcount drift
between the allocator, the prefix trie, and live block tables.

Enabled by ``GRAFTSAN=1`` (never a config field, so manifests cannot
ship it by accident).  When the gate is off, :func:`instrument` returns
None and the engine keeps raw ``threading`` primitives — zero
added code on any hot path.  When on:

 * every engine lock is wrapped in an order-asserting proxy; an
   acquisition that breaks the documented order raises (and records) a
   :class:`GraftsanViolation` carrying TWO stacks — where the held lock
   was taken and where the violating acquisition happened;
 * ``# graftlint: holds(<lock>)`` contracts become runtime asserts via
   :meth:`Sanitizer.assert_holds`;
 * at every scheduler boundary :meth:`Sanitizer.audit` cross-checks the
   block allocator's refcounts against the live request block tables
   plus the paged prefix trie's pins, and the slot array against the
   free list;
 * each response queue enforces the terminal-item protocol (exactly one
   ``None`` sentinel, nothing after it);
 * a seeded interleaving explorer (``GRAFTSAN_SEED``, same
   scheduler/fetcher RNG-split discipline as `chaos.ChaosMonkey`)
   injects tiny sleeps at the chaos hook sites to widen race windows
   deterministically.  The sleeps are timing-only — no scheduling
   decision reads the draws — so greedy token output stays
   bit-identical with the sanitizer on or off.

A violation report names the invariant and both participating call
sites. The port's engine calls it at the JAX engine's sites, on every
engine family (ragged, bucketed paged / dense / chunked, spec).
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import random
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from seldon_tpu_torch.servers.lock_order import edge_violation

_RLOCK_TYPE = type(threading.RLock())


def _stack(skip: int = 2) -> str:
    """Formatted stack of the caller, minus graftsan's own frames."""
    return "".join(traceback.format_stack()[:-skip])


@dataclasses.dataclass
class Violation:
    kind: str  # lock-order | holds | refcount | slot-audit | terminal
    message: str
    stack: str  # where the violation was detected
    other_stack: str = ""  # the conflicting earlier event, when known

    def render(self) -> str:
        out = [f"graftsan [{self.kind}] {self.message}",
               "--- detected at:", self.stack.rstrip()]
        if self.other_stack:
            out += ["--- conflicting event at:", self.other_stack.rstrip()]
        return "\n".join(out)


class GraftsanViolation(AssertionError):
    """Raised at the violating call site; also recorded on the
    sanitizer so soaks can assert a clean run even when the engine's
    failure paths swallow the raise into `_fail_all`."""

    def __init__(self, violation: Violation):
        super().__init__(violation.render())
        self.violation = violation


@dataclasses.dataclass
class _Held:
    name: str
    proxy: "_OrderedLock"
    stack: str


class _OrderedLock:
    """Order-asserting proxy around a ``threading`` lock.  Supports the
    subset of the lock protocol the engine uses (``with``, explicit
    acquire/release, ``locked()``); everything else delegates to the
    wrapped primitive."""

    def __init__(self, san: "Sanitizer", inner: Any, name: str):
        self._san = san
        self._inner = inner
        self.name = name
        self._reentrant = isinstance(inner, _RLOCK_TYPE)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._san._check_acquire(self)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._san._note_acquired(self)
        return got

    def release(self) -> None:
        self._inner.release()
        self._san._note_released(self)

    def __enter__(self) -> "_OrderedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()


class TerminalQueue(queue.Queue):
    """Response queue asserting the engine's terminal-item protocol:
    exactly one ``None`` sentinel per request, and nothing — token
    burst, error item, or second sentinel — after it.  A violation
    reports both the original sentinel's put site and the late put."""

    def __init__(self, san: "Sanitizer"):
        super().__init__()
        self._san = san
        self._tlock = threading.Lock()  # meta-lock, deliberately raw
        self._terminal_stack: Optional[str] = None

    def put(self, item: Any, *args: Any, **kwargs: Any) -> None:
        with self._tlock:
            if self._terminal_stack is not None:
                what = ("second terminal sentinel" if item is None
                        else f"item {item!r}")
                self._san._fail(Violation(
                    "terminal",
                    f"{what} put after the response stream was already "
                    "terminated",
                    _stack(), self._terminal_stack))
            if item is None:
                self._terminal_stack = _stack()
        super().put(item, *args, **kwargs)


class Sanitizer:
    """One per engine; owns the per-thread held-lock stacks, the
    violation log, and the seeded perturbation RNGs."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._tls = threading.local()
        self._vlock = threading.Lock()  # meta-lock, deliberately raw
        self.violations: List[Violation] = []
        # Same split discipline as chaos.ChaosMonkey: scheduler-side
        # draws and fetcher-side draws come from independent streams so
        # sleeping one thread never perturbs the other's sequence.
        self._sched_rng = random.Random(seed)
        self._fetch_rng = random.Random(seed + 1)
        self.audits = 0

    @classmethod
    def from_env(cls) -> Optional["Sanitizer"]:
        if os.environ.get("GRAFTSAN", "0") not in ("1", "true", "yes"):
            return None
        return cls(seed=int(os.environ.get("GRAFTSAN_SEED", "0") or 0))

    # --- lock-order witness -------------------------------------------------

    def wrap_lock(self, lock: Any, name: str) -> _OrderedLock:
        if isinstance(lock, _OrderedLock):
            return lock  # already instrumented (e.g. shared allocator)
        return _OrderedLock(self, lock, name)

    def _held(self) -> List[_Held]:
        st = getattr(self._tls, "held", None)
        if st is None:
            st = self._tls.held = []
        return st

    def _check_acquire(self, proxy: _OrderedLock) -> None:
        held = self._held()
        for h in reversed(held):
            if h.proxy is proxy:
                if proxy._reentrant:
                    return  # legal re-entry
                self._fail(Violation(
                    "lock-order",
                    f"re-acquisition of non-reentrant lock "
                    f"'{proxy.name}' (self-deadlock)",
                    _stack(), h.stack))
        for h in held:
            reason = edge_violation(h.name, proxy.name)
            if reason:
                self._fail(Violation(
                    "lock-order",
                    f"acquiring '{proxy.name}' while holding "
                    f"'{h.name}': {reason}",
                    _stack(), h.stack))

    def _note_acquired(self, proxy: _OrderedLock) -> None:
        self._held().append(_Held(proxy.name, proxy, _stack()))

    def _note_released(self, proxy: _OrderedLock) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i].proxy is proxy:
                del held[i]
                return
        # Released a lock acquired before instrumentation — harmless.

    def assert_holds(self, name: str) -> None:
        """Runtime half of the ``# graftlint: holds(<lock>)`` contract:
        the static pass proves annotated call sites it can see; this
        catches the ones it cannot (callbacks, tests poking privates)."""
        held = self._held()
        if any(h.name == name for h in held):
            return
        self._fail(Violation(
            "holds",
            f"method documented `holds({name})` entered without "
            f"'{name}' held (held: "
            f"{[h.name for h in held] or 'nothing'})",
            _stack()))

    def _fail(self, v: Violation) -> None:
        with self._vlock:
            self.violations.append(v)
        raise GraftsanViolation(v)

    # --- structural audits (caller holds _book) -----------------------------

    def audit(self, engine: Any) -> None:  # graftlint: allow(lock-guard) cross-object audit runs under _book by contract — asserted at entry below
        """Boundary-time cross-structure audit.  The caller holds
        ``_book``, so every structure below is quiescent: the slot array
        must mirror the free list, and (paged engines) every allocator
        refcount must equal live-request table references plus prefix
        trie pins — drift in either direction is a leak or a
        double-free in the making."""
        self.assert_holds("_book")
        self.audits += 1
        occupied = {
            i for i, r in enumerate(engine._slots) if r is not None
        }
        free = engine._free
        B = len(engine._slots)
        if occupied.intersection(free) or len(free) + len(occupied) != B \
                or len(set(free)) != len(free):
            self._fail(Violation(
                "slot-audit",
                f"slot array / free list incoherent: occupied="
                f"{sorted(occupied)} free={sorted(free)} max_slots={B}",
                _stack()))
        if not getattr(engine, "_paged", False):
            return
        expected: collections.Counter = collections.Counter()
        with engine._rid_lock:
            reqs = list(engine._requests.values())
        for r in reqs:
            expected.update(r.block_ids)
        trie = engine._paged_prefix
        if trie is not None:
            expected.update(trie.block_refs())
        actual = engine._allocator.refs_snapshot()
        if dict(expected) != actual:
            leaked = {b: c for b, c in actual.items()
                      if c != expected.get(b, 0) and c > expected.get(b, 0)}
            lost = {b: c for b, c in expected.items()
                    if c != actual.get(b, 0) and c > actual.get(b, 0)}
            self._fail(Violation(
                "refcount",
                "allocator refcounts diverge from live block tables + "
                f"trie pins: over-refed (leak) {leaked or '{}'}, "
                f"under-refed (double free) {lost or '{}'}",
                _stack()))
        # Every non-trash entry a live slot's table row points at must
        # be a block that slot's request actually owns a ref on.
        for i in occupied:
            r = engine._slots[i]
            if not r.block_ids:
                continue
            row = {int(b) for b in engine._table_host[i]} - {0}
            extra = row - set(r.block_ids)
            if extra:
                self._fail(Violation(
                    "refcount",
                    f"slot {i} block table references blocks "
                    f"{sorted(extra)} not owned by request "
                    f"{r.rid} (owned: {sorted(r.block_ids)})",
                    _stack()))

    # --- seeded interleaving explorer ---------------------------------------

    def perturb(self, site: str) -> None:
        """Tiny seeded sleep at a chaos hook site (``dispatch`` /
        ``reap`` on the scheduler thread, ``boundary`` on the fetcher).
        Deterministic per (seed, site sequence); timing-only, so token
        output is unchanged — only thread interleavings move."""
        rng = self._fetch_rng if site == "boundary" else self._sched_rng
        r = rng.random()
        if r < 0.25:
            time.sleep(r * 0.004)  # 0-1 ms, enough to swap a race

    def check(self) -> None:
        """Raise the first recorded violation, if any (soak epilogue)."""
        with self._vlock:
            if self.violations:
                raise GraftsanViolation(self.violations[0])


# --- engine instrumentation --------------------------------------------------

def instrument(engine: Any) -> Optional[Sanitizer]:
    """Wrap an engine's locks and return its Sanitizer, or None when
    GRAFTSAN is off.  Called once at the end of ``__init__``; the lock
    attributes are rebound in place, so every ``with self._book:`` in
    the engine goes through the proxy with no call-site changes."""
    san = Sanitizer.from_env()
    if san is None:
        return None
    engine._book = san.wrap_lock(engine._book, "_book")
    engine._rid_lock = san.wrap_lock(engine._rid_lock, "_rid_lock")
    engine.stats.lock = san.wrap_lock(engine.stats.lock, "stats.lock")
    if engine._chaos is not None:
        engine._chaos._lock = san.wrap_lock(
            engine._chaos._lock, "chaos._lock"
        )
    if engine._prefix is not None:
        engine._prefix._lock = san.wrap_lock(
            engine._prefix._lock, "trie._lock"
        )
    rewrap_pool(engine, san)
    return san


def rewrap_pool(engine: Any, san: Sanitizer) -> None:
    """(Re-)wrap the pool-side locks.  ``_fail_all`` rebuilds the
    allocator and the paged prefix trie wholesale after a wrecked
    dispatch; the fresh objects carry fresh raw locks, so the rebuild
    path calls this again to keep them witnessed.  The port's rebuild
    also makes the dense engine's trie afresh (the JAX engine keeps its
    old one), so its lock is re-wrapped here too."""
    if getattr(engine, "_prefix", None) is not None:
        engine._prefix._lock = san.wrap_lock(
            engine._prefix._lock, "trie._lock"
        )
    if getattr(engine, "_allocator", None) is not None:
        engine._allocator._lock = san.wrap_lock(
            engine._allocator._lock, "allocator._lock"
        )
    if getattr(engine, "_paged_prefix", None) is not None:
        engine._paged_prefix._lock = san.wrap_lock(
            engine._paged_prefix._lock, "trie._lock"
        )
