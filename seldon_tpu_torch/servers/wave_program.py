"""Captured wave programs: the port's ``jax.jit`` of the converged
engine's lattice (ROADMAP.md A15). A port-only module: the JAX package
has no file for it, since ``jax.jit`` is what it replaces.

The JAX engine runs each key of the converged engine's lattice
(``EngineConfig(ragged=True)``: ``("ragged", C)`` and ``("deactivate",)``)
as one compiled program with its state donated, and its ``warmup``
compiles them ahead of traffic. The port captures each as a CUDA graph
once and replays it every wave:

 * :class:`WaveProgram` is one captured program: static device buffers
   for its host descriptors, static buffers for its outputs, and the
   graph, whose body is the family the eager route runs
   (``servers/engine.run_family``) followed by ``copy_``-ing the new
   per-slot fields back into the engine's state tensors, so their
   addresses stay fixed (the KV pool is written in place already).
 * :class:`Programs` holds one engine's programs, keyed by the lattice
   key plus the host-side branch the wave takes (the JAX program takes
   its ``lax.cond`` branches inside one compile; the port's are Python
   choices on host descriptors, so each branch is a program). All of
   them capture on one side stream into one shared graph memory pool,
   so their transients share its segments (the pool still exceeds the
   largest wave's peak by about one large allocation, where smaller ones
   split the free segment of an earlier one: ROADMAP.md A15, C7), and
   all of them read and write one binding of the engine's state
   (``home``): a field that an eager family replaced since the last run
   is copied in first.

:meth:`WaveProgram.run` stages each host descriptor with one ``copy_``
from its pinned staging buffer into its static buffer and replays the
graph on the current stream. On the CPU it calls the same body on the
same static buffers without a graph: the port's CPU rule, as for every
kernel, not a fallback. On a CUDA tensor a program captures or replays, or it
raises; nothing gives way to the eager route.

A capture first runs the body once eagerly on trash descriptors (the
caller's, as ``InferenceEngine._warm_key`` builds them): scratch
per-slot fields with every row idle and tables at the trash block, so
its only pool writes land in the trash block. That run settles what
must not happen inside a capture: kernel builds and their one-time
``cudaFuncSetAttribute``, cuBLASLt's per-shape plans, the side
stream's cuBLAS workspace. Then the body is captured on the side stream
with ``capture_error_mode="thread_local"``, so the engine's fetcher
thread keeps running while the scheduler thread captures lazily.

The wrappers count their launches through
``ops/host_hooks.host_callback`` (the port's ``jax.debug.callback``), so
a replay counts what the captured body launched: a capture collects the
callbacks its body makes and runs them after every replay, and its warm
run drops them. :func:`disabled` is the port's ``jax.disable_jit()``: inside
it every engine dispatches eagerly (the tests and ``chip_smoke.py``
hold the two routes against each other with it). :func:`clear_caches`
is ``jax.clear_caches()``: every program is captured anew at its next
run (instrumentation that swaps a function the body calls needs it).

Captured: the kernel leg (``"pallas"``, B1) and the masked leg of a
single-rank engine. Eager by rule: rank groups (their families are
staged through host memory between the ranks, which a graph cannot
hold), the ``"sparse"`` leg (its Python walk trips ``n_live`` times)
and the ``"reference"`` diagnostic leg; every other family (the
bucketed and dense engines, the verify wave) is eager too.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from seldon_tpu_torch.ops import host_hooks

# The wave legs a single-rank engine runs as programs.
CAPTURED_LEGS = ("pallas", "masked")

_lock = threading.Lock()
_disabled = 0
_generation = 0


@contextlib.contextmanager
def disabled():
    """Inside, every engine dispatches its programs' families eagerly
    (``jax.disable_jit()``); process-wide, since an engine dispatches on
    its own scheduler thread."""
    global _disabled
    with _lock:
        _disabled += 1
    try:
        yield
    finally:
        with _lock:
            _disabled -= 1


def enabled() -> bool:
    """False inside :func:`disabled`."""
    return _disabled == 0


def clear_caches() -> None:
    """Every engine's programs are released and captured anew at their
    next run (``jax.clear_caches()``)."""
    global _generation
    with _lock:
        _generation += 1


def _write_back(home: Dict[str, Any], new: Dict[str, Any]) -> None:
    """``home``'s tensors take ``new``'s values in place (one ``copy_``
    each where ``new`` holds another tensor)."""
    for key, val in home.items():
        if key == "cache":
            for ck, arr in val.items():
                if new["cache"][ck] is not arr:
                    arr.copy_(new["cache"][ck])
        elif new[key] is not val:
            val.copy_(new[key])


class WaveProgram:
    """One family at one branch: its static inputs and outputs, and on
    the card its graph and the callbacks it replays."""

    def __init__(self, key: Hashable, body: Callable, home: Dict[str, Any],
                 args: Sequence[np.ndarray], device: torch.device):
        self.key = key
        self._body = body
        self._home = home
        # Allocated on the current stream, outside the graph pool: they
        # live as long as the program.
        self.inputs = [torch.empty(a.shape, dtype=torch.from_numpy(
            np.ascontiguousarray(a)).dtype, device=device) for a in args]
        # On the card, one pinned staging buffer per input (the host side
        # of its copy_) and the event after the last copies out of them.
        self._staging: Optional[List[torch.Tensor]] = None
        self._staged = None
        self.outs: Optional[List[torch.Tensor]] = None
        self.graph = None
        self.hooks: List[Callable[[], Any]] = []

    def _step(self) -> None:
        """The body the graph holds: the family on the static inputs and
        the engine's state, the outputs into their static buffers, the
        new fields written back in place."""
        out = self._body(self._home, *self.inputs)
        if self.outs is None:  # the CPU's first run
            self.outs = [torch.empty_like(o) for o in out[1:]]
        # Outputs first: one may be a view of a field the write-back
        # overwrites (a decode-only wave's ``valid`` is the old active).
        for buf, o in zip(self.outs, out[1:]):
            buf.copy_(o)
        _write_back(self._home, out[0])

    def stage(self, args: Sequence[np.ndarray]) -> None:
        """Each host descriptor into its static buffer: on the card
        written into its pinned staging buffer, then one ``copy_`` from
        there queued on the current stream."""
        if not (self.inputs and self.inputs[0].is_cuda):
            for buf, a in zip(self.inputs, args):
                buf.copy_(torch.from_numpy(np.ascontiguousarray(a)))
            return
        if self._staging is None:
            self._staging = [torch.empty(b.shape, dtype=b.dtype,
                                         pin_memory=True)
                             for b in self.inputs]
            self._staged = torch.cuda.Event()
        else:
            # The last run's copies out of the staging buffers have run
            # before they are overwritten.
            self._staged.synchronize()
        for pin, buf, a in zip(self._staging, self.inputs, args):
            pin.numpy()[...] = a
            buf.copy_(pin, non_blocking=True)
        self._staged.record()

    def run(self, args: Sequence[np.ndarray]) -> List[torch.Tensor]:
        """Stage ``args`` and run the body: a replay of the graph on the
        card, the body itself on the CPU. Returns the static outputs."""
        self.stage(args)
        if self.graph is not None:
            self.graph.replay()
            for fn in self.hooks:
                fn()
        elif self.inputs and self.inputs[0].is_cuda:
            raise RuntimeError(f"wave program {self.key!r} has no graph")
        else:
            self._step()
        return self.outs

    def release(self) -> None:
        self.graph = None
        self.hooks = []
        self.inputs = []
        self._staging = self._staged = None
        self.outs = None


class Programs:
    """One engine's programs by key, their shared graph pool and capture
    stream, and the binding of the engine's state they all use."""

    def __init__(self, device: torch.device):
        self.device = device
        self._programs: Dict[Hashable, WaveProgram] = {}
        self.home: Optional[Dict[str, Any]] = None
        self._pool = None
        self._stream = None
        self._generation = _generation
        # Captures since the engine was built (each program, each time
        # it is captured), and the ms each took (warm run, capture and
        # instantiation).
        self.captures = 0
        self.capture_ms: List[float] = []
        # The graph pool's bytes after each capture.
        self.capture_bytes: List[int] = []
        # Program runs since the engine was built (replays on the card).
        self.runs = 0

    def __len__(self) -> int:
        return len(self._programs)

    def keys(self) -> List[Hashable]:
        return list(self._programs)

    def get(self, key: Hashable) -> Optional[WaveProgram]:
        return self._programs.get(key)

    def adopt(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """Bind ``state`` as home (the first time), else copy into home
        every tensor of ``state`` that is not home's own."""
        if self._generation != _generation:
            self.release()
            self._generation = _generation
        if self.home is None:
            self.home = {**state, "cache": dict(state["cache"])}
        else:
            _write_back(self.home, state)
        return self.home

    def prepare(self, key: Hashable, body: Callable, state: Dict[str, Any],
                warm: Sequence[np.ndarray]) -> WaveProgram:
        """The program of ``key``, built (and on the card captured after
        a warm run on the trash descriptors ``warm``) if missing."""
        home = self.adopt(state)
        prog = self._programs.get(key)
        if prog is None:
            prog = WaveProgram(key, body, home, warm, self.device)
            if self.device.type == "cuda":
                self._capture(prog, warm)
            self._programs[key] = prog
        return prog

    def run(self, key: Hashable, body: Callable, state: Dict[str, Any],
            args: Sequence[np.ndarray], warm: Sequence[np.ndarray]):
        """Run ``key``'s program on ``args`` against ``state``: returns
        (the new state, :meth:`state`, and the outputs)."""
        prog = self.prepare(key, body, state, warm)
        outs = prog.run(args)
        self.runs += 1
        return self.state(), outs

    def state(self) -> Dict[str, Any]:
        """The engine's state as the programs hold it: home's tensors."""
        return {**self.home, "cache": self.home["cache"]}

    def _capture(self, prog: WaveProgram, warm: Sequence[np.ndarray]) -> None:
        t0 = time.perf_counter()
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        home = prog._home
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            # Every row idle, every table at the trash block: the run
            # writes nothing but the trash block of the pool.
            scratch = {k: (v if k == "cache" else torch.zeros_like(v))
                       for k, v in home.items()}
            inputs = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                      for a in warm]
            with host_hooks.collecting(host_hooks.WARM):
                out = prog._body(scratch, *inputs)
            like = [(o.shape, o.dtype) for o in out[1:]]
            del out, scratch, inputs
        cur.wait_stream(side)
        prog.outs = [torch.empty(s, dtype=d, device=dev) for s, d in like]
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        hooks: List[Callable[[], Any]] = []
        with torch.cuda.stream(side), host_hooks.collecting(hooks):
            graph.capture_begin(pool=self._pool,
                                capture_error_mode="thread_local")
            try:
                prog._step()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture was invalidated: the cause is raised
                raise
            graph.capture_end()
        cur.wait_stream(side)
        prog.graph, prog.hooks = graph, hooks
        self.captures += 1
        self.capture_ms.append((time.perf_counter() - t0) * 1e3)
        self.capture_bytes.append(self.pool_bytes())

    def pool_bytes(self, active: bool = False) -> int:
        """Bytes the allocator's segments of the shared graph pool hold
        (0 on the CPU or before a capture); with ``active``, only its
        blocks that live tensors hold. The rest are the programs'
        transients, which every replay reuses."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        total = 0
        for seg in torch.cuda.memory_snapshot():
            if tuple(seg.get("segment_pool_id", ())) != pool:
                continue
            total += (sum(b["size"] for b in seg["blocks"]
                          if b["state"] == "active_allocated")
                      if active else seg["total_size"])
        return total

    def release(self) -> None:
        """Free every program and the graph pool (after the card has
        finished what was queued); the next run captures anew against
        the state it is given."""
        if self.device.type == "cuda" and self._programs:
            torch.cuda.synchronize(self.device)
        for prog in self._programs.values():
            prog.release()
        self._programs.clear()
        self.home = None
        if self._pool is not None:
            self._pool = None
            self._stream = None
            torch.cuda.empty_cache()
