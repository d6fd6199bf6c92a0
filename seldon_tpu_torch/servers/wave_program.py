"""Captured programs: the port's ``jax.jit`` of a single-rank engine's
lattice (ROADMAP.md A15). A port-only module: the JAX package has no
file for it, since ``jax.jit`` is what it replaces.

The JAX engine runs every key of its lattice
(``servers/shape_lattice.dispatch_keys``: the admissions, the decode
ladder, the prefill chunks, the dense trie's seed, the copy-on-write
copy, the ragged wave, the verify and draft rungs, the deactivate
freeze) as one compiled program with its state donated, and its
``warmup`` compiles them ahead of traffic. The port captures each as a
CUDA graph once and replays it at every dispatch:

 * :class:`WaveProgram` is one captured program: static device buffers
   for its inputs, static buffers for its outputs, and the graph, whose
   body is the family the eager route runs
   (``servers/engine.run_family``) followed by ``copy_``-ing the new
   per-slot fields back into the engine's state tensors, so their
   addresses stay fixed (the KV cache is written in place already). An
   input is a host array (staged through pinned memory), a device
   tensor or a dict of them (the dense trie's gathered prefix KV,
   copied into the static buffers on the stream). A stateless program
   (the draft model's ``("draft", k)``) has no state and no write-back.
 * :class:`Programs` holds one engine's programs, keyed by the lattice
   key plus the host-side branch the family takes (the JAX program
   takes its ``lax.cond`` branches inside one compile; the port's are
   Python choices on host descriptors, so each branch is a program:
   ``ragged_attention.wave_branch``, ``spec_decode.verify_branch``). All
   of them capture into one shared graph memory pool, so their
   transients share its segments (the pool still exceeds the largest
   family's peak by about one large allocation, where smaller ones
   split the free segment of an earlier one: ROADMAP.md A15, C7), and
   all of them read and write one binding of the engine's state
   (``home``): a field that an eager family replaced since the last run
   is copied in first. Every engine of the process captures on one side
   stream per device, one capture at a time: cuBLAS keeps a 32 MiB
   workspace per (handle, stream) for the life of the process, so a
   stream per engine would leave one workspace behind per engine.

:meth:`Programs.run` stages the inputs into the static buffers and
replays the graph on the current stream; the outputs it returns are
the static buffers, which the next run of the same program overwrites
(the engine copies out those that must outlive it: an admission's first
tokens, when the same key admits several groups in one boundary). On
the CPU it calls the same body on the same static buffers without a
graph: the port's CPU rule, as for every kernel, not a fallback. On a
CUDA tensor a program captures or replays, or it raises; nothing gives
way to the eager route.

On the card a program is made at its first run (or by the engine's
``warmup``): the body runs once eagerly on that run's own inputs against
a copy of the per-slot fields and the engine's cache (the warm run),
then it is captured. The warm run's cache writes are
the ones the run that follows makes again at the same places (a
family's writes depend only on its inputs and the per-slot fields), and
they land only where that run writes, so a capture in the middle of
traffic leaves every live slot as the eager route would: a paged pool
or the dense slab alike. On the card the warm run settles what must not
happen inside a capture: kernel builds and their one-time
``cudaFuncSetAttribute``, cuBLASLt's per-shape plans, the side stream's
cuBLAS workspace. The capture runs on the side stream with
``capture_error_mode="thread_local"``, so the engine's fetcher thread
keeps running while the scheduler thread captures lazily.

The wrappers count their launches through
``ops/host_hooks.host_callback`` (the port's ``jax.debug.callback``), so
a replay counts what the captured body launched: a capture collects the
callbacks its body makes and runs them after every replay, and its warm
run drops them. :func:`disabled` is the port's ``jax.disable_jit()``:
inside it every engine dispatches eagerly (the tests and
``chip_smoke.py`` hold the two routes against each other with it).
:func:`clear_caches` is ``jax.clear_caches()``: every program is
captured anew at its next run (instrumentation that swaps a function the
body calls needs it).

Captured: every family of a single-rank engine on the kernel leg
(``"pallas"``: B1 in the ragged and verify waves) or the masked leg,
B2 included in the cold admissions under ``attn_impl="flash"``. Eager by
rule: rank groups (their families are staged through host memory
between the ranks, which a graph cannot hold), the ``"sparse"`` leg (its
Python walk trips ``n_live`` times), the ``"reference"`` diagnostic leg,
and ``attn_impl="ring"`` (its prefill needs an sp rank group).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence

import numpy as np
import torch

from seldon_tpu_torch.ops import host_hooks

# The legs a single-rank engine runs as programs.
CAPTURED_LEGS = ("pallas", "masked")

_lock = threading.Lock()
_disabled = 0
_generation = 0
# The process's capture streams by device, and the lock one capture at a
# time holds.
_capture_streams: Dict[int, Any] = {}
_capture_lock = threading.Lock()


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


def _leaves(values: Sequence[Any]) -> List[Any]:
    """The arrays and tensors of ``values``, a dict's in its order."""
    out: List[Any] = []
    for v in values:
        out.extend(v.values() if isinstance(v, dict) else (v,))
    return out


def _structure(values: Sequence[Any]) -> List[Optional[tuple]]:
    """Each of ``values``' structure: a dict's keys, or None for a leaf."""
    return [tuple(v) if isinstance(v, dict) else None for v in values]


def _rebuild(spec: Sequence[Optional[tuple]],
             leaves: Sequence[Any]) -> List[Any]:
    """The values of structure ``spec`` over ``leaves`` (:func:`_leaves`)."""
    out, i = [], 0
    for keys in spec:
        if keys is None:
            out.append(leaves[i])
            i += 1
        else:
            out.append(dict(zip(keys, leaves[i:i + len(keys)])))
            i += len(keys)
    return out


def _as_tensor(a: Any) -> torch.Tensor:
    return (a if isinstance(a, torch.Tensor)
            else torch.from_numpy(np.ascontiguousarray(a)))


class WaveProgram:
    """One family at one branch: its static inputs and outputs, and on
    the card its graph and the callbacks it replays. ``home`` None: a
    stateless program."""

    def __init__(self, key: Hashable, body: Callable,
                 home: Optional[Dict[str, Any]], args: Sequence[Any],
                 device: torch.device):
        self.key = key
        self._body = body
        self._home = home
        self._cuda = device.type == "cuda"
        self._spec = _structure(args)
        # Allocated on the current stream, outside the graph pool: they
        # live as long as the program.
        self.inputs = [torch.empty_like(_as_tensor(a), device=device)
                       for a in _leaves(args)]
        # The static outputs (a dict output's tensors flattened), and
        # their structure.
        self._outs: Optional[List[torch.Tensor]] = None
        self._out_spec: List[Optional[tuple]] = []
        self.graph = None
        self.hooks: List[Callable[[], Any]] = []

    def args(self) -> List[Any]:
        """The static inputs in the body's argument structure."""
        return _rebuild(self._spec, self.inputs)

    @property
    def outs(self) -> Optional[List[Any]]:
        """The static outputs in the body's output structure."""
        return (None if self._outs is None
                else _rebuild(self._out_spec, self._outs))

    def _shape_outs(self, out: Sequence[Any], device=None) -> None:
        """Static output buffers shaped as the body's outputs ``out``."""
        self._out_spec = _structure(out)
        self._outs = [torch.empty(o.shape, dtype=o.dtype,
                                  device=device or o.device)
                      for o in _leaves(out)]

    def _step(self) -> None:
        """The body the graph holds: the family on the static inputs and
        the engine's state, the outputs into their static buffers, the
        new fields written back in place."""
        out = self._body(self._home, *self.args())
        if self._outs is None:  # the CPU's first run
            self._shape_outs(out[1:])
        # Outputs first: one may be a view of a field the write-back
        # overwrites (a decode-only wave's ``valid`` is the old active).
        for buf, o in zip(self._outs, _leaves(out[1:])):
            buf.copy_(o)
        if self._home is not None:
            _write_back(self._home, out[0])

    def warm(self) -> tuple:
        """The body once, eagerly, on the static inputs against a copy of
        home's per-slot fields and home's cache (its callbacks dropped);
        returns its outputs. Its cache writes are the next run's
        (module docstring)."""
        scratch = None if self._home is None else {
            k: (v if k == "cache" else v.clone())
            for k, v in self._home.items()}
        with host_hooks.collecting(host_hooks.WARM):
            return self._body(scratch, *self.args())

    def stage(self, args: Sequence[Any]) -> None:
        """Each input into its static buffer: a host array through pinned
        memory (the caching host allocator keeps it until the copy has
        run), a device tensor with one ``copy_``; both queued on the
        current stream."""
        for buf, a in zip(self.inputs, _leaves(args)):
            if isinstance(a, torch.Tensor):
                buf.copy_(a)
                continue
            t = _as_tensor(a)
            if self._cuda:
                buf.copy_(t.pin_memory(), non_blocking=True)
            else:
                buf.copy_(t)

    def launch(self) -> List[torch.Tensor]:
        """Run the staged program: a replay of the graph on the card, the
        body itself on the CPU. Returns the static outputs."""
        if self.graph is not None:
            self.graph.replay()
            for fn in self.hooks:
                fn()
        elif self._cuda:
            raise RuntimeError(f"wave program {self.key!r} has no graph")
        else:
            self._step()
        return self.outs

    def release(self) -> None:
        self.graph = None
        self.hooks = []
        self.inputs = []
        self._outs = None


class Programs:
    """One engine's programs by key, their shared graph pool and capture
    stream, and the binding of the engine's state they all use."""

    def __init__(self, device: torch.device):
        self.device = device
        self._programs: Dict[Hashable, WaveProgram] = {}
        self.home: Optional[Dict[str, Any]] = None
        self._pool = None
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

    def adopt(self, state: Optional[Dict[str, Any]]
              ) -> Optional[Dict[str, Any]]:
        """Bind ``state`` as home (the first time), else copy into home
        every tensor of ``state`` that is not home's own; None (a
        stateless program) binds nothing."""
        if self._generation != _generation:
            self.release()
            self._generation = _generation
        if state is None:
            return None
        if self.home is None:
            self.home = {**state, "cache": dict(state["cache"])}
        else:
            _write_back(self.home, state)
        return self.home

    def prepare(self, key: Hashable, body: Callable,
                state: Optional[Dict[str, Any]],
                args: Sequence[Any]) -> WaveProgram:
        """The program of ``key`` with ``args`` staged: made if missing
        (on the card its warm run on ``args`` and its capture)."""
        home = self.adopt(state)
        prog = self._programs.get(key)
        if prog is not None:
            prog.stage(args)
            return prog
        prog = WaveProgram(key, body, home, args, self.device)
        prog.stage(args)
        self._make(prog)
        self._programs[key] = prog
        return prog

    def _make(self, prog: WaveProgram) -> None:
        """A new program's making: on the card its warm run and capture;
        nothing on the CPU, where the body runs at every launch."""
        if self.device.type == "cuda":
            self._capture(prog)

    def run(self, key: Hashable, body: Callable,
            state: Optional[Dict[str, Any]], args: Sequence[Any]):
        """Run ``key``'s program on ``args`` against ``state`` (None for a
        stateless program): returns (the new state, :meth:`state`, or
        None, and the static outputs)."""
        prog = self.prepare(key, body, state, args)
        outs = prog.launch()
        self.runs += 1
        return (None if state is None else self.state()), outs

    def state(self) -> Dict[str, Any]:
        """The engine's state as the programs hold it: home's tensors."""
        return {**self.home, "cache": self.home["cache"]}

    def _capture(self, prog: WaveProgram) -> None:
        with _capture_lock:
            self._capture_locked(prog)

    def _capture_locked(self, prog: WaveProgram) -> None:
        t0 = time.perf_counter()
        dev = self.device
        cur = torch.cuda.current_stream(dev)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        index = torch.cuda.current_device() if dev.index is None \
            else dev.index
        side = _capture_streams.get(index)
        if side is None:
            side = _capture_streams[index] = torch.cuda.Stream(index)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = prog.warm()
        cur.wait_stream(side)
        prog._shape_outs(out[1:], dev)
        del out
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
            torch.cuda.empty_cache()
