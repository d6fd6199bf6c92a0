"""The projections' GEMM on the card (bf16, or f32 for float32 models;
and the head's f32 logits product), through cuBLASLt with the algorithm
of the full-width product at every share of its columns.

Exact tensor parallelism (``models/tp_sharding.py``) cuts ``wq`` / ``wk``
/ ``wv`` / ``w_gate`` / ``w_up`` on their output columns, so a rank runs
the same product as tp = 1 on a narrower N. cuBLAS's heuristics pick the
algorithm from (M, N, K), and two algorithms may reduce an output
element's K products in different orders: on the H100 ``torch.matmul``
splits K for the half of ``wq`` at M 1 to 32 and not for the whole
(chip_smoke 9l; ROADMAP.md C18). Here the algorithm is chosen once per
(M, K, full width, the model's tps) and used for the full width and
for each 1 / tp share of it: each output element is then reduced by the
same kernel in the same order at every tp, and tp = 1 runs what
cuBLASLt picks for its own shape. A dp replica's product on its share of
the batch's rows (inside :func:`row_share`) runs the algorithm of the
whole batch's rows in the same way, since cuBLAS's own choice for ``wo``
and for the f32 logits product depends on M (the algorithm must run
every 1 / dp share of the rows, ``ROW_SHARES``, and one row). The choice is the first of cuBLASLt's
candidates for the full width (no workspace offered) that splits no K,
reduces no partials and runs every share; at some shares an algorithm
asks for a few bytes of scratch (4 B on the H100), which it gets, up to
``MAX_SCRATCH``. No candidate, or a width outside the shares that the
algorithm does not run, raises.

Both types compute with ``CUBLAS_COMPUTE_32F``: bf16 operands with f32
accumulation, or f32 operands in full f32 (never ``..._FAST_TF32``: an
f32 model on the port computes what the JAX package computes in f32).

Bound with ctypes to the ``libcublasLt`` PyTorch has loaded; nothing is
loaded until the first call, so the module imports anywhere. Launches
on the current stream; output via ``torch.empty``. Not differentiable:
``transformer._qdot`` calls it outside autograd only.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import threading
from typing import Dict, Optional, Tuple

import torch

from seldon_tpu_torch.ops import host_hooks

# The tps whose shares of a full width (1 / tp of its columns) its
# algorithm must run, unless the caller names the model's own: every tp
# the port's rank groups take.
TP_WIDTHS = (1, 2, 4, 8)
# The shares of a product's rows its algorithm must run too: a dp
# replica's 1 / dp of the whole batch's rows (``row_share``), for every dp
# the port's rank groups take, and one row.
ROW_SHARES = (1, 2, 4, 8)
# Scratch bytes an algorithm may ask for at a share: far too few for
# split-K partials at the projections' sizes (which the algorithm's own
# configuration excludes anyway).
MAX_SCRATCH = 4096
CANDIDATES = 16  # heuristic results asked for per full-width shape

# cuBLAS / CUDA enum values (cublasLt.h, library_types.h).
_COMPUTE_32F = 68
_R_32F, _R_16BF = 0, 14
# The operand types the GEMM takes: cuBLAS data type by torch dtype.
_DATA_TYPE = {torch.bfloat16: _R_16BF, torch.float32: _R_32F}
_OP_N, _OP_T = 0, 1
_DESC_TRANSA = 3  # CUBLASLT_MATMUL_DESC_TRANSA
_PREF_MAX_WORKSPACE_BYTES = 1
_ALGO_CONFIG = {"id": 0, "tile": 1, "splitk": 2, "reduction": 3,
                "swizzle": 4, "custom": 5, "stages": 6}

# Calls since the last reset (a plain counter: chip_smoke zeroes it).
launches = 0


class _Algo(ctypes.Structure):
    _fields_ = [("data", ctypes.c_uint64 * 8)]


class _Heuristic(ctypes.Structure):
    _fields_ = [("algo", _Algo), ("workspaceSize", ctypes.c_size_t),
                ("state", ctypes.c_int), ("wavesCount", ctypes.c_float),
                ("reserved", ctypes.c_int * 4)]


def _library() -> ctypes.CDLL:
    """The cuBLASLt PyTorch uses (by soname: already loaded), else the
    toolkit's, with every function used here declared."""
    names = (["libcublasLt.so.12", "libcublasLt.so"]
             + glob.glob(os.path.join(os.path.dirname(torch.__file__), "..",
                                      "nvidia", "cublas", "lib",
                                      "libcublasLt.so*"))
             + glob.glob("/usr/local/cuda/lib64/libcublasLt.so*"))
    for name in names:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    else:
        raise RuntimeError("libcublasLt is not loadable; the column-sharded "
                           "projections need it on the card")
    p, i, u64, i64, sz = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64,
                          ctypes.c_int64, ctypes.c_size_t)
    pp, ptr = ctypes.POINTER(ctypes.c_void_p), ctypes.c_void_p
    for name, args in (
            ("cublasLtCreate", [pp]),
            ("cublasLtMatmulDescCreate", [pp, i, i]),
            ("cublasLtMatmulDescSetAttribute", [p, i, ptr, sz]),
            ("cublasLtMatmulPreferenceCreate", [pp]),
            ("cublasLtMatmulPreferenceSetAttribute", [p, i, ptr, sz]),
            ("cublasLtMatrixLayoutCreate", [pp, i, u64, u64, i64]),
            ("cublasLtMatmulAlgoGetHeuristic",
             [p, p, p, p, p, p, p, i, ctypes.POINTER(_Heuristic),
              ctypes.POINTER(ctypes.c_int)]),
            ("cublasLtMatmulAlgoCheck",
             [p, p, p, p, p, p, ctypes.POINTER(_Algo),
              ctypes.POINTER(_Heuristic)]),
            ("cublasLtMatmulAlgoConfigGetAttribute",
             [ctypes.POINTER(_Algo), i, ptr, sz, ctypes.POINTER(sz)]),
            ("cublasLtMatmul",
             [p, p, ptr, ptr, p, ptr, p, ptr, ptr, p, ptr, p,
              ctypes.POINTER(_Algo), ptr, sz, p])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def _ok(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"cuBLASLt {what} failed with status {status}")


class _Lt:
    """One process's cuBLASLt handle, its two matmul descriptors (the
    weight row-major, or column-major as the int8 projections are
    stored), its pinned algorithms and, per product shape, the plan that
    every call of that shape reuses."""

    def __init__(self):
        self.lib = _library()
        self.handle = ctypes.c_void_p()
        _ok(self.lib.cublasLtCreate(ctypes.byref(self.handle)), "create")
        self.desc = {}
        for op in (_OP_N, _OP_T):
            d = ctypes.c_void_p()
            _ok(self.lib.cublasLtMatmulDescCreate(ctypes.byref(d),
                                                  _COMPUTE_32F, _R_32F),
                "descriptor")
            v = ctypes.c_int32(op)
            _ok(self.lib.cublasLtMatmulDescSetAttribute(
                d, _DESC_TRANSA, ctypes.byref(v), ctypes.sizeof(v)),
                "transA")
            self.desc[op] = d
        self.pref = ctypes.c_void_p()
        _ok(self.lib.cublasLtMatmulPreferenceCreate(ctypes.byref(self.pref)),
            "preference")
        none = ctypes.c_size_t(0)
        _ok(self.lib.cublasLtMatmulPreferenceSetAttribute(
            self.pref, _PREF_MAX_WORKSPACE_BYTES, ctypes.byref(none),
            ctypes.sizeof(none)), "no workspace")
        self.one, self.zero = ctypes.c_float(1.0), ctypes.c_float(0.0)
        self.layouts: Dict[tuple, ctypes.c_void_p] = {}
        # (op, M, K, n_full, tps, data type)
        self.pinned: Dict[tuple, _Algo] = {}
        # (op, M, K, N, n_full, tps, data type) -> (descriptor, algorithm,
        # the layouts of w, x and y, scratch bytes): all a call passes but
        # its pointers.
        self.plans: Dict[tuple, tuple] = {}
        self.lock = threading.Lock()

    def _layout(self, rows: int, cols: int, ld: int,
                dt: int) -> ctypes.c_void_p:
        key = (rows, cols, ld, dt)
        if key not in self.layouts:
            lay = ctypes.c_void_p()
            _ok(self.lib.cublasLtMatrixLayoutCreate(
                ctypes.byref(lay), dt, ctypes.c_uint64(rows),
                ctypes.c_uint64(cols), ctypes.c_int64(ld)), "layout")
            self.layouts[key] = lay
        return self.layouts[key]

    def _layouts(self, op: int, M: int, K: int, N: int, dt: int):
        """cuBLAS is column-major: y[M, N] = x[M, K] @ w[K, N] row-major is
        y^T[N, M] = op(w) x^T, where a row-major w is a column-major
        [N, K] (op N) and a column-major w a column-major [K, N] (op T).
        All three in data type ``dt``."""
        a = (self._layout(N, K, N, dt) if op == _OP_N
             else self._layout(K, N, K, dt))
        return a, self._layout(K, M, K, dt), self._layout(N, M, N, dt)

    def config(self, algo: _Algo) -> Dict[str, int]:
        """An algorithm's configuration (id, tile, split-K, ...)."""
        out = {}
        for name, attr in _ALGO_CONFIG.items():
            v, w = ctypes.c_uint32(0), ctypes.c_size_t()
            _ok(self.lib.cublasLtMatmulAlgoConfigGetAttribute(
                ctypes.byref(algo), attr, ctypes.byref(v), ctypes.sizeof(v),
                ctypes.byref(w)), "algorithm attribute")
            out[name] = v.value
        return out

    def _scratch(self, op: int, algo: _Algo, M: int, K: int, N: int,
                 dt: int) -> Optional[int]:
        """The scratch bytes ``algo`` needs at (M, K, N), or None when it
        does not run that shape within MAX_SCRATCH."""
        a, b, c = self._layouts(op, M, K, N, dt)
        res = _Heuristic()
        status = self.lib.cublasLtMatmulAlgoCheck(
            self.handle, self.desc[op], a, b, c, c, ctypes.byref(algo),
            ctypes.byref(res))
        if status != 0 or res.workspaceSize > MAX_SCRATCH:
            return None
        return int(res.workspaceSize)

    def _pin(self, op: int, M: int, K: int, n_full: int,
             tps: Tuple[int, ...], dt: int) -> _Algo:
        """The first of cuBLASLt's CANDIDATES for the full width that
        splits no K and runs every 1 / tp share of it, tp in ``tps``, on
        every 1 / dp share of the rows (ROW_SHARES) and on one row."""
        a, b, c = self._layouts(op, M, K, n_full, dt)
        res, got = (_Heuristic * CANDIDATES)(), ctypes.c_int()
        _ok(self.lib.cublasLtMatmulAlgoGetHeuristic(
            self.handle, self.desc[op], a, b, c, c, self.pref, CANDIDATES,
            res, ctypes.byref(got)), "heuristic")
        widths = [n_full // t for t in tps if n_full % t == 0]
        rows = sorted({M // d for d in ROW_SHARES if M % d == 0} | {1})
        seen = []
        for h in res[:got.value]:
            cfg = self.config(h.algo)
            seen.append(cfg)
            if cfg["splitk"] > 1 or cfg["reduction"]:
                continue
            if all(self._scratch(op, h.algo, m, K, n, dt) is not None
                   for m in rows for n in widths):
                return _Algo.from_buffer_copy(h.algo)
        raise RuntimeError(f"cuBLASLt offers no algorithm for M {M}, K {K}, "
                           f"N {n_full} that splits no K and runs the "
                           f"widths {widths} on the rows {rows}: {seen}")

    def plan(self, op: int, M: int, K: int, N: int, n_full: int,
             tps: Tuple[int, ...], dt: int, m_full: int) -> tuple:
        """What x [M, K] @ w [K, N], a share of the n_full-wide product
        on M of its m_full rows, passes to cuBLASLt with the (op, m_full,
        K, n_full, tps, dt) algorithm; raises unless that algorithm runs
        this M and N."""
        key = (op, M, K, N, n_full, tps, dt, m_full)
        hit = self.plans.get(key)
        if hit is not None:
            return hit
        if torch.cuda.is_current_stream_capturing():
            # A captured wave's warm run plans every shape it runs.
            raise RuntimeError(f"cuBLASLt has no plan for {key} inside a "
                               f"captured wave: warm it first")
        with self.lock:
            pk = (op, m_full, K, n_full, tps, dt)
            if pk not in self.pinned:
                self.pinned[pk] = self._pin(op, m_full, K, n_full, tps, dt)
            algo = self.pinned[pk]
            scratch = self._scratch(op, algo, M, K, N, dt)
            if scratch is None:
                raise RuntimeError(
                    f"cuBLASLt's algorithm {self.config(algo)} for M "
                    f"{m_full}, K {K}, N {n_full} does not run M {M}, "
                    f"N {N}")
            self.plans[key] = (self.desc[op], ctypes.pointer(algo),
                               *self._layouts(op, M, K, N, dt), scratch)
            return self.plans[key]

    def matmul(self, x: torch.Tensor, w: torch.Tensor, op: int,
               n_full: int, tps: Tuple[int, ...],
               m_full: int) -> torch.Tensor:
        M, K = x.shape
        N = w.shape[1]
        desc, algo, a, b, c, scratch = self.plan(op, M, K, N, n_full, tps,
                                                 _DATA_TYPE[x.dtype], m_full)
        y = torch.empty((M, N), dtype=x.dtype, device=x.device)
        # Stream-ordered and alive until the call is queued, so concurrent
        # callers never share it.
        ws = (torch.empty(scratch, dtype=torch.uint8, device=x.device)
              if scratch else None)
        _ok(self.lib.cublasLtMatmul(
            self.handle, desc, ctypes.byref(self.one), w.data_ptr(), a,
            x.data_ptr(), b, ctypes.byref(self.zero), y.data_ptr(), c,
            y.data_ptr(), c, algo, None if ws is None else ws.data_ptr(),
            scratch, torch.cuda.current_stream(x.device).cuda_stream),
            "matmul")
        return y


_lt = None
_lt_lock = threading.Lock()
_share = threading.local()


@contextlib.contextmanager
def row_share(mine: int, total: int):
    """Products on this thread, inside, run a dp replica's ``mine`` of
    ``total`` batch items (its slots, or its admission rows;
    ``servers/dp_replicas.py``): :func:`matmul` of M rows pins the
    algorithm of the whole batch's ``M / mine * total`` rows and runs it
    on its own M, so each row is reduced as in the whole batch's
    product. One item of one (``mine == total``) changes nothing."""
    prev = getattr(_share, "items", None)
    _share.items = (int(mine), int(total)) if mine != total else None
    try:
        yield
    finally:
        _share.items = prev


def shared_items() -> Optional[Tuple[int, int]]:
    """(mine, total) of the innermost :func:`row_share`, or None."""
    return getattr(_share, "items", None)


def whole_batch(B: int) -> Optional[int]:
    """Inside a dp replica's :func:`row_share` of ``mine`` of ``total``
    items, the whole batch's size for this replica's ``B`` (cuBLAS picks
    a batched product's algorithm by its batch count, so the products
    over the batch run padded to it, as the heads are under tp); None
    outside one."""
    items = shared_items()
    if items is None:
        return None
    mine, total = items
    if B % mine:
        raise ValueError(f"a batch of {B} is not a whole number of rows "
                         f"for each of {mine} items")
    return B // mine * total


def pad_batch(t: Optional[torch.Tensor], n: int) -> Optional[torch.Tensor]:
    """``t`` with zeros after its rows on dim 0, to ``n`` rows."""
    if t is None:
        return None
    out = t.new_zeros((n, *t.shape[1:]))
    out[:t.shape[0]] = t
    return out


def whole_einsum(eq: str, a: torch.Tensor, b: torch.Tensor, tp=None,
                 heads: Tuple[int, int, int] = (0, 0, 0)) -> torch.Tensor:
    """``torch.einsum(eq, a, b)`` of a product batched over the slots (dim
    0 of both operands and of the result) and the KV heads (dims
    ``heads`` of ``a``, ``b`` and the result), run at dp = 1 and tp = 1's
    batch count: inside a :func:`row_share` the slots padded to the whole
    batch's (:func:`whole_batch`), under ``tp`` (``TpHints``) the heads
    padded to tp = 1's (``pad_heads``) and the rank's heads of the result
    kept. cuBLAS picks a batched product's algorithm by its batch count,
    so each output is then reduced as in the dp = 1, tp = 1 product."""
    B = a.shape[0]
    n = whole_batch(B)
    if n is not None:
        a, b = pad_batch(a, n), pad_batch(b, n)
    if tp is not None:
        a, b = tp.pad_heads(a, heads[0]), tp.pad_heads(b, heads[1])
    out = torch.einsum(eq, a, b)
    if tp is not None:
        out = tp.own_heads(out, heads[2])
    return out if n is None else out[:B]


def _handle() -> _Lt:
    global _lt
    if _lt is None:
        with _lt_lock:
            if _lt is None:
                _lt = _Lt()
    return _lt


def _weight_op(w: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """(w, op) for a [K, N] weight: row-major as stored, or column-major
    (the int8 projections' layout, kept by their dequantized copy)."""
    K, N = w.shape
    if w.stride() == (N, 1) or N == 1:
        return w, _OP_N
    if w.stride() == (1, K) or K == 1:
        return w, _OP_T
    return w.contiguous(), _OP_N


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a fresh copy when its data does not start on the 256-byte
    boundary cuBLASLt's heuristics assume by default (a view at an
    offset; the allocator's own blocks are aligned)."""
    return t if t.data_ptr() % 256 == 0 else t.clone()


def matmul(x: torch.Tensor, w: torch.Tensor, n_full: Optional[int] = None,
           tps: Tuple[int, ...] = TP_WIDTHS) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` on the card, in bf16 with f32
    accumulation or in f32, by the algorithm pinned for (M, K,
    ``n_full``, ``tps``, dtype): ``w`` holds a share of the columns of an
    ``n_full``-wide weight (default N, the whole), and the algorithm runs
    every 1 / tp share for tp in ``tps`` (the tps the model admits). M =
    the rows of ``x`` flattened; inside :func:`row_share` the rows of the
    whole batch. Raises for anything but bf16 or f32 CUDA tensors of one
    dtype, and inside a row share for an M that is not a whole number of
    rows per item."""
    if not (x.is_cuda and w.is_cuda and x.dtype == w.dtype
            and x.dtype in _DATA_TYPE and w.dim() == 2
            and x.shape[-1] == w.shape[0]):
        raise ValueError(f"lt_gemm.matmul takes bf16 CUDA or f32 CUDA x "
                         f"[..., K] and w [K, N] of one dtype; got {x.dtype} "
                         f"{tuple(x.shape)} on {x.device}, {w.dtype} "
                         f"{tuple(w.shape)} on {w.device}")
    lead = x.shape[:-1]
    N = w.shape[1]
    if x.numel() == 0:
        return x.new_empty(*lead, N)
    x2 = _aligned(x.reshape(-1, x.shape[-1]).contiguous())
    w, op = _weight_op(w)
    M, m_full = x2.shape[0], x2.shape[0]
    items = shared_items()
    if items is not None:
        mine, total = items
        if M % mine:
            raise ValueError(f"lt_gemm.matmul: {M} rows are not a whole "
                             f"number of rows for each of {mine} items")
        m_full = M // mine * total
    y = _handle().matmul(x2, _aligned(w), op, n_full or N, tuple(tps),
                         m_full)
    host_hooks.host_callback(_count)
    return y.reshape(*lead, N)


def _count() -> None:
    """One call: at once, or at every replay of a captured wave that
    holds it (``ops/host_hooks.host_callback``)."""
    global launches
    launches += 1


def algorithm(M: int, K: int, N: int, n_full: Optional[int] = None,
              column_major: bool = False,
              tps: Tuple[int, ...] = TP_WIDTHS,
              dtype: torch.dtype = torch.bfloat16,
              m_full: Optional[int] = None) -> Dict[str, int]:
    """The configuration of the algorithm :func:`matmul` runs for x
    [M, K] @ w [K, N] of ``dtype``, a share of an ``n_full``-wide weight,
    on M of ``m_full`` rows (a dp replica's inside :func:`row_share`);
    raises as :func:`matmul` would (a diagnostic: no product is
    computed)."""
    lt = _handle()
    op = _OP_T if column_major else _OP_N
    dt = _DATA_TYPE[dtype]
    lt.plan(op, M, K, N, n_full or N, tuple(tps), dt, m_full or M)
    return lt.config(lt.pinned[(op, m_full or M, K, n_full or N, tuple(tps),
                                dt)])

