"""ctypes bindings to the port's C++ host core (``native/csrc/``).

Port of seldon_tpu/native/__init__.py. The port keeps its own copies of
the JAX package's C++ sources (``csrc/seldon_native.cc``,
``csrc/dataloader.cc``); at first use ``g++`` builds each into
``build/native/`` at the root of the checkout (listed in ``.gitignore``)
with the JAX ``Makefile``'s flags (``-O3 -fPIC -Wall -std=c++17``, plus
``-pthread`` for the loader). The library's file name carries a hash of
its source and flags, so an edited source is rebuilt and a stale library
is never loaded; nothing is ever built into ``native/``, where the JAX
package builds.

The numpy functions are the plain versions. Where the JAX module quietly
drops to numpy when the build or the load fails, the port raises, unless
the caller asks for numpy with ``force_fallback=True``. Routes that the
JAX module takes by the data stay as they are: ``fuse_rows`` of mixed
dtypes or trailing shapes goes through ``np.concatenate`` (which promotes
or raises). ``HAVE_NATIVE`` is computed on first access: True when the
library builds and loads here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"

CXX_FLAGS = ("-O3", "-fPIC", "-Wall", "-std=c++17", "-shared")
# Library name -> (source, extra flags), as the JAX Makefile builds them.
SOURCES: Dict[str, tuple] = {
    "libseldon_native.so": ("seldon_native.cc", ()),
    "libseldon_dataloader.so": ("dataloader.cc", ("-pthread",)),
    # The port's own: the zstd decoder and CRC-32C of servers/zstd.py.
    "libseldon_zstd.so": ("zstd_decode.cc", ()),
}

_lock = threading.Lock()  # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lib: "ctypes.CDLL | None" = None


def _lib_path(so_name: str) -> Path:
    src, extra = SOURCES[so_name]
    h = hashlib.sha256((CSRC / src).read_bytes())
    h.update(" ".join(CXX_FLAGS + extra).encode())
    stem = so_name[:-len(".so")]
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}.so"


def load_native_lib(so_name: str) -> ctypes.CDLL:
    """Build ``so_name`` from ``csrc/`` into ``build/native/`` when no
    library of the current source exists, then CDLL-load it. Raises when
    the build or the load fails (the JAX helper returns None). One load
    per process; thread-safe, concurrent processes build atomically."""
    if so_name not in SOURCES:
        raise ValueError(f"unknown native library {so_name!r}; have "
                         f"{sorted(SOURCES)}")
    with _lock:
        name_lock = _name_locks.setdefault(so_name, threading.Lock())
    with name_lock:
        if so_name in _libs:
            return _libs[so_name]
        out = _lib_path(so_name)
        if not out.exists():
            src, extra = SOURCES[so_name]
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cxx = os.environ.get("CXX", "g++")
            cmd = [cxx, *CXX_FLAGS, *extra, "-o", str(tmp), str(CSRC / src)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True,
                                      timeout=120)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise RuntimeError(f"building {so_name} failed: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{cxx} failed ({proc.returncode}) building {so_name}:\n"
                    f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: readers never see half a file
        _libs[so_name] = ctypes.CDLL(str(out))
        return _libs[so_name]


def _load() -> ctypes.CDLL:
    """``libseldon_native.so`` with its argument types declared; raises
    when it cannot be built or loaded or its ABI is not 1."""
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native_lib("libseldon_native.so")
    lib.seldon_native_abi_version.restype = ctypes.c_int32
    if lib.seldon_native_abi_version() != 1:
        raise RuntimeError("libseldon_native.so ABI is not 1")
    lib.seldon_f32_to_bf16.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.c_int64,
    ]
    lib.seldon_bf16_to_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint16),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.seldon_batch_fuse.restype = ctypes.c_int64
    lib.seldon_batch_fuse.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.c_void_p,
    ]
    lib.seldon_batch_split.restype = ctypes.c_int64
    lib.seldon_batch_split.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_void_p),
    ]
    _lib = lib
    return lib


def __getattr__(name: str):
    if name == "HAVE_NATIVE":
        try:
            _load()
        except (OSError, RuntimeError):
            return False
        return True
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def f32_to_bf16(arr: np.ndarray, force_fallback: bool = False) -> np.ndarray:
    """f32 array -> bf16 bit pattern as uint16 (round-to-nearest-even)."""
    arr = np.ascontiguousarray(arr, dtype=np.float32)
    if force_fallback:
        bits = arr.view(np.uint32)
        lsb = (bits >> 16) & 1
        rounded = ((bits + 0x7FFF + lsb) >> 16).astype(np.uint16)
        # NaN guard (same as the C path): don't round NaN payloads to inf.
        is_nan = (bits & 0x7FFFFFFF) > 0x7F800000
        return np.where(
            is_nan, ((bits >> 16) | 0x0040).astype(np.uint16), rounded
        )
    lib = _load()
    out = np.empty(arr.shape, dtype=np.uint16)
    lib.seldon_f32_to_bf16(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        arr.size,
    )
    return out


def bf16_to_f32(arr: np.ndarray, force_fallback: bool = False) -> np.ndarray:
    """uint16 bf16 bit pattern -> f32."""
    arr = np.ascontiguousarray(arr, dtype=np.uint16)
    if force_fallback:
        return (arr.astype(np.uint32) << 16).view(np.float32).reshape(
            arr.shape)
    lib = _load()
    out = np.empty(arr.shape, dtype=np.float32)
    lib.seldon_bf16_to_f32(
        arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        arr.size,
    )
    return out


def fuse_rows(arrays: Sequence[np.ndarray],
              force_fallback: bool = False) -> np.ndarray:
    """Concatenate row-batches along axis 0 (native memcpy path)."""
    arrays = [np.ascontiguousarray(a) for a in arrays]
    if force_fallback or not arrays:
        return np.concatenate(arrays, axis=0)
    dtype = arrays[0].dtype
    trailing = arrays[0].shape[1:]
    if any(a.dtype != dtype or a.shape[1:] != trailing for a in arrays):
        return np.concatenate(arrays, axis=0)  # mixed: numpy handles errors
    lib = _load()
    total_rows = sum(a.shape[0] for a in arrays)
    out = np.empty((total_rows, *trailing), dtype=dtype)
    srcs = (ctypes.c_void_p * len(arrays))(
        *[a.ctypes.data_as(ctypes.c_void_p).value for a in arrays]
    )
    sizes = (ctypes.c_int64 * len(arrays))(*[a.nbytes for a in arrays])
    written = lib.seldon_batch_fuse(
        srcs, sizes, len(arrays), out.ctypes.data_as(ctypes.c_void_p)
    )
    assert written == out.nbytes, (written, out.nbytes)
    return out


def split_rows(arr: np.ndarray, row_counts: Sequence[int],
               force_fallback: bool = False) -> List[np.ndarray]:
    """Split a fused batch back into per-request row groups (copies;
    native memcpy unless ``force_fallback``)."""
    arr = np.ascontiguousarray(arr)
    if sum(row_counts) != arr.shape[0]:
        raise ValueError(
            f"row_counts {row_counts} do not sum to batch {arr.shape[0]}"
        )
    trailing = arr.shape[1:]
    outs = [np.empty((n, *trailing), dtype=arr.dtype) for n in row_counts]
    if force_fallback:
        row = 0
        for n, o in zip(row_counts, outs):
            o[...] = arr[row: row + n]
            row += n
        return outs
    lib = _load()
    dsts = (ctypes.c_void_p * len(outs))(
        *[o.ctypes.data_as(ctypes.c_void_p).value for o in outs]
    )
    sizes = (ctypes.c_int64 * len(outs))(*[o.nbytes for o in outs])
    consumed = lib.seldon_batch_split(
        arr.ctypes.data_as(ctypes.c_void_p), sizes, len(outs), dsts
    )
    assert consumed == arr.nbytes, (consumed, arr.nbytes)
    return outs
