"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface, at first use, into
``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). The library's file name carries a hash of its source,
of every header under ``csrc/`` and of the compiler flags, so an edited
source or header is rebuilt and a stale library is never loaded. The
library is loaded with ``ctypes``; callers declare the argument types.

A build that fails raises: there is no fallback to a plain version.
:func:`check_tensor` is the wrappers' shared check of what they hand a
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)
HEADER_SUFFIXES = (".cuh", ".h")

_lock = threading.Lock()  # guards _name_locks
_name_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}
# Per source: seconds the last build took (0.0 when a cached library was
# loaded) and nvcc's output, ptxas' register / spill report included.
build_seconds: Dict[str, float] = {}
build_log: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on PATH, or the
    toolkit's default location."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        shutil.which("nvcc") or "",
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def _lib_path(name: str, src: Path) -> Path:
    """The library of ``src`` at its current content: the hash covers the
    source, every header a source under ``csrc/`` can include (``*.cuh``,
    ``*.h``; names and bytes) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(p for p in CSRC.iterdir()
                      if p.suffix in HEADER_SUFFIXES):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str) -> ctypes.CDLL:
    """Load ``csrc/<name>.cu`` as a library, building it first when no
    library of the current source exists. Thread-safe, one load per
    process; different sources build in parallel when loaded from
    several threads."""
    with _lock:
        name_lock = _name_locks.setdefault(name, threading.Lock())
    with name_lock:
        if name in _libs:
            return _libs[name]
        src = CSRC / f"{name}.cu"
        out = _lib_path(name, src)
        if out.exists():
            build_seconds[name] = 0.0
        else:
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds[name] = time.perf_counter() - t0
            build_log[name] = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) building {src}:\n"
                    f"{build_log[name]}"
                )
            os.replace(tmp, out)  # atomic: readers never see half a file
        _libs[name] = ctypes.CDLL(str(out))
        return _libs[name]


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                 shape: Tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, contiguous and 16-byte aligned."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
