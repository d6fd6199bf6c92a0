"""Token-shard data loader — native prefetch with a bit-identical numpy path.

Port of seldon_tpu/data/loader.py. The training step consumes [B, S+1]
next-token windows. The native loader (``native/csrc/dataloader.cc``,
built into ``build/native/`` by ``seldon_tpu_torch.native``) mmaps raw
little-endian uint32 shards and prefetches batches on a background C++
thread so the host never stalls a step on slicing; the numpy path
implements the SAME splitmix64 window sampling, so streams are
bit-identical across backends (tested) and a run can move between
machines with or without the native library without changing its data
order.

Where the JAX loader quietly drops to numpy when the library is missing
or rejects the shards, this one raises; ``force_fallback=True`` selects
the numpy path, as in JAX.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Sequence

import numpy as np

from seldon_tpu_torch.native import load_native_lib

_lib: Optional[ctypes.CDLL] = None


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 (must match dataloader.cc exactly)."""
    x = (x + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _native() -> ctypes.CDLL:
    """The loader library with its argument types declared; raises when
    it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    lib = load_native_lib("libseldon_dataloader.so")
    lib.seldon_loader_create.restype = ctypes.c_void_p
    lib.seldon_loader_create.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_uint64, ctypes.c_int64,
    ]
    lib.seldon_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.seldon_loader_total_tokens.restype = ctypes.c_int64
    lib.seldon_loader_total_tokens.argtypes = [ctypes.c_void_p]
    lib.seldon_loader_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def write_token_shard(path: str, tokens: Sequence[int]) -> str:
    """Raw little-endian uint32 token file — the shard format."""
    arr = np.asarray(tokens, dtype="<u4")
    arr.tofile(path)
    return path


class TokenDataLoader:
    """Iterator of [batch, seq_len+1] int32 windows over token shards.

    Sampling: row r of batch i starts at
    `splitmix64(seed ^ (i*B + r)) % (n_tokens - seq_len - 1)` —
    deterministic, backend-independent, and random-access (no epoch
    state to checkpoint; resume = remember the batch counter).
    """

    def __init__(self, paths: Sequence[str], batch_size: int, seq_len: int,
                 seed: int = 0, prefetch: int = 4,
                 force_fallback: bool = False):
        self.paths = [os.path.abspath(p) for p in paths]
        self.batch_size = int(batch_size)
        self.seq_len = int(seq_len)
        self.seed = np.uint64(seed)
        self._i = 0
        self._handle = None
        self._tokens: Optional[np.ndarray] = None

        if not force_fallback:
            lib = _native()
            blob = b"".join(
                p.encode() + b"\x00" for p in self.paths
            ) + b"\x00"
            handle = lib.seldon_loader_create(
                blob, self.batch_size, self.seq_len,
                ctypes.c_uint64(seed), prefetch,
            )
            if not handle:
                raise ValueError(
                    f"native loader rejected the shards {self.paths}: a "
                    "file is missing, unreadable or shorter than one "
                    f"token, or the corpus is smaller than one window "
                    f"({self.seq_len + 1})")
            self._handle = ctypes.c_void_p(handle)
            self._lib = lib
            self.total_tokens = int(
                lib.seldon_loader_total_tokens(self._handle)
            )
            return
        # numpy path: concatenate shards in memory (fine for tests/small
        # corpora; the native path is the production one).
        parts = [np.fromfile(p, dtype="<u4") for p in self.paths]
        self._tokens = np.concatenate(parts) if parts else np.zeros(0, "<u4")
        self.total_tokens = int(self._tokens.size)
        if self.total_tokens < self.seq_len + 2:
            raise ValueError(
                f"corpus of {self.total_tokens} tokens is smaller than one "
                f"window ({self.seq_len + 1})"
            )

    @property
    def native(self) -> bool:
        return self._handle is not None

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        out = np.empty((self.batch_size, self.seq_len + 1), np.int32)
        if self._handle is not None:
            self._lib.seldon_loader_next(
                self._handle,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        else:
            B, S1 = self.batch_size, self.seq_len + 1
            idx = np.arange(B, dtype=np.uint64) + np.uint64(self._i * B)
            offs = _splitmix64(self.seed ^ idx) % np.uint64(
                self.total_tokens - S1
            )
            for r, off in enumerate(offs):
                out[r] = self._tokens[int(off): int(off) + S1]
        self._i += 1
        return out

    def close(self) -> None:
        """Stop and join the prefetch thread and unmap the shards."""
        if self._handle is not None:
            self._lib.seldon_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover - gc path
        try:
            self.close()
        except Exception:
            pass
