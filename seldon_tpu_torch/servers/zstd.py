"""Zstandard frames: the port's own decoder and a raw-block encoder.

Orbax checkpoints hold every zarr chunk and every OCDBT node as a zstd
frame (RFC 8878). The port reads them with its own decoder,
``native/csrc/zstd_decode.cc``, built by ``g++`` at first use into
``build/native/`` and loaded with ``ctypes`` (``native.load_native_lib``).
A failed build or load raises; there is no other decoder to fall back to.
The same library computes CRC-32C, the checksum of OCDBT's manifests and
nodes.

:func:`raw_frame_parts` writes the simplest frame RFC 8878 defines: the
content as raw (stored) blocks of at most 128 KiB, with the content size
in the header and a 128 KiB window, which every conforming decoder reads.
"""

from __future__ import annotations

import ctypes
import struct
from typing import Iterator, Optional

import numpy as np

from seldon_tpu_torch import native

BLOCK_MAX = 128 * 1024
MAGIC = 0xFD2FB528

_lib: Optional[ctypes.CDLL] = None


class ZstdError(ValueError):
    """A frame the decoder refuses: malformed, truncated, a checksum
    mismatch, or a dictionary."""


class OutputTooSmall(ZstdError):
    """The frames decode to more bytes than the output buffer holds."""


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = native.load_native_lib("libseldon_zstd.so")
    lib.seldon_zstd_abi_version.restype = ctypes.c_int32
    if lib.seldon_zstd_abi_version() != 1:
        raise RuntimeError("libseldon_zstd.so ABI is not 1")
    lib.seldon_zstd_last_error.restype = ctypes.c_char_p
    lib.seldon_zstd_decompress.restype = ctypes.c_int64
    lib.seldon_zstd_decompress.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.seldon_zstd_content_size.restype = ctypes.c_int64
    lib.seldon_zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.seldon_crc32c.restype = ctypes.c_uint32
    lib.seldon_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                  ctypes.c_uint32]
    _lib = lib
    return lib


def _src(data) -> np.ndarray:
    """``data`` (bytes-like or a numpy array) as a flat uint8 view."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    return np.frombuffer(data, np.uint8)


def content_size(data) -> Optional[int]:
    """The sum of the frames' content sizes, or None when a frame does
    not state it."""
    lib = _load()
    src = _src(data)
    n = lib.seldon_zstd_content_size(src.ctypes.data, src.size)
    if n == -2:
        raise ZstdError(lib.seldon_zstd_last_error().decode())
    return None if n < 0 else int(n)


def decompress_into(data, out: np.ndarray) -> int:
    """Decode every frame of ``data`` into ``out`` (a C-contiguous numpy
    array, any dtype) and return the bytes written. Raises
    :class:`ZstdError` when a frame is refused (:class:`OutputTooSmall`
    when it decodes to more than ``out`` holds)."""
    lib = _load()
    src = _src(data)
    if not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous")
    n = lib.seldon_zstd_decompress(src.ctypes.data, src.size,
                                   out.ctypes.data, out.nbytes)
    if n == -2:
        raise OutputTooSmall(f"frames decode to more than {out.nbytes} "
                             "bytes")
    if n < 0:
        raise ZstdError(lib.seldon_zstd_last_error().decode())
    return int(n)


def decompress(data, size: Optional[int] = None) -> bytes:
    """Decode every frame of ``data``. ``size`` is the exact decoded size
    when the caller knows it (a zarr chunk's); otherwise the frames'
    stated content size, or a buffer grown until the frames fit."""
    want = size if size is not None else content_size(data)
    cap = want if want is not None else max(4 * len(data), 1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        try:
            n = decompress_into(data, out)
        except OutputTooSmall:
            if want is not None:
                raise
            cap *= 4
            continue
        if size is not None and n != size:
            raise ZstdError(f"frames decode to {n} bytes, expected {size}")
        return out[:n].tobytes()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of ``data``, continued from ``crc``."""
    src = _src(data)
    return int(_load().seldon_crc32c(src.ctypes.data, src.size, crc))


def raw_frame_parts(data) -> Iterator[memoryview]:
    """The pieces of one zstd frame holding ``data`` in raw blocks, in
    order, without copying ``data``: the frame header (content size, a
    128 KiB window, no checksum), then each block's 3-byte header and its
    slice of ``data``."""
    mv = memoryview(_src(data)).cast("B")
    n = len(mv)
    # Descriptor: 8-byte content size, not single-segment, no checksum, no
    # dictionary; window descriptor 0x38 = 2**17 bytes.
    yield memoryview(struct.pack("<IBBQ", MAGIC, 0xC0, 0x38, n))
    at = 0
    while True:
        size = min(BLOCK_MAX, n - at)
        last = at + size == n
        yield memoryview(struct.pack("<I", (size << 3) | int(last))[:3])
        if size:
            yield mv[at:at + size]
        at += size
        if last:
            return


def raw_frame_size(n: int) -> int:
    """The bytes of :func:`raw_frame_parts`' frame for ``n`` bytes."""
    return 14 + 3 * max(1, -(-n // BLOCK_MAX)) + n
