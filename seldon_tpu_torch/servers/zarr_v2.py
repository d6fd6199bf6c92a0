"""zarr v2 arrays on a key-value store, as orbax writes them.

Each array ``<name>`` of an orbax checkpoint is a ``<name>/.zarray`` JSON
document and one value per chunk, ``<name>/<i>.<j>...`` (chunk indices
joined by ``dimension_separator``; ``0`` for a 0-d array), each chunk a
zstd frame of the chunk's C-order bytes (edge chunks are stored at the
full chunk shape). :class:`ZarrStore` reads what orbax writes: ``dtype``
``bfloat16`` (returned as its ``uint16`` bit pattern), ``<f4`` or ``|i1``;
the ``zstd`` compressor or none; ``order`` C; ``dimension_separator``
"."; no filters; ``fill_value`` null. Anything else is refused by name.
:func:`zarray` writes the same document.
"""

from __future__ import annotations

import itertools
import json
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from seldon_tpu_torch.servers import zstd

# zarr dtype -> the numpy dtype the bytes are read as (bf16 as its bits).
DTYPES = {"bfloat16": np.dtype(np.uint16), "<f4": np.dtype(np.float32),
          "|i1": np.dtype(np.int8)}


class ZarrError(ValueError):
    """An array the reader refuses: a format, dtype, compressor, order,
    separator, filter or fill value it does not read, or a chunk of the
    wrong size."""


@dataclass(frozen=True)
class ArrayMeta:
    name: str
    shape: Tuple[int, ...]
    chunks: Tuple[int, ...]
    dtype: str
    compressed: bool

    @property
    def np_dtype(self) -> np.dtype:
        return DTYPES[self.dtype]

    def grid(self) -> Tuple[int, ...]:
        return tuple(-(-s // c) for s, c in zip(self.shape, self.chunks))


def parse_zarray(name: str, doc: bytes) -> ArrayMeta:
    """The metadata of array ``name`` from its ``.zarray``; raises
    :class:`ZarrError` naming whatever it does not read."""
    m = json.loads(doc)

    def refuse(what):
        raise ZarrError(f"array {name!r}: {what} is not supported")

    if m.get("zarr_format") != 2:
        refuse(f"zarr_format {m.get('zarr_format')!r}")
    if m.get("dtype") not in DTYPES:
        refuse(f"dtype {m.get('dtype')!r}")
    if m.get("order", "C") != "C":
        refuse(f"order {m.get('order')!r}")
    if m.get("dimension_separator", ".") != ".":
        refuse(f"dimension_separator {m.get('dimension_separator')!r}")
    if m.get("filters") is not None:
        refuse(f"filters {m.get('filters')!r}")
    if m.get("fill_value") is not None:
        refuse(f"fill_value {m.get('fill_value')!r}")
    comp = m.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        refuse(f"compressor {comp!r}")
    shape, chunks = tuple(m["shape"]), tuple(m["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ZarrError(f"array {name!r}: chunks {chunks} do not fit shape "
                        f"{shape}")
    return ArrayMeta(name, shape, chunks, m["dtype"], comp is not None)


def zarray(shape, dtype: str) -> bytes:
    """The ``.zarray`` of a one-chunk zstd-compressed array, as
    tensorstore writes it."""
    if dtype not in DTYPES:
        raise ZarrError(f"dtype {dtype!r} is not supported")
    doc = {"chunks": list(shape),
           "compressor": {"id": "zstd", "level": 1},
           "dimension_separator": ".", "dtype": dtype, "fill_value": None,
           "filters": None, "order": "C", "shape": list(shape),
           "zarr_format": 2}
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def chunk_key(name: str, idx) -> str:
    return f"{name}/{'.'.join(map(str, idx)) if len(idx) else '0'}"


class ZarrStore:
    """The zarr v2 arrays of a key-value store with ``read(key)`` and
    ``view(key)`` (an :class:`~seldon_tpu_torch.servers.ocdbt.OcdbtReader`)."""

    def __init__(self, kv):
        self.kv = kv

    def meta(self, name: str) -> ArrayMeta:
        return parse_zarray(name, self.kv.read(f"{name}/.zarray"))

    def _chunk(self, meta: ArrayMeta, idx, out: np.ndarray) -> None:
        """Chunk ``idx`` decoded into ``out`` (its full chunk shape)."""
        key = chunk_key(meta.name, idx)
        try:
            raw = self.kv.view(key)
        except KeyError:
            raise ZarrError(f"array {meta.name!r}: chunk {key!r} is missing "
                            "(fill_value null)") from None
        if meta.compressed:
            n = zstd.decompress_into(raw, out)
        else:
            n = raw.size
            if n == out.nbytes:
                out.reshape(-1).view(np.uint8)[:] = raw
        if n != out.nbytes:
            raise ZarrError(f"array {meta.name!r}: chunk {key!r} holds {n} "
                            f"bytes, its shape {meta.chunks} needs "
                            f"{out.nbytes}")

    def read(self, name: str, cols: Optional[Tuple[int, int]] = None
             ) -> np.ndarray:
        """Array ``name`` (bf16 as ``uint16`` bits), or only columns
        ``[lo, hi)`` of its last axis: only the chunks those columns
        touch are decoded, one at a time."""
        meta = self.meta(name)
        shape = meta.shape
        if not shape:
            out = np.empty((), meta.np_dtype)
            self._chunk(meta, (), out)
            return out
        lo, hi = (0, shape[-1]) if cols is None else cols
        if not 0 <= lo <= hi <= shape[-1]:
            raise ValueError(f"columns [{lo}, {hi}) outside {shape}")
        out = np.empty(shape[:-1] + (hi - lo,), meta.np_dtype)
        if meta.chunks == shape and (lo, hi) == (0, shape[-1]):
            self._chunk(meta, (0,) * len(shape), out)  # no staging copy
            return out
        buf = np.empty(meta.chunks, meta.np_dtype)
        for idx in itertools.product(*(range(g) for g in meta.grid())):
            start = [i * c for i, c in zip(idx, meta.chunks)]
            stop = [min(s + c, n) for s, c, n in zip(start, meta.chunks,
                                                     shape)]
            a, b = max(start[-1], lo), min(stop[-1], hi)
            if a >= b:
                continue
            start[-1], stop[-1] = a, b
            self._chunk(meta, idx, buf)
            src = tuple(slice(s - i * c, e - i * c) for s, e, i, c in
                        zip(start, stop, idx, meta.chunks))
            dst = tuple(slice(s, e) for s, e in zip(start[:-1], stop[:-1]))
            out[dst + (slice(a - lo, b - lo),)] = buf[src]
        return out
