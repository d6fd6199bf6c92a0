"""Host payload helpers of the orchestrator's micro-batcher.

Port of `fuse_rows` and `split_rows` of seldon_tpu/native/__init__.py,
in numpy: the JAX module's own path when its native library is absent
(`np.concatenate` and row slices), which gives the same bytes as its
memcpy path. Binding `libseldon_native.so` through ctypes is still to be
ported (ROADMAP.md A22)."""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def fuse_rows(arrays: Sequence[np.ndarray]) -> np.ndarray:
    """Concatenate row-batches along axis 0."""
    return np.concatenate([np.ascontiguousarray(a) for a in arrays], axis=0)


def split_rows(arr: np.ndarray, row_counts: Sequence[int]) -> List[np.ndarray]:
    """Split a fused batch back into per-request row groups (copies)."""
    arr = np.ascontiguousarray(arr)
    if sum(row_counts) != arr.shape[0]:
        raise ValueError(
            f"row_counts {row_counts} do not sum to batch {arr.shape[0]}"
        )
    outs = [np.empty((n, *arr.shape[1:]), dtype=arr.dtype) for n in row_counts]
    row = 0
    for n, o in zip(row_counts, outs):
        o[...] = arr[row: row + n]
        row += n
    return outs
