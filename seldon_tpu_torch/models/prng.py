"""JAX's default PRNG (threefry 2x32) in PyTorch integer ops.

The JAX package draws its sampling noise from ``jax.random`` with the
default implementation, threefry 2x32 in the ``jax_threefry_partitionable``
scheme (the default of jax 0.9): a key is a pair of uint32 words,
``fold_in`` and ``split`` hash counters under it, and ``random_bits`` of
shape ``S`` hashes the pair (high, low) 32-bit halves of each element's
linear index under the key and XORs the two output words. This module
computes the same bits, so the port's sampled tokens can equal the JAX
package's: ``key``, ``fold_in``, ``split``, ``random_bits`` and the
threefry hash are bit-equal to ``jax.random``; ``uniform`` follows
``jax.random.uniform`` op for op and is bit-equal on [0, 1) and
[tiny, 1) (the ranges sampling uses); ``gumbel`` (``mode="low"``, JAX's
default) takes ``-log(-log(u))`` of that uniform, where each ``log`` may
round one ulp away from XLA's.

PyTorch has no uint32 arithmetic on every device, so words live in
int64 tensors holding values in [0, 2**32): sums are masked back to 32
bits and rotations are written out as two shifts. A key is an int64
tensor ``[..., 2]``; every function takes a batch of keys in its leading
dimensions and runs on the keys' device without waiting for it.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

M32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = torch.finfo(torch.float32).tiny


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The threefry 2x32 hash of counter words (x1, x2) under key words
    (k1, k2), all int64 holding uint32 values and broadcast together: 20
    rounds with a key injection after every four, as JAX's unrolled
    lowering (``_threefry2x32_lowering``). The rounds update two work
    tensors in place (a fresh tensor per op would cost several times the
    time on the CPU)."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, y = torch.broadcast_tensors((x1 + ks[0]) & M32, (x2 + ks[1]) & M32)
    x0, y = x0.contiguous(), y.contiguous()
    if x0.data_ptr() == y.data_ptr():
        y = y.clone()
    rot = torch.empty_like(y)
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0.add_(y).bitwise_and_(M32)
            # y = rotl(y, r) ^ x0
            torch.bitwise_left_shift(y, r, out=rot).bitwise_and_(M32)
            y.bitwise_right_shift_(32 - r).bitwise_or_(rot).bitwise_xor_(x0)
        x0.add_(ks[(i + 1) % 3]).bitwise_and_(M32)
        y.add_(ks[(i + 2) % 3] + (i + 1)).bitwise_and_(M32)
    return x0, y


def threefry_2x32(keypair: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """JAX's ``prng.threefry_2x32``: the hash of a flat uint32 ``count``
    under one key ``[2]``; the count is cut into two halves (padded with
    a zero when odd) that are the two counter words."""
    flat = count.reshape(-1).to(torch.int64) & M32
    n = flat.shape[0]
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    x1, x2 = flat.chunk(2)
    y1, y2 = threefry2x32(keypair[0], keypair[1], x1, x2)
    return torch.cat([y1, y2])[:n].reshape(count.shape)


def threefry_seed(seed: torch.Tensor) -> torch.Tensor:
    """Raw keys ``[..., 2]`` of uint32 seeds (``jax.random.key`` of a
    32-bit seed: the high word is 0, the low word the seed)."""
    lo = seed.to(torch.int64) & M32
    return torch.stack([torch.zeros_like(lo), lo], dim=-1)


key = threefry_seed


def fold_in(keys: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``jax.random.fold_in`` of keys ``[..., 2]`` with uint32 ``data``
    ``[...]``: the hash of the counter pair (0, data) is the new key."""
    d = data.to(torch.int64) & M32
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def _iota_2x32(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                       torch.Tensor]:
    """(high, low) 32-bit words of each element's linear index."""
    n = 1
    for d in shape:
        n *= int(d)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & M32


def _hash_shape(keys: torch.Tensor, shape: Sequence[int]):
    """Both threefry words of every element of ``shape`` under each key:
    ``[..., *shape]`` each."""
    hi, lo = _iota_2x32(shape, keys.device)
    extra = (None,) * len(shape)
    k1 = keys[(..., 0) + extra]
    k2 = keys[(..., 1) + extra]
    return threefry2x32(k1, k2, hi, lo)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (the partitionable, fold-like scheme): keys
    ``[..., 2]`` -> ``[..., num, 2]``."""
    y1, y2 = _hash_shape(keys, (num,))
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32-bit ``jax.random.bits``: ``[..., *shape]`` int64 words, the XOR
    of the two threefry words of each element's index."""
    y1, y2 = _hash_shape(keys, tuple(shape))
    return y1 ^ y2


def _uniform_from_bits(bits: torch.Tensor, minval: float,
                       maxval: float) -> torch.Tensor:
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
        torch.float32) - 1.0
    lo = torch.tensor(minval, dtype=torch.float32)
    span = float(torch.tensor(maxval, dtype=torch.float32) - lo)
    return torch.clamp(floats * span + float(lo), min=float(lo))


def uniform(keys: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """f32 ``jax.random.uniform``: the top 23 bits of each word as the
    mantissa of a float in [1, 2), minus 1, scaled to [minval, maxval)
    and floored at minval (``_uniform``, op for op). XLA fuses the scale
    and shift into one multiply-add; for a span of 1 (``[0, 1)``,
    ``[tiny, 1)``) the product is exact and both round alike."""
    return _uniform_from_bits(random_bits(keys, shape), minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """The Gumbel values :func:`gumbel` makes of ``random_bits``."""
    return -torch.log(-torch.log(_uniform_from_bits(bits, F32_TINY, 1.0)))


def gumbel(keys: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """f32 ``jax.random.gumbel`` in its default ``mode="low"``:
    ``-log(-log(u))`` of a uniform in [tiny, 1)."""
    return gumbel_from_bits(random_bits(keys, shape))
