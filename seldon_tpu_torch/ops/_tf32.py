"""The 3xTF32 split, and the plain arithmetic of the f32 tensor-core kernels.

The f32 routes of the port's attention kernels run their products on
Hopper's tensor cores in TF32 (10 explicit mantissa bits) at f32
accuracy: ``csrc/ragged_paged_attention_f32.cu`` from 64 query rows up
(kernel B1) and ``csrc/flash_attention_f32.cu`` (kernel B2), both on
``csrc/hopper_tf32.cuh``. Each f32 operand ``x`` is split as
``hi = rna(x)``, ``lo = rna(x - hi)`` (:func:`tf32_split`; ``rna`` is
``cvt.rna.tf32.f32``: round to nearest on the 13 dropped bits, ties away
from zero), and a product ``x y`` is summed as ``lo_x hi_y + hi_x lo_y +
hi_x hi_y``, the small terms first; only ``lo_x lo_y`` (~2**-22 of the
product) is dropped. An int8 code is exact in TF32 and has no ``lo``.

:func:`partials_3xtf32` and :func:`flash_3xtf32` are plain PyTorch
versions of the two kernels' arithmetic built from that split: the same
terms in the same order, f32 sums, over the kernels' steps: the scores
over each quarter of Dh in a chain of its own, the quarters summed in
f32; B1 in steps of 32 positions, each step's value product in a fresh
accumulator folded in as ``acc * alpha + step``; B2 in the Pallas
blocks of 128 positions with their rescaling points, each 32-position
sub-tile's value product in a fresh accumulator added to ``acc``. (The
tensor cores' own accumulation inside a chain is not IEEE
round-to-nearest; the kernels keep their chains short for that reason,
and the card's gates, not this module, hold them to their tolerances.)
They run on any device and are no part of a serving
path: the CPU tests hold them against the JAX package's f32 functions,
which shows off the card that the design's arithmetic meets the kernels'
tolerances. The kernels themselves are held on the card against the plain
versions that the serving path uses (``partials_sparse``,
``flash_blockwise``), which run in true f32 with no TF32 anywhere.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

NEG_INF = -1e30
STEP = 32  # B1's positions per step; B2's sub-tile
BLOCK_K = 128  # B2's KV block: the Pallas block_k

_MASK = 0xFFFFE000  # an f32 bit pattern's sign, exponent and 10 bits


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: half of
    the dropped 13 bits' unit is added to the magnitude's bit pattern and
    the 13 bits are cleared (ties away from zero; signed zeros kept)."""
    if x.dtype != torch.float32:
        raise TypeError(f"tf32_round takes float32, got {x.dtype}")
    u = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    u = (u + 0x1000) & _MASK
    return (u - ((u >> 31) << 32)).to(torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: ``hi = rna(x)``, ``lo = rna(x - hi)``, each with at
    most 10 explicit mantissa bits; ``x - hi`` is exact in f32, and
    ``|x - hi - lo| <= 2**-22 |x|`` for normal ``x`` whose residual is
    normal."""
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def _chain(a: torch.Tensor, b: torch.Tensor, a_exact: bool,
           b_exact: bool) -> torch.Tensor:
    """``a @ b`` as one of the kernels' chains sums it: ``a_lo b_hi +
    a_hi b_lo + a_hi b_hi`` in f32, the small terms first; an operand
    exact in TF32 (``*_exact``) has no lo term."""
    a_hi, a_lo = (a, None) if a_exact else tf32_split(a)
    b_hi, b_lo = (b, None) if b_exact else tf32_split(b)
    out = None
    for x, y in ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)):
        if x is None or y is None:
            continue
        t = torch.matmul(x, y)
        out = t if out is None else out + t
    return out


def _scores(q: torch.Tensor, kt: torch.Tensor, k_exact: bool):
    """``q @ kt`` (kt: [..., Dh, T]) as the kernels accumulate S: a chain
    over each quarter of Dh (halves at Dh 16) in its own accumulator,
    the quarters summed pairwise in f32."""
    Dh = q.shape[-1]
    n = 4 if Dh // 8 >= 4 else Dh // 8
    w = Dh // n
    parts = [_chain(q[..., i * w:(i + 1) * w], kt[..., i * w:(i + 1) * w, :],
                    False, k_exact) for i in range(n)]
    while len(parts) > 1:
        parts = [parts[i] + parts[i + 1] for i in range(0, len(parts), 2)]
    return parts[0]


Pool = Dict[str, torch.Tensor]


def partials_3xtf32(q: torch.Tensor, pool_layer: Pool, table: torch.Tensor,
                    bound: torch.Tensor):
    """B1's partials ``(m, l, acc)`` as its tensor-core route computes
    them, for f32 queries against an f32 pool or an int8 pool with bf16
    scales. q [B, Sq, Hkv, G, Dh] f32; pool_layer {"k","v"[,"k_scale",
    "v_scale"]} [NB, Hkv, block, (Dh)]; table [B, nbs] int32; bound [B,
    Sq] int32. Returns m, l [B, Hkv, G, Sq, 1] and acc [B, Hkv, G, Sq, Dh],
    f32. Steps of 32 positions (a step may start inside a block): s =
    (q . k) * f32(Dh^-0.5) [* k_scale], masked to NEG_INF past each row's
    bound; the online softmax; ``acc = acc * alpha + (p [* v_scale]) . v``
    with the step's value product summed on its own."""
    B, Sq, Hkv, G, Dh = q.shape
    block = pool_layer["k"].shape[2]
    nbs = table.shape[1]
    quantized = "k_scale" in pool_layer
    dev = q.device
    inv = (torch.ones((), dtype=torch.float32)
           / torch.sqrt(torch.tensor(float(Dh), dtype=torch.float32))).to(dev)
    qr = q.permute(0, 2, 3, 1, 4).reshape(B, Hkv, G * Sq, Dh)
    bnd = bound.long().repeat(1, G)[:, None, :, None]  # [B, 1, G * Sq, 1]
    m = torch.full((B, Hkv, G * Sq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G * Sq, Dh), dtype=torch.float32, device=dev)
    pos_end = min(int(bound.max()) if bound.numel() else 0, nbs * block)
    for t0 in range(0, pos_end, STEP):
        t = torch.arange(t0, t0 + STEP, device=dev)
        in_table = t < nbs * block
        tc = torch.where(in_table, t, 0)
        bids = table.long()[:, tc // block]  # [B, STEP]
        offs = (tc % block)[None, :].expand(B, -1)

        def gather(key):  # [B, Hkv, STEP, (Dh)]
            g = pool_layer[key][bids, :, offs]  # [B, STEP, Hkv, (Dh)]
            g = g.movedim(1, 2)
            keep = in_table.view(1, 1, STEP, *([1] * (g.dim() - 3)))
            return torch.where(keep, g.float(), 0.0)

        kb, vb = gather("k"), gather("v")
        s = _scores(qr, kb.transpose(-1, -2), quantized) * inv
        if quantized:
            s = s * gather("k_scale")[:, :, None, :]
        live = (t[None, None, None, :] < bnd) & in_table
        s = torch.where(live, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.where(live, torch.exp(s - m_new), 0.0)
        pw = p * gather("v_scale")[:, :, None, :] if quantized else p
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _chain(pw, vb, False, quantized)
        m = m_new

    def out(x):
        return x.view(B, Hkv, G, Sq, x.shape[-1])

    return out(m), out(l), out(acc)


def flash_3xtf32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True, q_offset: int = 0,
                 q_per_kv: int = 1) -> torch.Tensor:
    """B2's f32 output as its tensor-core kernel computes it: q [B*H, Sq,
    Dh], k/v [B*Hkv, Skv, Dh] f32, query row b reading KV row b //
    q_per_kv. Blocks of 128 positions with the kernel's rounding points
    (s = (q . k) * f32(Dh^-0.5), masked to NEG_INF; m' = max(m, max s);
    p = exp(s - m'); l = alpha l + sum p; acc *= alpha), each
    32-position sub-tile's value product then added to acc; out = acc /
    max(l, 1e-30)."""
    BH, Sq, Dh = q.shape
    Skv = k.shape[1]
    dev = q.device
    scale = torch.tensor(Dh ** -0.5, dtype=torch.float32, device=dev)
    qg = q.reshape(BH // q_per_kv, q_per_kv, Sq, Dh)
    m = torch.full((*qg.shape[:3], 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(qg.shape, dtype=torch.float32, device=dev)
    qpos = torch.arange(Sq, device=dev)[:, None] + q_offset
    last_col = Skv - 1 if not causal else min(Skv - 1, q_offset + Sq - 1)
    for c0 in range(0, last_col + 1, BLOCK_K):
        c1 = min(c0 + BLOCK_K, Skv)
        subs = range(c0, c1, STEP)
        s = torch.cat([_scores(qg, k[:, None, c:min(c + STEP, c1)]
                               .transpose(-1, -2), False)
                       for c in subs], dim=-1) * scale
        col = torch.arange(c0, c1, device=dev)[None, :]
        if causal:
            s = torch.where(qpos >= col, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha
        for c in subs:
            e = min(c + STEP, c1)
            acc = acc + _chain(p[..., c - c0:e - c0], v[:, None, c:e],
                               False, False)
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).reshape(BH, Sq, Dh)
