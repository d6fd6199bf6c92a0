"""Ring attention: sequence/context parallelism over the 'sp' ranks — port
of ``seldon_tpu/parallel/ring_attention.py``.

Long-context attention where no rank ever holds the full K/V: each rank
keeps its own sequence block and the K/V blocks rotate around the ring
(``RankGroup.exchange``: NCCL's ``batch_isend_irecv`` when every rank has
its own card, gloo through host buffers when ranks share one), with
blockwise online-softmax accumulation, so the result is exactly full
attention (the math of ``ops/flash_attention.py``, distributed).

Where the JAX function takes the global arrays and a mesh and runs the
per-device body under ``shard_map``, the port runs one process per rank:
:func:`ring_attention` takes THIS rank's blocks and its group and returns
this rank's block of the output. Rank r holds sequence positions
``[r * s, (r + 1) * s)``. The block update is plain torch, so autograd
goes through it; under a gradient the K/V hops are one autograd node
(``distributed.ring_pass``) whose backward sends each block's gradient
back the reverse way round the ring.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _block_attention_update(q, k, v, m, l, acc, q_pos, k_off, causal, scale):
    """One online-softmax accumulation step of q against a k/v block.
    q [BH, s, D]; k,v [BH, t, D]; m,l [BH, s, 1]; acc [BH, s, D] f32.
    q_pos [s] — global sequence position of each q row (rows need not be
    contiguous: the GQA fold interleaves G query groups per kv head)."""
    s_scores = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if causal:
        rows = q_pos[:, None]
        cols = k_off + torch.arange(k.shape[1], device=k.device)[None, :]
        s_scores = torch.where(rows >= cols, s_scores, NEG_INF)
    m_cur = s_scores.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    p = torch.exp(s_scores - m_new)
    alpha = torch.exp(m - m_new)
    l_new = alpha * l + p.sum(dim=-1, keepdim=True)
    acc_new = acc * alpha + torch.einsum(
        "bqk,bkd->bqd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, acc_new


def _blocks(k, v, group):
    """The (K, V) blocks this rank holds at each step of the ring: with a
    gradient, all of them from one differentiable pass; without, one
    hop at a time."""
    n, idx = int(group.world), int(group.rank)
    if torch.is_grad_enabled() and (k.requires_grad or v.requires_grad):
        from seldon_tpu_torch.parallel.distributed import ring_pass

        yield from ring_pass(k, v, group)
        return
    for step in range(n):
        yield k, v
        if step < n - 1:
            k = group.exchange(k, to=(idx + 1) % n, frm=(idx - 1) % n)
            v = group.exchange(v, to=(idx + 1) % n, frm=(idx - 1) % n)


def ring_attention(
    q: torch.Tensor,  # [B, s, H, Dh] this rank's block of the sequence
    k: torch.Tensor,  # [B, s, Hkv, Dh] — Hkv may be < H (GQA)
    v: torch.Tensor,
    group,
    causal: bool = True,
) -> torch.Tensor:
    """Exact full attention with S sharded over the ``group``'s ranks in
    rank order. Returns this rank's block [B, s, H, Dh].

    GQA is native: with Hkv < H query heads group as H = Hkv * G (head h
    attends kv head h // G, matching gqa_attention), only the Hkv-head
    K/V blocks rotate around the ring, and each rotation's block update
    batches the G query groups per kv head into one [B*Hkv, G*s, t]
    product. Blocks strictly above the diagonal are skipped under
    ``causal``, and the last rotation's hop is not made. Differentiable:
    with a gradient, every hop is made through ``ring_pass`` (the same
    n - 1 exchanges per K and V, and the rank keeps the blocks it
    received for the backward); without one, each block is dropped once
    used."""
    B, s, H, Dh = q.shape
    Hkv = k.shape[2]
    assert k.shape == v.shape == (B, s, Hkv, Dh), (q.shape, k.shape)
    G = H // Hkv
    n = int(group.world)
    idx = int(group.rank)
    scale = Dh ** -0.5

    def fold_q(x):  # [B, s, H, Dh] -> [B*Hkv, G*s, Dh]
        return (x.reshape(B, s, Hkv, G, Dh).permute(0, 2, 3, 1, 4)
                .reshape(B * Hkv, G * s, Dh))

    def fold_kv(x):  # [B, s, Hkv, Dh] -> [B*Hkv, s, Dh]
        return x.transpose(1, 2).reshape(B * Hkv, s, Dh)

    qf = fold_q(q)
    # Row r of the fold is query position r % s (group r // s).
    q_pos = idx * s + torch.arange(G * s, device=q.device) % s
    m = torch.full((B * Hkv, G * s, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B * Hkv, G * s, 1), dtype=torch.float32,
                    device=q.device)
    acc = torch.zeros((B * Hkv, G * s, Dh), dtype=torch.float32,
                      device=q.device)
    for step, (k_cur, v_cur) in enumerate(_blocks(k, v, group)):
        src = (idx - step) % n  # which global block k_cur came from
        if not causal or src <= idx:
            m, l, acc = _block_attention_update(
                qf, fold_kv(k_cur), fold_kv(v_cur), m, l, acc, q_pos,
                src * s, causal, scale)
    out = (acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return (out.reshape(B, Hkv, G, s, Dh).permute(0, 3, 1, 2, 4)
            .reshape(B, s, H, Dh))
