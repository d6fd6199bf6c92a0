"""Speculative decoding device work — port of ``seldon_tpu/models/spec_decode.py``.

A drafter proposes ``k`` tokens per live slot and the target model
scores all ``k + 1`` positions in ONE wide pass (:func:`verify_wave`)
instead of ``k + 1`` sequential decode steps. Sampling is deterministic
per row — every emitted token is keyed ``fold_in(key(seed), pos + 1)``
— so verification is EXACT: the wave samples the target's own token at
each position with the sequential keys and accepts drafts only while
they match. The emitted stream is the spec-off engine's at any
temperature; the draft only decides how many sequential steps are
skipped.

Numerics follow the JAX package. Sequential decode computes position
``p`` against the cache at ``t < p`` (int8 caches round-trip through
quantize / dequantize) plus its OWN column as one exact fresh column
(``transformer.gqa_attention_decode``). The masked leg reproduces that
per query row: each layer gathers the dense cache view through the
block tables, scatters the wave's own suffix k/v INTO that view in
cache dtype (so query row ``i`` sees rows ``j < i`` as the cache would
hand them back), and runs :func:`gqa_attention_verify`, the decode
attention generalized to ``Sq`` rows with a per-row strict mask and a
DIAGONAL fresh column. Pool positions at or past a row's pre-wave
``pos`` may hold rejected drafts of an earlier wave; the in-view
scatter shadows them before any mask exposes them, which is what makes
the host-side rollback a pure block-table trim.

Legs (``kernel``), as the ragged wave's:
 * ``"masked"`` — the full-width gather above; the exactness oracle.
 * ``"sparse"`` — the masked-matched two-pass walk over the live pool
   blocks (plain PyTorch on every device).
 * ``"pallas"`` — the pool part from
   :func:`ops.ragged_paged_attention.ragged_paged_partials`: the
   hand-written CUDA kernel (B1) on the card, its plain version on the
   CPU. On the card it launches or raises.
 * ``"reference"`` — the same one-pass partials through the full-width
   oracle (comparison only).

The walks of the non-masked legs are bounded at each wave row's
PRE-wave ``pos`` (not ``pos + i``: the suffix columns join the combine
from the cache-dtype view arrays) and at 0 for rows outside the wave.
``n_live`` is the count of live block columns as the caller's host
knows it (the engine passes it); without it the ``"sparse"`` walk reads
the count from the device.

The commit scatter writes all ``Sq`` suffix positions through the block
tables (rows outside the wave route to the trash block); positions past
the accepted prefix are dead by the shadowing argument above, so
acceptance never waits for the host mid-wave. The pool is updated in
place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.ragged_attention import (_check_kernel,
                                                      _over_budget)
from seldon_tpu_torch.models.sampling import sample_per_row
from seldon_tpu_torch.ops import lt_gemm
from seldon_tpu_torch.ops import ragged_paged_attention as rpa

Cache = Dict[str, torch.Tensor]
State = Dict[str, Any]


def _diag_scores(qf: torch.Tensor, kf: torch.Tensor, tp=None
                 ) -> torch.Tensor:
    """Each query row's f32 score against its own key, [B, Hkv, G, Sq, 1]
    (``qf`` [B, Sq, Hkv, G, Dh], ``kf`` [B, Sq, Hkv, Dh])."""
    return lt_gemm.whole_einsum("bskgd,bskd->bkgs", qf, kf, tp,
                                (2, 2, 1))[..., None]


def gqa_attention_verify(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    ck: torch.Tensor,  # [B, Hkv, T, Dh] cache view (int8 if scales)
    cv: torch.Tensor,  # [B, Hkv, T, Dh]
    k_fresh: torch.Tensor,  # [B, Sq, Hkv, Dh] exact own column
    v_fresh: torch.Tensor,  # [B, Sq, Hkv, Dh]
    mask_lt: torch.Tensor,  # [B, Sq, T] True where t < row position
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, T] (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """``gqa_attention_decode`` generalized to Sq query rows: each row
    attends the cache view under its own strict mask plus a DIAGONAL
    fresh column (its own exact k/v, never the other rows'). Scales stay
    factored out of the products and the rounding points are the decode
    attention's, so row i's arithmetic is a decode step's at the same T
    width. Every product runs at dp = 1 and tp = 1's batch count
    (``lt_gemm.whole_einsum``, ``tp`` the rank's hints): on the H100 a
    dp = 2 x tp = 2 rank's share of the slots and heads was reduced in
    another order. Returns [B, Sq, H*Dh]."""
    B, S, H, Dh = q.shape
    Hkv = ck.shape[1]
    assert ck.shape == cv.shape and ck.shape[0] == B
    assert k_fresh.shape == (B, S, Hkv, Dh) == v_fresh.shape
    G = H // Hkv
    qf = q.reshape(B, S, Hkv, G, Dh).float()
    scores = lt_gemm.whole_einsum("bskgd,bktd->bkgst", qf,
                                  ck.to(q.dtype).float(), tp,
                                  (2, 1, 1)) / (Dh ** 0.5)
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, None, :]
    # Row s against ITS OWN k only: s stays paired, d contracts.
    s_fresh = _diag_scores(qf, k_fresh.to(q.dtype).float(), tp) \
        / (Dh ** 0.5)
    scores = torch.where(mask_lt[:, None, None, :, :], scores,
                         transformer.NEG_MASK)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_fresh)
    p = torch.exp(scores - m)
    p_f = torch.exp(s_fresh - m)  # [B, Hkv, G, S, 1]
    l = p.sum(dim=-1, keepdim=True) + p_f
    wc = p / l
    if v_scale is not None:
        wc = wc * v_scale.float()[:, :, None, None, :]
    out = lt_gemm.whole_einsum(
        "bkgst,bktd->bskgd", wc.to(q.dtype).float(), cv.to(q.dtype).float(),
        tp, (1, 1, 2)).to(q.dtype) + lt_gemm.whole_einsum(
        "bkgs,bskd->bskgd", (p_f / l)[..., 0].to(q.dtype).float(),
        v_fresh.to(q.dtype).float(), tp, (1, 2, 2)).to(q.dtype)
    return out.reshape(B, S, H * Dh)


def _suffix_view(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
                 pool_dtype: torch.dtype) -> Cache:
    """The wave's own k/v [B, Sq, Hkv, (Dh)] in pool storage form."""
    if cfg.kv_cache_dtype == "int8":
        kq, ksc = transformer._quantize_kv(k)
        vq, vsc = transformer._quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    return {"k": k.to(pool_dtype), "v": v.to(pool_dtype)}


def _run_blocks_verify(params, x, cfg, positions, inv_freq, mask_lt, pool,
                       table, tp=None):
    """The masked leg's layer loop: per layer, gather the dense cache
    view through the block tables, scatter this wave's suffix k/v into it
    in CACHE DTYPE (the arrays later committed to the pool), and run the
    widened decode attention. Positions past the window are dropped from
    the view scatter, as the JAX scatter's ``mode="drop"``: the view is
    gathered one trash block wider and they land there. Returns (x, fresh
    {key: [L, B, Hkv, Sq, (Dh)]})."""
    B, Sq = positions.shape
    block = pool["k"].shape[3]
    Smax = table.shape[1] * block
    rows = torch.arange(B, device=x.device)[:, None]
    # One extra table column at the trash block: the landing place of
    # out-of-window writes (the gathered view is a copy, so the pool's
    # trash block is never written here).
    wide = torch.cat([table, torch.zeros_like(table[:, :1])], dim=1)
    cols = torch.clamp(positions, max=Smax).long()
    fresh = []
    for layer, bp in enumerate(params.blocks):
        pl = {key: arr[layer] for key, arr in pool.items()}
        h = transformer.rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = transformer._qkv(h, bp, cfg, positions, inv_freq, tp)
        view = _suffix_view(k, v, cfg, pool["k"].dtype)
        cl = transformer.paged_gather_kv(pl, wide)  # [B, Hkv, Smax+block, ..]
        for key in cl:
            # Advanced indices (rows, cols) broadcast to [B, Sq] and land
            # in front: the update keeps view's [B, Sq, Hkv, ...] layout.
            cl[key][rows, :, cols] = view[key]
            cl[key] = cl[key][:, :, :Smax]
        attn = gqa_attention_verify(
            q, cl["k"], cl["v"], k, v, mask_lt,
            k_scale=cl.get("k_scale"), v_scale=cl.get("v_scale"), tp=tp,
        )
        x = x + transformer._wo(attn, bp, cfg, tp)
        x, _ = transformer._mlp_res(x, bp, cfg, tp)
        fresh.append({key: val.transpose(1, 2) for key, val in view.items()})
    return x, {key: torch.stack([f[key] for f in fresh]) for key in pool}


def _run_blocks_verify_sparse(params, x, cfg, positions, inv_freq, pool,
                              table, bound, mode="sparse",
                              n_live: Optional[int] = None, tp=None):
    """Block-sparse twin of :func:`_run_blocks_verify`: the pool part
    comes from the walk over live blocks bounded at each row's PRE-wave
    ``pos`` (pool positions at or past it hold stale rejected drafts,
    which the masked leg shadows in its view), and the wave's own suffix
    columns join the combine from the cache-dtype view arrays (row s sees
    suffix rows u < s as the masked leg reads them back; the diagonal
    stays the exact fresh column). The combine is written out because the
    diagonal's value rows depend on the query row, which
    ``rpa.combine_fresh``'s shared-value contract cannot express."""
    B, Sq = positions.shape
    Hkv, Dh = transformer._heads(cfg, tp)[1], cfg.head_dim
    dev = x.device
    block = pool["k"].shape[3]
    Smax = table.shape[1] * block
    quantized = cfg.kv_cache_dtype == "int8"
    if mode == "sparse":
        n_live = rpa.live_columns(bound, block, table.shape[1], n_live)
    bound2 = bound[:, None].expand(B, Sq).to(torch.int32).contiguous()
    offs = torch.arange(Sq, device=dev)
    # Row s sees suffix column u strictly before it, in-window columns
    # only (the masked leg's view scatter drops the others).
    suf_mask = ((offs[None, :] < offs[:, None])[None]
                & (positions[:, None, :] < Smax))  # [B, s, u]
    sm5 = suf_mask[:, None, None, :, :]
    fresh = []
    for layer, bp in enumerate(params.blocks):
        pl = {key: arr[layer] for key, arr in pool.items()}
        h = transformer.rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = transformer._qkv(h, bp, cfg, positions, inv_freq, tp)
        view = _suffix_view(k, v, cfg, pool["k"].dtype)
        # The kernel takes q as one contiguous [B, Sq, Hkv, G, Dh] block.
        qr = q.reshape(B, Sq, Hkv, -1, Dh).contiguous()
        qf = qr.float()
        s_suf = lt_gemm.whole_einsum(
            "bskgd,bukd->bkgsu", qf, view["k"].to(qr.dtype).float(), tp,
            (2, 2, 1)) / (Dh ** 0.5)
        if quantized:
            s_suf = s_suf * view["k_scale"].float().transpose(
                1, 2)[:, :, None, None, :]
        s_suf = torch.where(sm5, s_suf, rpa.NEG_INF)
        s_diag = _diag_scores(qf, k.to(qr.dtype).float(), tp) / (Dh ** 0.5)
        vd = v.transpose(1, 2)[:, :, None, :, :]  # [B, Hkv, 1, Sq, Dh]
        if mode == "sparse":
            # The masked-matched two-pass walk: pool and suffix weights
            # normalised in f32, times v_scale, rounded to the query
            # dtype, f32-accumulated with one cast; the exact diagonal
            # rides gqa_attention_verify's second-product convention.
            m_p, l_p = rpa.sparse_max_sum(qr, pl, table, bound2,
                                          n_live=n_live, tp=tp)
            m_t = torch.maximum(
                torch.maximum(m_p, s_suf.amax(dim=-1, keepdim=True)),
                s_diag)
            pw = torch.where(sm5, torch.exp(s_suf - m_t), 0.0)
            p_d = torch.exp(s_diag - m_t)
            l_t = (l_p * torch.exp(m_p - m_t)
                   + pw.sum(dim=-1, keepdim=True) + p_d)
            acc = rpa.sparse_weighted_value(qr, pl, table, bound2, m_t, l_t,
                                            n_live=n_live, tp=tp)
            w_suf = pw / l_t
            if quantized:
                w_suf = w_suf * view["v_scale"].float().transpose(
                    1, 2)[:, :, None, None, :]
            acc = acc + lt_gemm.whole_einsum(
                "bkgsu,bukd->bkgsd", w_suf.to(qr.dtype).float(),
                view["v"].to(qr.dtype).float(), tp, (1, 2, 1))
            out = acc.to(qr.dtype) + (p_d / l_t).to(qr.dtype) \
                * vd.to(qr.dtype)
        else:
            m_p, l_p, acc = rpa.ragged_paged_partials(qr, pl, table, bound2,
                                                      mode=mode)
            # Rows outside the wave have bound 0: their partials are
            # (NEG_INF, 0, 0), and the diagonal keeps m_t finite.
            m_t = torch.maximum(
                torch.maximum(m_p, s_suf.amax(dim=-1, keepdim=True)),
                s_diag)
            alpha = torch.exp(m_p - m_t)
            pw = torch.where(sm5, torch.exp(s_suf - m_t), 0.0)
            p_d = torch.exp(s_diag - m_t)
            l_t = l_p * alpha + pw.sum(dim=-1, keepdim=True) + p_d
            if quantized:
                pw = pw * view["v_scale"].float().transpose(
                    1, 2)[:, :, None, None, :]
            out = (acc * alpha
                   + lt_gemm.whole_einsum("bkgsu,bukd->bkgsd", pw,
                                          view["v"].float(), tp, (1, 2, 1))
                   + p_d * vd.float()) / torch.clamp(l_t, min=1e-30)
        attn = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, -1).to(x.dtype)
        x = x + transformer._wo(attn, bp, cfg, tp)
        x, _ = transformer._mlp_res(x, bp, cfg, tp)
        fresh.append({key: val.transpose(1, 2) for key, val in view.items()})
    return x, {key: torch.stack([f[key] for f in fresh]) for key in pool}


def verify_branch(kernel: str, block_budget: int, n_live: int,
                  nbs: int) -> Tuple[str, ...]:
    """The host-side choice one verify wave makes, as :func:`verify_wave`
    makes it from the host's ``n_live``: the masked leg, or the kernel
    leg unless the pool walk's live block columns (clipped to the
    table's ``nbs``) exceed ``block_budget``. The JAX wave takes it
    inside one program (``lax.cond``); the port's captured verify waves
    (``servers/wave_program.py``) key a program by it."""
    _check_kernel(kernel)
    if kernel == "masked" or _over_budget(
            block_budget, max(0, min(nbs, int(n_live)))):
        return ("masked",)
    return (kernel,)


@torch.no_grad()
def verify_wave(
    params: transformer.Transformer,
    state: State,
    table: torch.Tensor,  # [B, NBs] int32 block tables
    drafts: torch.Tensor,  # [B, k] int32 proposed tokens
    wave: torch.Tensor,  # [B] bool: the row takes part in this wave
    cfg: ModelConfig,
    kernel: str = "masked",
    block_budget: int = 0,
    n_live: Optional[int] = None,
    tp=None,
) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """One speculative verify wave over all B slots.

    Each wave row's inputs are ``[last_tok, d_1 .. d_k]`` at positions
    ``pos .. pos + k``; the target's token at each position is sampled
    with the sequential key ``(seed, pos_i + 1)`` and drafts are accepted
    while they MATCH, so a row emits 1 (the first draft rejected: plain
    decode) to k + 1 (full acceptance and the bonus token) tokens, each a
    sequential decode step's. Termination (EOS / budget / window) is the
    decode chunk's value-level rule, so a row finishing inside the
    accepted prefix stops there.

    Returns ``(state, toks [k+1, B], valid [k+1, B])``; the valid columns
    are True-prefixes, the decode chunk's contract.

    ``kernel`` != "masked" runs :func:`_run_blocks_verify_sparse` with
    that mode (module docstring). ``block_budget`` > 0 sends waves whose
    longest pre-wave row needs more pool blocks than the budget through
    the masked leg, as the JAX wave's ``lax.cond`` does, on every device
    (the other waves run B1 on the kernel leg). ``n_live`` is
    the host's count of live block columns. ``tp`` runs the wave on this
    rank's heads and pool shard (B1 on the rank's Hkv / tp heads)."""
    _check_kernel(kernel)
    k = drafts.shape[1]
    Sq = k + 1
    pool = state["cache"]
    block = pool["k"].shape[3]
    Smax = table.shape[1] * block
    dev = table.device
    pos0 = state["pos"]
    inputs = torch.cat([state["last_tok"][:, None], drafts.to(torch.int32)],
                       dim=1)  # [B, Sq]
    positions = pos0[:, None] + torch.arange(Sq, device=dev)[None, :]
    x = transformer._embed_rows(params, inputs)
    inv_freq = transformer.rope_frequencies(cfg, dev)

    def masked_body():
        # Strict per-row mask: query row i sees t < pos + i, the decode
        # step's t < pos at each unrolled position.
        mask_lt = (torch.arange(Smax, device=dev)[None, None, :]
                   < positions[:, :, None])  # [B, Sq, Smax]
        return _run_blocks_verify(params, x, cfg, positions, inv_freq,
                                  mask_lt, pool, table, tp)

    if kernel == "masked":
        x, fresh = masked_body()
    else:
        bound = torch.where(wave, pos0, 0).to(torch.int32)
        if block_budget > 0:
            n_live = rpa.live_columns(bound, block, table.shape[1], n_live)
        if block_budget > 0 and n_live > block_budget:
            x, fresh = masked_body()
        else:
            x, fresh = _run_blocks_verify_sparse(
                params, x, cfg, positions, inv_freq, pool, table, bound,
                mode=kernel, n_live=n_live, tp=tp)
    # Every position projects to logits: the acceptance chain needs each
    # row's candidate at each of the Sq positions.
    logits = transformer._logits(params, x, cfg)  # [B, Sq, V] f32
    # Commit every suffix position through the tables; rows outside the
    # wave route to the trash block.
    spos = torch.where(wave[:, None], positions,
                       torch.full_like(positions, Smax))
    pool = transformer.paged_scatter_tokens(pool, fresh, table, spos)

    # The acceptance chain, unrolled: each step IS the decode chunk's
    # step (same keys, masking and termination), broken at the first
    # draft mismatch or finished row.
    run = wave & state["active"]
    pos = pos0
    remaining = state["remaining"]
    active = state["active"]
    last = state["last_tok"]
    toks, valid = [], []
    for i in range(Sq):
        tok = sample_per_row(
            logits[:, i], state["seeds"], pos + 1, state["temp"],
            torch.where(run, state["top_k"], 0),
            torch.where(run, state["top_p"], 1.0),
        )
        tok = torch.where(run, tok, cfg.pad_token_id).to(torch.int32)
        step = run.to(torch.int32)
        pos = pos + step
        remaining = remaining - step
        done = run & ((tok == cfg.eos_token_id) | (remaining <= 0)
                      | (pos >= Smax - 1))
        last = torch.where(run, tok, last)
        active = active & ~done
        toks.append(tok)
        valid.append(run)
        if i < k:
            run = run & ~done & (tok == drafts[:, i])
    new_state = {
        **state,
        "cache": pool,
        "last_tok": last,
        "pos": pos,
        "active": active,
        "remaining": remaining,
    }
    return new_state, torch.stack(toks), torch.stack(valid)


@torch.no_grad()
def draft_tokens(
    params: transformer.Transformer,
    window: torch.Tensor,  # [B, W] int32 right-padded history windows
    wlens: torch.Tensor,  # [B] true window lengths (>= 1)
    cfg: ModelConfig,
    k: int,
) -> torch.Tensor:
    """Model drafter: k greedy continuations of each row's history
    window (a prefill, then k - 1 decode steps over a scratch dense
    cache). Stateless: the draft model keeps no KV between waves, so a
    rollback needs no draft-side bookkeeping. Greedy always: drafts are
    proposals; the target decides acceptance. Returns [B, k] int32."""
    B, W = window.shape
    cache = transformer.init_cache(cfg, B, W + k, device=window.device)
    logits, cache = transformer.prefill(params, window, wlens, cache, cfg)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    pos = wlens.to(torch.int32)
    for _ in range(k - 1):
        logits, cache = transformer.decode_step(params, tok, pos, cache, cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        out.append(tok)
        pos = pos + 1
    return torch.stack(out, dim=1)
