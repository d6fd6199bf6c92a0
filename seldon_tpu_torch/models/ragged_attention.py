"""The ragged unified wave — port of ``seldon_tpu/models/ragged_attention.py``.

Every scheduler wave runs this one function over ALL slots: mixed cold
prefills, chunked-prefill continuations and decode steps. Wave layout
(shapes are config constants; nothing about the live mix is a shape):

 * ``tokens``: the flat ``[max_slots * chunk]`` buffer; slot ``s`` owns
   the segment ``[s * chunk, (s + 1) * chunk)``.
 * per-slot descriptors ``[max_slots]``: ``starts`` (tokens already
   KV-resident; idle rows carry ``Smax`` so every KV write routes to
   the trash block), ``plens``, sampling knobs, ``finals`` (this wave
   completes the prompt: sample its first token) and ``is_prefill``
   (the occupancy mask: rows not prefilling keep their state).
 * ``table``: the ``[max_slots, max_seq_len // kv_block]`` block tables.

Kernel legs (``kernel``):
 * ``"masked"`` — the JAX package's default and the port's in-package
   oracle: full-width gathers through the tables, masked attention.
 * ``"pallas"`` — the block-sparse leg: per layer the pool attention is
   :func:`ops.ragged_paged_attention.ragged_paged_partials` (the
   hand-written CUDA kernel on the card) over only the live blocks,
   combined with the fresh columns. The whole prefill leg is skipped on
   decode-only waves; the JAX package decides that with a traced
   ``lax.cond(any(is_prefill))``, the port with a Python ``if`` on the
   host's own descriptor array (``has_prefill``), so no device sync is
   added.
 * ``"reference"`` — the same one-pass partials through the full-width
   oracle :func:`ops.ragged_paged_attention.partials_reference` (the JAX
   wave passes this mode through to its dispatch as well): the kernel
   leg's math without the kernel, used to tell the kernel's error apart
   from the one-pass design's difference to the masked leg.
 * ``"sparse"`` — the masked-MATCHED two-pass walk
   (:func:`ops.ragged_paged_attention.sparse_max_sum`, then
   :func:`~ops.ragged_paged_attention.sparse_weighted_value`) over the
   live blocks: the masked leg's exact term set, softmax weights rounded
   to the activation dtype before the value product, so its greedy
   tokens equal the masked leg's. Plain PyTorch on every device, as its
   JAX twin is ``jnp``. It skips decode-only prefill legs like the kernel
   leg.

The walks of the ``"sparse"`` leg loop over ``ceil(max(bound) / block)``
block columns. ``live_blocks`` = (prefill leg, decode leg) is that count
as the host knows it from its own descriptors (the engine passes it:
exact for the prefill leg, an upper bound for the decode leg, where a
row that finished on the device unseen by the host still counts; extra
columns add exact zeros). Without it the count is read from the device.

``block_budget`` > 0 sends a leg of the non-masked legs whose longest
live row needs more pool blocks than the budget down the masked head, as
the JAX wave's ``lax.cond`` does (on its Pallas leg too), judged on the
same count (the host's ``live_blocks``, else :func:`rpa.live_columns`);
every other leg runs its own walk: B1 on the kernel leg. The same on
every device. Only the user's explicit budget
(``EngineConfig.ragged_block_budget``) routes a leg to the masked head,
never a kernel that fails to build or launch (that raises); with the
default budget of 0 no leg leaves the kernel.

Sampling keys on (seed, plen) for first tokens and (seed, pos + 1) for
decode tokens, as the JAX package does (``models/sampling.py``).
The KV pool in ``state["cache"]`` is updated in place.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.sampling import sample_per_row
from seldon_tpu_torch.ops import lt_gemm
from seldon_tpu_torch.ops import ragged_paged_attention as rpa

Cache = Dict[str, torch.Tensor]
State = Dict[str, Any]

RAGGED_KERNELS = ("masked", "sparse", "reference", "pallas")

_SLOT_KEYS = ("last_tok", "pos", "active", "temp", "top_k", "top_p",
              "seeds", "remaining")


def token_buffer_size(max_slots: int, chunk: int) -> int:
    """The wave's fixed token capacity: ``max_slots * chunk``."""
    return max_slots * chunk


def _check_kernel(kernel: str) -> None:
    if kernel not in RAGGED_KERNELS:
        raise ValueError(
            f"unknown ragged kernel {kernel!r} (legs: {RAGGED_KERNELS})"
        )


def _over_budget(block_budget: int, n_live: Optional[int]) -> bool:
    """A leg of ``n_live`` live block columns runs the masked head."""
    return block_budget > 0 and n_live > block_budget


def wave_branch(kernel: str, block_budget: int, has_prefill: bool,
                live_blocks: Tuple[int, int], nbs: int) -> Tuple[str, ...]:
    """The host-side choices one wave makes, as :func:`ragged_wave` makes
    them: the masked leg's one route, else (prefill leg, decode leg),
    each ``"skip"`` (a decode-only wave's prefill leg), ``"masked"`` (the
    masked head, over the budget) or the kernel leg itself. The JAX wave
    takes these branches inside one program (``lax.cond``); the port's
    captured waves (``servers/wave_program.py``) key a program by them."""
    _check_kernel(kernel)
    if kernel == "masked":
        return ("masked",)

    def head(n: int) -> str:
        # Clipped to the table, as rpa.live_columns clips it.
        n = max(0, min(nbs, int(n)))
        return "masked" if _over_budget(block_budget, n) else kernel

    return (head(live_blocks[0]) if has_prefill else "skip",
            head(live_blocks[1]))


def _mask_state(old: State, new: State, mask: torch.Tensor) -> State:
    """Merge per-slot state writes under the occupancy mask: masked-out
    rows keep every field bit for bit (the pool is excluded — its writes
    are trash-routed by position, not masked here)."""
    out = dict(old)
    for key in _SLOT_KEYS:
        out[key] = torch.where(mask, new[key], old[key])
    out["cache"] = new["cache"]
    return out


def _fresh_scores(eq: str, qr: torch.Tensor, k: torch.Tensor,
                  tp=None) -> torch.Tensor:
    """The f32 scores of the wave's fresh columns, [B, Hkv, G, S, T]. Under
    ``tp`` the product runs at tp = 1's head count
    (``TpHints.pad_heads``; heads on dim 2 of ``qr`` and ``k``) and the
    rank's heads are kept; inside a dp replica's row share at the whole
    batch's slot count (``transformer.whole_batch``: on the H100 the
    decode's scores at half the slots were reduced in another order;
    ``lt_gemm.whole_einsum``)."""
    return lt_gemm.whole_einsum(eq, qr.float(), k.float(), tp, (2, 2, 1))


def _combine_fresh(parts, s_f: torch.Tensor, v_t: torch.Tensor,
                   tp=None) -> torch.Tensor:
    """``rpa.combine_fresh``; under ``tp`` at tp = 1's head count (heads
    on dim 1 of every input), the rank's part of the result kept; inside
    a dp replica's row share at the whole batch's slot count."""
    B = s_f.shape[0]
    n = transformer.whole_batch(B)
    if n is not None:
        parts = tuple(transformer.pad_batch(t, n) for t in parts)
        s_f, v_t = transformer.pad_batch(s_f, n), transformer.pad_batch(v_t, n)
    if tp is not None:
        parts = tuple(tp.pad_heads(t, 1) for t in parts)
        s_f, v_t = tp.pad_heads(s_f, 1), tp.pad_heads(v_t, 1)
    out = rpa.combine_fresh(parts, s_f, v_t)
    out = out if tp is None else tp.own_heads(out, 2)
    return out if n is None else out[:B]


def _prefill_logits_sparse(
    params: transformer.Transformer,
    toks: torch.Tensor,  # [B, Sc] this wave's suffix segments
    plens: torch.Tensor,
    starts: torch.Tensor,  # [B] raw descriptor starts (idle = Smax)
    bound: torch.Tensor,  # [B] pool visibility (idle rows clamped to 0)
    pool: Cache,
    table: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    n_live: Optional[int] = None,
    tp=None,
) -> Tuple[torch.Tensor, Cache]:
    """Block-sparse twin of paged_prefix_view + prefill_with_prefix: per
    layer the walk covers only the live pool blocks (``n_live`` columns
    for the ``"sparse"`` mode) and is combined with the causal fresh
    suffix. Same (logits, fresh-KV) contract as prefill_with_prefix.
    ``"sparse"`` runs the masked-matched two-pass walk in gqa_attention's
    convention: int8 pool KV dequantized into the query dtype first,
    weights rounded to it over pool and suffix alike, the suffix added to
    the f32 accumulator before the one output cast."""
    B, Sc = toks.shape
    Hkv, Dh = transformer._heads(cfg, tp)[1], cfg.head_dim
    dev = toks.device
    if mode == "sparse":
        n_live = rpa.live_columns(bound, pool["k"].shape[3], table.shape[1],
                                  n_live)
    x = transformer._embed_rows(params, toks)
    positions = starts[:, None] + torch.arange(Sc, device=dev)[None, :]
    inv_freq = transformer.rope_frequencies(cfg, dev)
    bound2 = bound[:, None].expand(B, Sc).to(torch.int32).contiguous()
    smask = torch.ones(Sc, Sc, dtype=torch.bool, device=dev).tril()
    ks, vs = [], []
    for layer, bp in enumerate(params.blocks):
        pl = {key: arr[layer] for key, arr in pool.items()}
        h = transformer.rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = transformer._qkv(h, bp, cfg, positions, inv_freq, tp)
        qr = q.reshape(B, Sc, Hkv, -1, Dh)
        # Fresh causal suffix: the diagonal is always visible, so the
        # combine's total max is finite on every row.
        s_f = _fresh_scores("bskgd,btkd->bkgst", qr, k, tp) / (Dh ** 0.5)
        s_f = torch.where(smask, s_f, rpa.NEG_INF)
        if mode == "sparse":
            m_p, l_p = rpa.sparse_max_sum(qr, pl, table, bound2,
                                          dequant=True, n_live=n_live, tp=tp)
            m_t = torch.maximum(m_p, s_f.amax(dim=-1, keepdim=True))
            p_f = torch.exp(s_f - m_t)
            l_t = l_p * torch.exp(m_p - m_t) + p_f.sum(dim=-1, keepdim=True)
            acc = rpa.sparse_weighted_value(qr, pl, table, bound2, m_t, l_t,
                                            dequant=True, n_live=n_live,
                                            tp=tp)
            acc = acc + lt_gemm.whole_einsum(
                "bkgst,bktd->bkgsd", (p_f / l_t).to(qr.dtype).float(),
                v.transpose(1, 2).to(qr.dtype).float(), tp, (1, 1, 1))
            attn = acc.permute(0, 3, 1, 2, 4).reshape(B, Sc, -1)
        else:
            parts = rpa.ragged_paged_partials(qr, pl, table, bound2,
                                              mode=mode)
            attn = _combine_fresh(parts, s_f, v.transpose(1, 2), tp)
        x = x + transformer._wo(attn.to(x.dtype), bp, cfg, tp)
        x, _ = transformer._mlp_res(x, bp, cfg, tp)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    last = torch.clamp(plens - starts - 1, 0, Sc - 1)
    logits = transformer._logits(params, transformer._take_last(x, last),
                                 cfg)
    return logits[:, 0], {"k": torch.stack(ks), "v": torch.stack(vs)}


def _decode_step_sparse(
    params: transformer.Transformer,
    token: torch.Tensor,  # [B] int32 current tokens
    pos: torch.Tensor,  # [B] int32 positions to write at
    bound: torch.Tensor,  # [B] pool visibility (inactive rows = 0)
    pool: Cache,
    table: torch.Tensor,
    cfg: ModelConfig,
    mode: str,
    n_live: Optional[int] = None,
    tp=None,
) -> Tuple[torch.Tensor, Cache]:
    """Block-sparse twin of paged_decode_step: per layer the walk covers
    the live pool blocks and combines with the one always-visible fresh
    column. ``"sparse"`` runs the masked-matched two-pass walk in
    gqa_attention_decode's convention: scales factored out, weights
    normalised in f32, scaled, rounded to the query dtype; its two-einsum
    tail casts the pool part first and adds the fresh column's product
    in the query dtype. Fresh KV lands after the layer loop in the same
    trash-routed write as the masked step."""
    B = token.shape[0]
    Hkv, Dh = transformer._heads(cfg, tp)[1], cfg.head_dim
    if mode == "sparse":
        n_live = rpa.live_columns(bound, pool["k"].shape[3], table.shape[1],
                                  n_live)
    x = transformer._embed_rows(params, token)[:, None, :]
    positions = pos[:, None]
    inv_freq = transformer.rope_frequencies(cfg, token.device)
    bound2 = bound[:, None].to(torch.int32).contiguous()
    fresh = []
    for layer, bp in enumerate(params.blocks):
        pl = {key: arr[layer] for key, arr in pool.items()}
        h = transformer.rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = transformer._qkv(h, bp, cfg, positions, inv_freq, tp)
        qr = q.reshape(B, 1, Hkv, -1, Dh)
        s_f = _fresh_scores("bskgd,bukd->bkgsu", qr, k, tp) / (Dh ** 0.5)
        if mode == "sparse":
            m_p, l_p = rpa.sparse_max_sum(qr, pl, table, bound2,
                                          n_live=n_live, tp=tp)
            m_t = torch.maximum(m_p, s_f)
            p_f = torch.exp(s_f - m_t)
            l_t = l_p * torch.exp(m_p - m_t) + p_f
            acc = rpa.sparse_weighted_value(qr, pl, table, bound2, m_t, l_t,
                                            n_live=n_live, tp=tp)
            out = acc.to(qr.dtype) + lt_gemm.whole_einsum(
                "bkgsu,bukd->bkgsd", (p_f / l_t).to(qr.dtype).float(),
                v.to(qr.dtype).float(), tp, (1, 2, 1)).to(qr.dtype)
            attn = out.permute(0, 3, 1, 2, 4).reshape(B, 1, -1)
        else:
            parts = rpa.ragged_paged_partials(qr, pl, table, bound2,
                                              mode=mode)
            attn = _combine_fresh(parts, s_f, v.transpose(1, 2), tp)
        x = x + transformer._wo(attn.to(x.dtype), bp, cfg, tp)
        x, _ = transformer._mlp_res(x, bp, cfg, tp)
        fresh.append(transformer._fresh_kv(k[:, 0], v[:, 0], cfg,
                                           pool["k"].dtype))
    stacked = {key: torch.stack([f[key] for f in fresh]) for key in pool}
    pool = transformer.write_decode_kv(pool, stacked, table, pos)
    return transformer._logits(params, x, cfg)[:, 0], pool


@torch.no_grad()
def ragged_prefill_phase(
    params: transformer.Transformer,
    state: State,
    table: torch.Tensor,  # [B, NBs] int32 block tables
    tokens: torch.Tensor,  # [B * chunk] flat token buffer
    plens: torch.Tensor,  # [B] full prompt lengths
    starts: torch.Tensor,  # [B] KV-resident tokens (chunk start)
    seeds: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    max_news: torch.Tensor,
    finals: torch.Tensor,  # [B] bool — last chunk: sample + arm
    is_prefill: torch.Tensor,  # [B] bool occupancy mask
    cfg: ModelConfig,
    kernel: str = "masked",
    block_budget: int = 0,
    n_live: Optional[int] = None,
    tp=None,
) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """The wave's prefill leg: every occupied segment of the token buffer
    runs against its resident prefix (full table width on the masked
    leg, live blocks on the others; ``n_live`` is the host's count of
    them), fresh KV scatters through the tables, final rows sample their
    first token."""
    _check_kernel(kernel)
    pool = state["cache"]
    block = pool["k"].shape[3]
    nbs = table.shape[1]
    Smax = nbs * block
    B = table.shape[0]
    Sc = tokens.shape[0] // B
    toks = tokens.reshape(B, Sc)

    def masked_head():
        prefix_kv = transformer.paged_prefix_view(pool, table, nbs)
        return transformer.prefill_with_prefix(
            params, toks, plens, prefix_kv, starts, cfg, tp)

    if kernel == "masked":
        logits, kv = masked_head()
    else:
        bound = torch.where(is_prefill, starts, 0).to(torch.int32)
        if block_budget > 0:
            n_live = rpa.live_columns(bound, block, nbs, n_live)
        if _over_budget(block_budget, n_live):
            logits, kv = masked_head()
        else:
            logits, kv = _prefill_logits_sparse(
                params, toks, plens, starts, bound, pool, table, cfg,
                kernel, n_live, tp)
    first = sample_per_row(logits, seeds, plens, temps, top_ks, top_ps)
    first_done = (
        (first == cfg.eos_token_id) | (max_news <= 1) | (plens + 1 >= Smax)
    )
    new_pos = torch.minimum(plens, starts + Sc)
    if cfg.kv_cache_dtype == "int8":
        kq, ksc = transformer._quantize_kv(kv["k"])
        vq, vsc = transformer._quantize_kv(kv["v"])
        writes = {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    else:
        writes = {"k": kv["k"], "v": kv["v"]}
    spos = starts[:, None] + torch.arange(Sc, device=toks.device)[None, :]
    new_pool = transformer.paged_scatter_tokens(pool, writes, table, spos)
    new_state = _mask_state(
        state,
        {
            "cache": new_pool,
            "last_tok": first,
            "pos": new_pos.to(torch.int32),
            "active": finals & ~first_done,
            "temp": temps,
            "top_k": top_ks,
            "top_p": top_ps,
            "seeds": seeds,
            "remaining": (max_news - 1).to(torch.int32),
        },
        is_prefill,
    )
    return new_state, first, first_done


@torch.no_grad()
def ragged_decode_phase(
    params: transformer.Transformer,
    state: State,
    table: torch.Tensor,
    cfg: ModelConfig,
    kernel: str = "masked",
    block_budget: int = 0,
    n_live: Optional[int] = None,
    tp=None,
) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """The wave's decode leg: ONE decode step over every slot, reading and
    writing KV through the block tables (``n_live``: the host's count of
    live block columns). Returns (state, toks [1, B], valid [1, B])."""
    _check_kernel(kernel)
    block = state["cache"]["k"].shape[3]
    Smax = table.shape[1] * block
    run = state["active"]

    def masked_step():
        return transformer.paged_decode_step(
            params, state["last_tok"], state["pos"], state["cache"], table,
            cfg, tp)

    if kernel == "masked":
        logits, pool = masked_step()
    else:
        bound = torch.where(run, state["pos"], 0).to(torch.int32)
        if block_budget > 0:
            n_live = rpa.live_columns(bound, block, table.shape[1], n_live)
        if _over_budget(block_budget, n_live):
            logits, pool = masked_step()
        else:
            logits, pool = _decode_step_sparse(
                params, state["last_tok"], state["pos"], bound,
                state["cache"], table, cfg, kernel, n_live, tp)
    tok = sample_per_row(
        logits, state["seeds"], state["pos"] + 1, state["temp"],
        torch.where(run, state["top_k"], 0),
        torch.where(run, state["top_p"], 1.0),
    )
    tok = torch.where(run, tok, cfg.pad_token_id).to(torch.int32)
    step = run.to(torch.int32)
    pos = state["pos"] + step
    remaining = state["remaining"] - step
    done = run & ((tok == cfg.eos_token_id) | (remaining <= 0)
                  | (pos >= Smax - 1))
    new_state = {
        **state,
        "cache": pool,
        "last_tok": torch.where(run, tok, state["last_tok"]),
        "pos": pos,
        "active": state["active"] & ~done,
        "remaining": remaining,
    }
    return new_state, tok[None], run[None]


@torch.no_grad()
def ragged_wave(
    params: transformer.Transformer,
    state: State,
    table: torch.Tensor,
    tokens: torch.Tensor,
    plens: torch.Tensor,
    starts: torch.Tensor,
    seeds: torch.Tensor,
    temps: torch.Tensor,
    top_ks: torch.Tensor,
    top_ps: torch.Tensor,
    max_news: torch.Tensor,
    finals: torch.Tensor,
    is_prefill: torch.Tensor,
    cfg: ModelConfig,
    kernel: str = "masked",
    block_budget: int = 0,
    has_prefill: Optional[bool] = None,
    live_blocks: Optional[Tuple[int, int]] = None,
    tp=None,
) -> Tuple[State, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full unified wave: prefill leg then decode leg. Returns
    ``(state, first [B], first_done [B], toks [1, B], valid [1, B])``.

    The non-masked legs skip the whole prefill leg when no row prefills;
    ``has_prefill`` is the host's answer to that question (the engine
    knows it from its own descriptors). When it is None the answer is
    read from ``is_prefill``, which waits for the device (and raises
    inside a captured wave). The masked leg
    always runs its prefill leg, as the JAX package's does.
    ``live_blocks`` is the host's (prefill, decode) count of live block
    columns (module docstring). ``tp`` (``models/tp_sharding.TpHints``)
    runs the wave on this rank's heads and pool shard: B1 is launched on
    the rank's Hkv / tp heads, and every host-made argument is the same
    on every rank, so the skip and trip-count decisions agree."""
    _check_kernel(kernel)
    pre_live, dec_live = live_blocks if live_blocks is not None else (
        None, None)
    if kernel != "masked" and has_prefill is None:
        if is_prefill.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ragged_wave would read is_prefill inside a "
                               "captured wave: pass the host's has_prefill")
        has_prefill = bool(is_prefill.any())
    if kernel == "masked" or has_prefill:
        state, first, first_done = ragged_prefill_phase(
            params, state, table, tokens, plens, starts, seeds, temps,
            top_ks, top_ps, max_news, finals, is_prefill, cfg,
            kernel=kernel, block_budget=block_budget, n_live=pre_live,
            tp=tp,
        )
    else:
        B = table.shape[0]
        first = torch.zeros((B,), dtype=torch.int32, device=table.device)
        first_done = torch.zeros((B,), dtype=torch.bool, device=table.device)
    state, toks, valid = ragged_decode_phase(
        params, state, table, cfg, kernel=kernel, block_budget=block_budget,
        n_live=dec_live, tp=tp)
    if tp is not None:
        tp.constrain_state(state, cfg)
    return state, first, first_done, toks, valid
