"""Llama-family transformer in PyTorch — the model math of the port.

Port of ``seldon_tpu/models/transformer.py``: weights in the compute
dtype (``cfg.dtype``: bf16, or f32 with f32 norms, router and KV) or int8
weights with per-output-channel scales (``models/quantize.py``), W8A8
(``cfg.act_dtype == "int8"``: dynamic per-token int8 activations into
an s8 x s8 -> s32 product, ``torch._int_mm``), dense SwiGLU or top-k
MoE, KV in the compute dtype or int8 (bf16-scaled). Two families of
entry points:
 * the ragged serving path: ``prefill_with_prefix``, the paged pool and
   ``paged_decode_step``;
 * the cache-free and whole-batch path: ``forward`` (teacher-forced
   logits, the scorer behind ``TorchServer.predict``), and ``init_cache``,
   ``prefill`` and ``decode_step`` over a dense head-major cache
   (``models/generate.py``). Under ``cfg.attn_impl == "flash"`` their
   full-sequence attention runs the flash kernel
   (``ops/flash_attention.py``); under ``"ring"`` with an sp rank group
   (``ring=``) ``forward`` and ``prefill`` run context-parallel over the
   ring (``parallel/ring_attention.py``), and without one the ``"xla"``
   einsum attention, as the JAX package does without a mesh.
Under tensor parallelism (``tp=``, ``models/tp_sharding.TpHints``) the
serving paths run the rank's heads and d_ff slice, and all-gather the
attention output and the SwiGLU hidden before the replicated ``wo`` and
``w_down`` (``_wo``, ``_mlp_res``).
The differentiable training route (:func:`forward_train`, the pieces
``embed_train`` / ``blocks_train`` / ``logits_train`` the pipeline
stages run) is JAX's ``forward(..., remat=True, return_aux=True,
ring_mesh=...)`` with gradients: per-block remat, Megatron's f / g over
tp (``parallel/sharding.MegatronHints``), the K/V all-gathered over sp
under ``"xla"`` or the ring under ``"ring"``, the MoE statistics of the
whole batch. The scoring and serving entry points keep ``no_grad``.
Every projection on every path goes through :func:`_qdot`.

Layouts follow the JAX package so tests compare like with like:
 * weights multiply on the right (``x @ W``, ``W`` is ``[in, out]``), one
   :class:`Block` module per layer (the JAX ``[L, ...]`` stack sliced);
   MoE expert weights are ``[E, in, out]``;
 * activations ``[B, S, H, Dh]``; caches are HEAD-major: the paged pool
   ``[L, NB, Hkv, block, Dh]`` with scales ``[L, NB, Hkv, block]``, the
   dense cache ``[L, B, Hkv, T, Dh]`` with scales ``[L, B, Hkv, T]``.

Rounding points copy the JAX package's: matrix products that JAX asks
for in f32 (``preferred_element_type``) run on f32 copies of their bf16
operands; chains of elementwise ops that XLA fuses run in f32 and round
once; explicit ``astype`` casts are explicit ``.to`` casts here. Eager
PyTorch materializes every op's output, so the values the JAX package
pins with ``optimization_barrier`` (the activation before
``_quantize_act``, the KV before ``_quantize_kv``) are rounded here
without one.

Caches are updated IN PLACE (``paged_scatter_tokens``, the decode writes
and ``prefill`` return the cache they were given): PyTorch has no buffer
donation, and a functional copy of a multi-gigabyte cache per step is
not affordable.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.quantize import (_BLOCK_WEIGHTS, dequant,
                                               true_div)
from seldon_tpu_torch.ops import host_hooks, lt_gemm
from seldon_tpu_torch.ops.flash_attention import flash_attention
from seldon_tpu_torch.ops.lt_gemm import pad_batch, whole_batch

Cache = Dict[str, torch.Tensor]

NEG_MASK = -1e30  # mask fill of the JAX package (f32, not -inf)

# torch._int_mm calls of the W8A8 projections since the last reset (a
# plain integer counter; chip_smoke.py zeroes it before a burst).
int_mm_launches = 0

# The block projections exact tensor parallelism cuts on their output
# columns (models/tp_sharding.py): at tp = 1 and on every rank the same
# GEMM at another width.
COLUMN_SHARDED = ("wq", "wk", "wv", "w_gate", "w_up")


# The compute dtypes the port carries (ModelConfig.dtype): the JAX
# package's bf16 default and its float32 models (``load_hf_checkpoint(...,
# dtype="float32")``). float16 is not carried: the JAX package has no
# float16 route either (its loader maps every dtype but bfloat16 to f32).
COMPUTE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype(cfg: ModelConfig) -> torch.dtype:
    dt = COMPUTE_DTYPES.get(cfg.dtype)
    if dt is None:
        raise NotImplementedError(
            f"dtype {cfg.dtype!r}: the port carries bfloat16 and float32 "
            f"models only"
        )
    return dt


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """Validate a config and reject what the port does not carry (a
    compute dtype other than bfloat16 or float32)."""
    cfg = cfg.validate()
    _dtype(cfg)
    return cfg


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


def _no_scales(module: nn.Module, names) -> None:
    """``name_scale`` of each weight: None until ``quantize_params`` (or
    ``convert`` of a quantized tree) makes the weight int8."""
    for name in names:
        module.register_buffer(f"{name}_scale", None)


class Block(nn.Module):
    """One layer's weights: the JAX ``params["blocks"]`` leaves at one
    index of the stacked ``[L, ...]`` axis. Dense: ``w_gate``/``w_up``
    ``[D, F]``, ``w_down`` ``[F, D]``; MoE: an f32 ``router`` ``[D, E]``
    and expert weights ``[E, D, F]`` / ``[E, F, D]``. Built in the compute
    dtype; an int8 weight is a buffer beside its f32 ``*_scale``
    buffer."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        D, F_, H, Hkv, Dh = (cfg.d_model, cfg.d_ff, cfg.n_heads,
                             cfg.n_kv_heads, cfg.head_dim)
        dt = _dtype(cfg)
        E = cfg.n_experts
        ex = (E,) if E else ()
        self.attn_norm = _param((D,), torch.float32, device)
        self.wq = _param((D, H * Dh), dt, device)
        self.wk = _param((D, Hkv * Dh), dt, device)
        self.wv = _param((D, Hkv * Dh), dt, device)
        self.wo = _param((H * Dh, D), dt, device)
        self.mlp_norm = _param((D,), torch.float32, device)
        self.router = _param((D, E), torch.float32, device) if E else None
        self.w_gate = _param(ex + (D, F_), dt, device)
        self.w_up = _param(ex + (D, F_), dt, device)
        self.w_down = _param(ex + (F_, D), dt, device)
        _no_scales(self, _BLOCK_WEIGHTS)


class Transformer(nn.Module):
    """All model weights. ``lm_head`` is None under tied embeddings."""

    def __init__(self, cfg: ModelConfig, device: DeviceLike = None):
        super().__init__()
        cfg = check_supported(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        D, V = cfg.d_model, cfg.vocab_size
        self.embed = _param((V, D), _dtype(cfg), device)
        self.blocks = nn.ModuleList(
            [Block(cfg, device) for _ in range(cfg.n_layers)]
        )
        self.final_norm = _param((D,), torch.float32, device)
        self.lm_head = (None if cfg.tie_embeddings
                        else _param((D, V), _dtype(cfg), device))
        _no_scales(self, ("embed", "lm_head"))

    @property
    def device(self) -> torch.device:
        return self.embed.device


@torch.no_grad()
def draw_leaves(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike, keep, round_router: bool = True) -> None:
    """The draws of :func:`init_params`, leaf by leaf in its one order:
    ``keep(path, name, w)`` gets each leaf's whole value in f32 (path
    ``()`` for the top level, ``(layer,)`` for a block): a draw of the
    JAX package's init (normal * 0.02, the residual projections damped
    by 1/sqrt(2L)) scaled in place, a norm's ones, the MoE router already
    rounded to the compute dtype (unless not ``round_router``: JAX's
    int8 init keeps its f32 draw). ``keep`` copies what it holds, or
    consumes a weight's draw in place; the draw is dropped when it
    returns, so no more than one leaf's f32 draw is alive beyond what the
    callers keep (an 8B model's embedding draw is 2.1 GB)."""
    D, F_, H, Hkv, Dh = (cfg.d_model, cfg.d_ff, cfg.n_heads,
                         cfg.n_kv_heads, cfg.head_dim)
    ex = (cfg.n_experts,) if cfg.n_experts else ()
    out_scale = 0.02 / (2 * cfg.n_layers) ** 0.5

    def dense(path, name, shape, scale=0.02):
        w = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32).mul_(scale)
        if name == "router" and round_router:
            w = w.to(_dtype(cfg)).float()
        keep(path, name, w)

    for i in range(cfg.n_layers):
        ones = torch.ones(D, device=device)
        keep((i,), "attn_norm", ones)
        keep((i,), "mlp_norm", ones)
        for name, shape in (("wq", (D, H * Dh)), ("wk", (D, Hkv * Dh)),
                            ("wv", (D, Hkv * Dh)), ("w_gate", ex + (D, F_)),
                            ("w_up", ex + (D, F_))):
            dense((i,), name, shape)
        dense((i,), "wo", (H * Dh, D), out_scale)
        dense((i,), "w_down", ex + (F_, D), out_scale)
        if cfg.n_experts:
            dense((i,), "router", (D, cfg.n_experts))
    dense((), "embed", (cfg.vocab_size, D))
    keep((), "final_norm", torch.ones(D, device=device))
    if not cfg.tie_embeddings:
        dense((), "lm_head", (D, cfg.vocab_size))


@torch.no_grad()
def init_params(cfg: ModelConfig, generator: torch.Generator,
                device: DeviceLike = None) -> Transformer:
    """Random bf16 weights with the JAX package's init (normal * 0.02,
    the residual projections damped by 1/sqrt(2L), norms at 1, the MoE
    router drawn in bf16 and held in f32), drawn from ``generator``,
    which must live on ``device`` (:func:`draw_leaves`). The numbers
    differ from ``jax.random``'s for the same seed; tests that compare
    the packages convert JAX's weights with ``convert.params_from_numpy``
    instead. As in JAX, ``cfg.weight_dtype`` does not quantize here: the
    server runs ``quantize.quantize_params`` on the result. A rank's
    shard of the same draws without the whole model:
    ``tp_sharding.init_shard``."""
    model = Transformer(cfg, device)

    def keep(path, name, w):
        mod = model.blocks[path[0]] if path else model
        getattr(mod, name).copy_(w)

    draw_leaves(model.cfg, generator, model.device, keep)
    return model


# ---------------------------------------------------------------------------
# Primitive layers
# ---------------------------------------------------------------------------


def _w(container: nn.Module, name: str, dtype: torch.dtype) -> torch.Tensor:
    """Weight fetch with transparent int8 dequant: ``name_scale`` present
    -> int8 * per-output-channel scale, rounded to ``dtype``."""
    return dequant(getattr(container, name),
                   getattr(container, f"{name}_scale"), dtype)


def _embed_rows(params: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Embedding gather with transparent dequant (the scale is per column,
    so it broadcasts over the gathered rows)."""
    rows = params.embed[tokens.long()]
    scale = params.embed_scale
    if scale is None:
        return rows
    dt = _dtype(params.cfg)
    return rows.to(dt) * scale.to(dt)[0]


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMS norm over the last axis. Inside a dp replica's row share the
    rows run padded to the whole batch's (:func:`whole_batch`, dim 0): on
    the H100 the mean of a replica's 4 rows of 8 was reduced in another
    order than the same rows' among the 8."""
    n = whole_batch(x.shape[0]) if x.dim() > 1 else None
    if n is not None:
        with lt_gemm.row_share(1, 1):
            return rms_norm(pad_batch(x, n), w, eps)[:x.shape[0]]
    xf = x.float()
    scale = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (xf * scale * w).to(x.dtype)


def _rdiv(num: float, t: torch.Tensor) -> torch.Tensor:
    """``num / t`` as one rounded division (``scalar / tensor`` in torch
    is ``reciprocal(t) * num``, two roundings; jnp divides once)."""
    return torch.full_like(t, num) / t


def rope_frequencies(cfg: ModelConfig,
                     device: DeviceLike = None) -> torch.Tensor:
    """Inverse rotary frequencies [head_dim // 2] f32 on ``device``,
    resolved like the entry points': ``cuda`` unless the caller names
    another device."""
    half = cfg.head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=resolve_device(device)) / half
    # The base is filled on the device: a tensor made from a Python
    # number would be a blocking host-to-device copy on every call.
    inv_freq = _rdiv(1.0, torch.pow(
        torch.full_like(exps, cfg.rope_theta), exps))
    if cfg.rope_scaling_type == "linear":
        return inv_freq / cfg.rope_scaling_factor
    if cfg.rope_scaling_type == "llama3":
        # HF transformers' _compute_llama3_parameters: wavelengths past
        # the ORIGINAL context window are slowed by `factor`, those well
        # inside it are untouched, a smooth ramp interpolates between.
        factor = cfg.rope_scaling_factor
        lo_f = cfg.rope_scaling_low_freq_factor
        hi_f = cfg.rope_scaling_high_freq_factor
        old_ctx = cfg.rope_scaling_original_max_position
        wavelen = _rdiv(2.0 * math.pi, inv_freq)
        low_wavelen = old_ctx / lo_f
        high_wavelen = old_ctx / hi_f
        smooth = (_rdiv(old_ctx, wavelen) - lo_f) / (hi_f - lo_f)
        return torch.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            torch.where(
                wavelen < high_wavelen,
                inv_freq,
                (1.0 - smooth) * inv_freq / factor + smooth * inv_freq,
            ),
        )
    return inv_freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: [B, S, H, Dh], positions: [B, S] -> rotated x (half-split)."""
    angles = positions[..., None].float() * inv_freq  # [B, S, half]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token symmetric int8 for W8A8 matmul inputs:
    x [..., D] -> (int8 [..., D], f32 scale [..., 1]). ``x`` is the
    materialized activation (the JAX twin pins it with an
    ``optimization_barrier``; eager PyTorch has already rounded it)."""
    xf = x.float()
    s = torch.clamp(true_div(xf.abs().amax(dim=-1, keepdim=True), 127.0),
                    min=1e-8)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def _w8a8_applies(container: nn.Module, name: str, cfg: ModelConfig) -> bool:
    return (cfg.act_dtype == "int8"
            and getattr(container, name).dtype == torch.int8
            and getattr(container, f"{name}_scale") is not None)


# torch._int_mm on CUDA takes more than 16 rows; fewer are padded with
# zero rows to this many (rows are independent, so the padding is exact).
_INT_MM_MIN_ROWS = 32


def _int_mm(xq: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """s8 [M, K] x s8 [K, N] -> s32 [M, N] by ``torch._int_mm`` (cuBLASLt
    on the card), counted in :data:`int_mm_launches`. Widths the library
    does not take raise; there is no float fallback."""
    M = xq.shape[0]
    if M < _INT_MM_MIN_ROWS:
        xq = torch.cat([xq, xq.new_zeros((_INT_MM_MIN_ROWS - M,
                                           xq.shape[1]))])
    y = torch._int_mm(xq, w)
    host_hooks.host_callback(_count_int_mm)
    return y[:M]


def _count_int_mm() -> None:
    """One ``torch._int_mm`` call: at once, or at every replay of a
    captured wave that holds it (``ops/host_hooks.host_callback``)."""
    global int_mm_launches
    int_mm_launches += 1


def _full_width(cfg: ModelConfig, name: str) -> int:
    """The output width of column-sharded projection ``name`` at tp = 1."""
    return (cfg.d_ff if name in ("w_gate", "w_up") else cfg.head_dim
            * (cfg.n_heads if name == "wq" else cfg.n_kv_heads))


def _tps(cfg: ModelConfig) -> Tuple[int, ...]:
    """The tps of ``lt_gemm.TP_WIDTHS`` the model admits (tp divides
    n_kv_heads and d_ff, ``tp_sharding.validate``)."""
    return tuple(t for t in lt_gemm.TP_WIDTHS
                 if cfg.n_kv_heads % t == 0 and cfg.d_ff % t == 0)


def _qdot(x: torch.Tensor, container: nn.Module, name: str,
          cfg: ModelConfig, act_q=None) -> torch.Tensor:
    """x [..., D] @ W [D, F] with optional W8A8.

    When ``cfg.act_dtype == "int8"`` and the weight is int8-quantized,
    per-token int8 activations (``act_q``, or :func:`_quantize_act` of
    ``x``) feed an s8 x s8 -> s32 product; the scales apply to its f32
    copy, ``(y * xs) * wscale``, then one cast to ``x.dtype``. Otherwise
    ``x`` multiplies the (dequantized) weight in ``x.dtype``: on the card
    and outside autograd through ``ops/lt_gemm.matmul``, a column-sharded
    projection (:data:`COLUMN_SHARDED`) by the algorithm of its full
    width whatever share of it a rank holds, and every projection by the
    algorithm of the whole batch's rows inside a dp replica's
    ``lt_gemm.row_share``; the training route ``x @ W``. ``act_q`` shares
    one quantization across the projections of the same input."""
    if not _w8a8_applies(container, name, cfg):
        w = _w(container, name, x.dtype)
        if x.is_cuda and not torch.is_grad_enabled():
            # The full width's cuBLASLt algorithm at every share of its
            # columns, so a tp rank's columns equal tp = 1's bit for bit
            # (C18); cuBLAS's own choice for wo depends on M, so a dp
            # replica's rows would not equal dp = 1's (C25).
            if name in COLUMN_SHARDED:
                return lt_gemm.matmul(x, w, _full_width(cfg, name),
                                      _tps(cfg))
            return lt_gemm.matmul(x, w, w.shape[1], (1,))
        return x @ w
    w = getattr(container, name)
    wscale = getattr(container, f"{name}_scale")
    xq, xs = act_q if act_q is not None else _quantize_act(x)
    lead = xq.shape[:-1]
    y = _int_mm(xq.reshape(-1, xq.shape[-1]), w).reshape(*lead, -1)
    return ((y.float() * xs) * wscale.float()).to(x.dtype)


def _heads(cfg: ModelConfig, tp=None) -> Tuple[int, int]:
    """(query heads, KV heads) this rank computes: all of them, or its
    1/tp share under tensor parallelism (``models/tp_sharding.py``)."""
    if tp is None:
        return cfg.n_heads, cfg.n_kv_heads
    return tp.n_heads(cfg), tp.n_kv_heads(cfg)


def _qkv(h, bp, cfg: ModelConfig, positions, inv_freq, tp=None):
    """q, k, v [B, S, heads, Dh], rope applied. Under ``tp`` the heads
    are the rank's own: each rank computes the FULL d_model contraction
    for its contiguous slice of heads (``tp.heads`` checks the slice, or
    cuts it from the replicated projections of an MoE config; rope acts
    per head, so cutting first gives the same bits)."""
    B, S, _ = h.shape
    Hkv, Dh = cfg.n_kv_heads, cfg.head_dim
    hq = _quantize_act(h) if _w8a8_applies(bp, "wq", cfg) else None
    if tp is None:
        q = _qdot(h, bp, "wq", cfg, hq).reshape(B, S, cfg.n_heads, Dh)
        k = _qdot(h, bp, "wk", cfg, hq).reshape(B, S, Hkv, Dh)
        v = _qdot(h, bp, "wv", cfg, hq).reshape(B, S, Hkv, Dh)
    else:
        q, k, v = (tp.heads(_qdot(h, bp, name, cfg, hq).reshape(
            B, S, -1, Dh), cfg) for name in ("wq", "wk", "wv"))
    return apply_rope(q, positions, inv_freq), \
        apply_rope(k, positions, inv_freq), v


def _wo(attn, bp, cfg: ModelConfig, tp=None):
    """The attention output projection. Under ``tp`` the rank's
    head-sharded output is ALL-GATHERED first (exact data movement) and
    the replicated ``wo`` contraction runs whole on every rank."""
    if tp is not None:
        attn = tp.gather(tp.flat(attn, cfg.n_heads * cfg.head_dim))
    return _qdot(attn, bp, "wo", cfg)


def _bf16_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A bf16 einsum as XLA computes one: f32 products and sums, one
    rounding of the output."""
    return torch.einsum(eq, a.float(), b.float()).to(a.dtype)


def moe_block(x: torch.Tensor, bp: nn.Module, cfg: ModelConfig,
              stats=None, par=None):
    """Top-k MoE, the JAX package's dense-mixing formulation: every expert
    runs on every token and the results mix with the sparsified router
    weights (softmax over the top-k f32 router logits). Returns (out
    [B, S, D], the Switch-style load-balance aux, an f32 scalar).

    ``stats`` averages a per-rank statistic over the ranks that hold
    equal blocks of the batch and sequence (a ring's sp ranks when
    serving, dp x sp when training): the routed fraction and the mean
    router probability are averaged over them BEFORE their product, so
    the aux is the statistic of the whole batch, as JAX computes it on
    its global arrays. ``par`` (the training route's
    ``parallel/sharding.MegatronHints``) runs this rank's expert shard:
    the experts of its ep block with their d_ff cut over tp; the tp
    partial sums meet before the mixing and the ep partial mixes after
    it (Megatron's g), and the input and the mixing weights enter
    through f, so every rank's gradient of what it holds whole is the
    full one."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.n_experts_per_token
    logits = x.float() @ bp.router  # [B, S, E] f32
    probs_full = torch.softmax(logits, dim=-1)
    top_vals, top_idx = torch.topk(logits, K, dim=-1)  # [B, S, K]
    gates = torch.softmax(top_vals, dim=-1)
    onehot = F.one_hot(top_idx.long(), E).float()
    # A size-1 label would broadcast silently in the einsum below.
    assert onehot.shape == (B, S, K, E), onehot.shape
    mix = torch.einsum("bske,bsk->bse", onehot, gates)
    frac = onehot.sum(dim=2).mean(dim=(0, 1)) / K  # [E]
    mean_prob = probs_full.mean(dim=(0, 1))
    if stats is not None:
        frac, mean_prob = stats(frac), stats(mean_prob)
    lb_loss = E * (frac * mean_prob).sum()
    if par is not None:
        from seldon_tpu_torch.parallel.distributed import copy_to, reduce_from

        e0, e1 = par.expert_range(E)
        mix = copy_to(mix, par.ep)[:, :, e0:e1]
        x = copy_to(x, par.experts)
    gate = _bf16_einsum("bsd,edf->besf", x, _w(bp, "w_gate", x.dtype))
    up = _bf16_einsum("bsd,edf->besf", x, _w(bp, "w_up", x.dtype))
    hidden = (F.silu(gate.float()) * up.float()).to(x.dtype)
    expert_out = _bf16_einsum("besf,efd->besd", hidden,
                              _w(bp, "w_down", x.dtype))
    if par is None:
        return _bf16_einsum("besd,bse->bsd", expert_out,
                            mix.to(x.dtype)), lb_loss
    expert_out = reduce_from(expert_out, par.tp)
    return reduce_from(_bf16_einsum("besd,bse->bsd", expert_out,
                                    mix.to(x.dtype)), par.ep), lb_loss


def _group_mean(group):
    """The mean over ``group`` of a per-rank statistic (a sum of the
    gradients backward), or None for a group of one rank."""
    if group is None or group.world == 1:
        return None
    from seldon_tpu_torch.parallel.distributed import all_reduce_sum

    return lambda t: true_div(all_reduce_sum(t, group), group.world)


def _mlp_res(x, bp, cfg: ModelConfig, tp=None, stats=None):
    """Post-attention half of a block: residual + (SwiGLU | MoE). Returns
    (x, aux): the MoE load-balance aux, None for dense configs. The
    ``silu(gate) * up`` chain is one XLA fusion in the JAX package, so it
    runs in f32 here and rounds once. Under ``tp`` gate/up run sharded on
    d_ff and the hidden is ALL-GATHERED before the replicated w_down
    contraction (no partial sum ever forms); MoE weights replicate, so
    that branch needs no hints. ``stats``: see :func:`moe_block`."""
    h = rms_norm(x, bp.mlp_norm, cfg.rms_norm_eps)
    if cfg.n_experts:
        out, aux = moe_block(h, bp, cfg, stats)
        return x + out, aux
    hq = _quantize_act(h) if _w8a8_applies(bp, "w_gate", cfg) else None
    hidden = (F.silu(_qdot(h, bp, "w_gate", cfg, hq).float())
              * _qdot(h, bp, "w_up", cfg, hq).float()).to(x.dtype)
    if tp is not None:
        hidden = tp.gather(tp.flat(hidden, cfg.d_ff))
    return x + _qdot(hidden, bp, "w_down", cfg), None


def gqa_attention(
    q: torch.Tensor,  # [B, Sq, H, Dh]
    k: torch.Tensor,  # [B, Skv, Hkv, Dh]
    v: torch.Tensor,  # [B, Skv, Hkv, Dh]
    mask: torch.Tensor,  # [B, Sq, Skv] bool (True = attend)
) -> torch.Tensor:
    """Grouped-query attention, f32 softmax. Returns [B, Sq, H*Dh]. Inside
    a dp replica's row share the batch runs padded to the whole batch's
    size (:func:`whole_batch`)."""
    n = whole_batch(q.shape[0])
    if n is not None:
        with lt_gemm.row_share(1, 1):
            return gqa_attention(*(pad_batch(t, n) for t in (q, k, v, mask))
                                 )[:q.shape[0]]
    B, Sq, H, Dh = q.shape
    Hkv = k.shape[2]
    assert k.shape == v.shape and k.shape[0] == B and k.shape[3] == Dh
    G = H // Hkv
    qr = q.reshape(B, Sq, Hkv, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qr.float(),
                          k.float()) / (Dh ** 0.5)
    scores = torch.where(mask[:, None, None, :, :], scores, NEG_MASK)
    w = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w.float(), v.float())
    return out.to(q.dtype).reshape(B, Sq, H * Dh)


def gqa_attention_decode(
    q: torch.Tensor,  # [B, 1, H, Dh]
    ck: torch.Tensor,  # [B, Hkv, T, Dh] OLD cache (pre-write; int8 if scaled)
    cv: torch.Tensor,  # [B, Hkv, T, Dh]
    k_fresh: torch.Tensor,  # [B, 1, Hkv, Dh] this token's exact k
    v_fresh: torch.Tensor,  # [B, 1, Hkv, Dh]
    mask_lt: torch.Tensor,  # [B, 1, T] True where t < pos (strict)
    k_scale: Optional[torch.Tensor] = None,  # [B, Hkv, T] bf16 (int8 cache)
    v_scale: Optional[torch.Tensor] = None,
    tp=None,
) -> torch.Tensor:
    """Decode attention over the PRE-write head-major cache plus one fresh
    column; int8 scales factored out of the products (scores * k_scale,
    weights * v_scale), exactly the JAX term set. Returns [B, 1, H*Dh].
    Under ``tp`` (this rank's heads) the products run at tp = 1's head
    count (``TpHints.pad_heads``: on the H100 a rank's share of the
    heads, batched alone, was reduced in another order; ROADMAP.md C18)
    and the rank's part is returned. Inside a dp replica's row share the
    batch runs padded to the whole batch's size (:func:`whole_batch`)."""
    if tp is not None:
        def pad(t, dim):
            return None if t is None else tp.pad_heads(t, dim)

        return tp.own_heads(gqa_attention_decode(
            pad(q, 2), pad(ck, 1), pad(cv, 1), pad(k_fresh, 2),
            pad(v_fresh, 2), mask_lt, pad(k_scale, 1), pad(v_scale, 1)), 2)
    n = whole_batch(q.shape[0])
    if n is not None:
        with lt_gemm.row_share(1, 1):
            return gqa_attention_decode(*(pad_batch(t, n) for t in (
                q, ck, cv, k_fresh, v_fresh, mask_lt, k_scale, v_scale)))[
                    :q.shape[0]]
    B, S, H, Dh = q.shape
    Hkv = ck.shape[1]
    assert ck.shape == cv.shape and ck.shape[0] == B
    assert k_fresh.shape == (B, S, Hkv, Dh) == v_fresh.shape
    G = H // Hkv
    qr = q.reshape(B, S, Hkv, G, Dh)
    qf = qr.float()
    scores = torch.einsum("bskgd,bktd->bkgst", qf,
                          ck.to(q.dtype).float()) / (Dh ** 0.5)
    if k_scale is not None:
        scores = scores * k_scale.float()[:, :, None, None, :]
    s_fresh = torch.einsum("bskgd,bukd->bkgsu", qf,
                           k_fresh.to(q.dtype).float()) / (Dh ** 0.5)
    scores = torch.where(mask_lt[:, None, None, :, :], scores, NEG_MASK)
    m = torch.maximum(scores.amax(dim=-1, keepdim=True), s_fresh)
    p = torch.exp(scores - m)
    p_f = torch.exp(s_fresh - m)
    l = p.sum(dim=-1, keepdim=True) + p_f
    wc = p / l
    if v_scale is not None:
        wc = wc * v_scale.float()[:, :, None, None, :]
    out = torch.einsum(
        "bkgst,bktd->bskgd", wc.to(q.dtype).float(), cv.to(q.dtype).float()
    ).to(q.dtype) + torch.einsum(
        "bkgsu,bukd->bskgd", (p_f / l).to(q.dtype).float(),
        v_fresh.to(q.dtype).float(),
    ).to(q.dtype)
    return out.reshape(B, S, H * Dh)


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8: x [..., Dh] -> (int8 [..., Dh],
    bf16 scale [...]). ``torch.round`` rounds half to even, like
    ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(true_div(xf.abs().amax(dim=-1), 127.0), min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _logits(params: Transformer, x: torch.Tensor,
            cfg: ModelConfig) -> torch.Tensor:
    """f32 logits of bf16 hidden states (the JAX einsum's
    ``preferred_element_type=f32``) against the (dequantized) head: the
    tied embedding in its own ``[V, D]`` layout, or ``lm_head``."""
    x = rms_norm(x, params.final_norm, cfg.rms_norm_eps)
    if x.is_cuda and not torch.is_grad_enabled():
        # The pinned f32 GEMM: cuBLAS's own choice depends on the rows, so
        # a dp replica's logits would not equal dp = 1's (C25).
        w = (_w(params, "embed", x.dtype).float().t()
             if params.lm_head is None
             else _w(params, "lm_head", x.dtype).float())
        return lt_gemm.matmul(x.float(), w, w.shape[1], (1,))
    if params.lm_head is None:
        return torch.einsum("bsd,vd->bsv", x.float(),
                            _w(params, "embed", x.dtype).float())
    return x.float() @ _w(params, "lm_head", x.dtype).float()


def _take_last(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """x [B, S, D], last [B] -> [B, 1, D] rows at each row's index."""
    idx = last.long()[:, None, None].expand(x.shape[0], 1, x.shape[2])
    return torch.gather(x, 1, idx)


# ---------------------------------------------------------------------------
# Full-sequence attention and the cache-free blocks (scoring)
# ---------------------------------------------------------------------------


def _use_flash(cfg: ModelConfig, S: int) -> bool:
    return cfg.attn_impl == "flash" and S > 1


def _causal_mask(B: int, S: int, device: torch.device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril()[
        None].expand(B, S, S)


def _use_ring(cfg: ModelConfig, S: int, ring) -> bool:
    return ring is not None and cfg.attn_impl == "ring" and S > 1


def _full_attention(q, k, v, mask, cfg: ModelConfig,
                    ring=None) -> torch.Tensor:
    """Causal attention over the fresh tokens, [B, S, H*Dh]. Under
    ``attn_impl="flash"`` the flash kernel runs with native GQA; the fold
    ``[B, S, n, Dh] -> [B*n, S, Dh]`` stays a transpose outside it, as in
    the JAX package. Under ``"ring"`` with an sp group ``ring`` the
    tokens are this rank's block of the sequence and attention is the
    ring (``parallel/ring_attention.py``: only the Hkv-head K/V rotate;
    callers pass ``ring`` only where :func:`_use_ring` holds). Otherwise (``"xla"``, and ``"ring"`` with no group) the einsum
    attention reads ``mask``."""
    B, S, H, Dh = q.shape
    if ring is not None:
        from seldon_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, ring, causal=True).reshape(
            B, S, H * Dh)
    if not _use_flash(cfg, S):
        return gqa_attention(q, k, v, mask)

    def fold(t):
        # contiguous(): at B = 1 the reshape is a strided view, which the
        # kernel refuses.
        return t.transpose(1, 2).reshape(B * t.shape[2], S, Dh).contiguous()

    out = flash_attention(fold(q), fold(k), fold(v), causal=True,
                          q_per_kv=cfg.q_per_kv)
    return out.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)


def _block(x, bp, cfg: ModelConfig, positions, inv_freq, mask, tp=None,
           ring=None, stats=None):
    """One cache-free block (scoring). Returns (x, aux); ``stats`` (the
    ring's mean, when the caller asks for the aux) makes the MoE aux the
    statistic of the whole sequence (A29)."""
    h = rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
    q, k, v = _qkv(h, bp, cfg, positions, inv_freq, tp)
    x = x + _wo(_full_attention(q, k, v, mask, cfg, ring), bp, cfg, tp)
    return _mlp_res(x, bp, cfg, tp, stats)


def _run_blocks(params, x, cfg, positions, inv_freq, mask, tp=None,
                ring=None, stats=None):
    """Cache-free layer loop. Returns (x, the layers' mean MoE aux; a
    zero for dense configs)."""
    auxs = []
    for bp in params.blocks:
        x, aux = _block(x, bp, cfg, positions, inv_freq, mask, tp, ring,
                        stats)
        auxs.append(aux)
    if cfg.n_experts:
        return x, torch.stack(auxs).mean()
    return x, torch.zeros((), device=x.device)


def _seq_block(S: int, ring) -> Tuple[int, int]:
    """(start, length) of this sp rank's block of an S-token sequence."""
    if S % ring.world:
        raise ValueError(f"ring attention over {ring.world} ranks needs "
                         f"S % {ring.world} == 0, got S={S}")
    s = S // ring.world
    return ring.rank * s, s


@torch.no_grad()
def forward_hidden(params: Transformer, tokens: torch.Tensor,
                   cfg: ModelConfig, ring=None, tp=None,
                   return_aux: bool = False):
    """The layers of :func:`forward`: (final hidden [B, S, D], the MoE
    aux with ``return_aux``, else None). Under ``attn_impl="ring"`` with
    an sp group ``ring`` this rank runs its block of the sequence through
    every layer (ring attention across the group) and the blocks are
    all-gathered at the end, so every rank returns the whole sequence's
    hidden states; with ``return_aux`` the MoE aux is the whole
    sequence's (each layer's routed fraction and mean probability
    averaged over the ring before their product: two more all-reduces a
    layer, made only when asked). ``tp``: the rank's heads and shards,
    beside the ring too (an sp x tp group: the ring passes the rank's
    own KV heads among the ranks of its tp coordinate, the gathers run
    inside its tp group). Every rank of the group must call it, with
    the same ``return_aux``."""
    B, S = tokens.shape
    dev = tokens.device
    if _use_ring(cfg, S, ring):
        lo, s = _seq_block(S, ring)
        x = _embed_rows(params, tokens[:, lo:lo + s])
        positions = torch.arange(lo, lo + s, device=dev)[None].expand(B, s)
        x, aux = _run_blocks(params, x, cfg, positions,
                             rope_frequencies(cfg, dev), None, tp, ring,
                             stats=_group_mean(ring) if return_aux else None)
        return ring.all_gather(x, 1), aux if return_aux else None
    x = _embed_rows(params, tokens)
    positions = torch.arange(S, device=dev)[None].expand(B, S)
    inv_freq = rope_frequencies(cfg, dev)
    mask = None if _use_flash(cfg, S) else _causal_mask(B, S, dev)
    x, aux = _run_blocks(params, x, cfg, positions, inv_freq, mask, tp)
    return x, aux if return_aux else None


@torch.no_grad()
def forward(params: Transformer, tokens: torch.Tensor, cfg: ModelConfig,
            return_aux: bool = False, ring=None, tp=None):
    """Full-sequence teacher-forced logits [B, S, V] f32 (scoring). With
    ``return_aux`` also {"moe_lb_loss": the layers' mean load-balance
    aux, zero for dense configs}. ``ring`` (an sp rank group, with
    ``cfg.attn_impl == "ring"``) runs the layers context-parallel
    (:func:`forward_hidden`); ``tp`` runs them on the rank's shards.
    Every rank of the group must call it. The differentiable training
    route is :func:`forward_train`."""
    x, aux = forward_hidden(params, tokens, cfg, ring, tp, return_aux)
    logits = _logits(params, x, cfg)
    if return_aux:
        return logits, {"moe_lb_loss": aux}
    return logits


# ---------------------------------------------------------------------------
# The training route (differentiable)
# ---------------------------------------------------------------------------
#
# JAX's forward(..., remat=True, return_aux=True, ring_mesh=...), with the
# parameters' gradients: one rank's part of the step of models/train.py.
# Every collective goes through the ``hints`` (parallel/sharding's
# MegatronHints at this rank's mesh coordinate); on one rank each is the
# identity and the arithmetic is the scoring path's, op for op.


def single_hints(device: DeviceLike = None):
    """The training route's hints for one rank on ``device`` (every group
    of one member)."""
    from seldon_tpu_torch.parallel import distributed, mesh, sharding

    dev = resolve_device(device)
    return sharding.MegatronHints(distributed.MeshRanks.single(
        mesh.make_mesh(mesh.MeshPlan(), [dev]), dev))


def embed_train(params: Transformer, tokens: torch.Tensor,
                hints) -> torch.Tensor:
    """Embedding rows of ``tokens`` [B, s]. Under tp the rank holds the
    vocabulary rows [lo, hi): rows it does not hold are zeros, and the
    ranks' rows are summed (Megatron's g; one nonzero term per row, so
    the sum is exact)."""
    if hints.tp.world == 1:
        return _embed_rows(params, tokens)
    lo, hi = hints.vocab_range(params.cfg.vocab_size)
    local = tokens.long() - lo
    held = (local >= 0) & (local < hi - lo)
    rows = params.embed[local.clamp(0, hi - lo - 1)]
    rows = torch.where(held[..., None], rows, rows.new_zeros(()))
    return hints.g(rows)


def _attention_train(q, k, v, positions, cfg: ModelConfig, hints):
    """Causal attention of this rank's queries [B, s, H, Dh] at global
    ``positions`` [B, s]. Under sp: the ring (``attn_impl="ring"``,
    differentiable), or the K/V blocks all-gathered over sp (``"xla"``;
    their gradients reduce-scattered back). ``"flash"`` runs the flash
    wrapper, whose CUDA kernel has no backward and refuses a gradient."""
    B, s, H, Dh = q.shape
    sp = hints.sp
    if cfg.attn_impl == "ring" and sp.world > 1:
        from seldon_tpu_torch.parallel.ring_attention import ring_attention

        return ring_attention(q, k, v, sp, causal=True).reshape(B, s, H * Dh)
    if _use_flash(cfg, s):
        if sp.world > 1:
            raise ValueError("attn_impl='flash' needs the whole sequence on "
                             "each rank: train it with sp = 1")
        return _full_attention(q, k, v, None, cfg)
    if sp.world > 1:
        from seldon_tpu_torch.parallel.distributed import gather_along

        k, v = gather_along(k, sp, 1), gather_along(v, sp, 1)
    cols = torch.arange(k.shape[1], device=q.device)
    return gqa_attention(q, k, v, positions[:, :, None] >= cols)


def _block_train(x, bp, cfg: ModelConfig, positions, inv_freq, hints):
    """One block of the training route. Under tp the rank holds its heads
    and its d_ff slice: wq/wk/wv and w_gate/w_up are column-parallel
    behind f, wo and w_down row-parallel in front of g. Returns (x, the
    MoE aux or None)."""
    B, s, _ = x.shape
    Dh = cfg.head_dim
    h = hints.f(rms_norm(x, bp.attn_norm, cfg.rms_norm_eps))
    q = _qdot(h, bp, "wq", cfg).reshape(B, s, -1, Dh)
    k = _qdot(h, bp, "wk", cfg).reshape(B, s, -1, Dh)
    v = _qdot(h, bp, "wv", cfg).reshape(B, s, -1, Dh)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    attn = _attention_train(q, k, v, positions, cfg, hints)
    x = x + hints.g(_qdot(attn, bp, "wo", cfg))
    h = rms_norm(x, bp.mlp_norm, cfg.rms_norm_eps)
    if cfg.n_experts:
        out, aux = moe_block(h, bp, cfg, _group_mean(hints.stats), hints)
        return x + out, aux
    hf = hints.f(h)
    hidden = (F.silu(_qdot(hf, bp, "w_gate", cfg).float())
              * _qdot(hf, bp, "w_up", cfg).float()).to(x.dtype)
    return x + hints.g(_qdot(hidden, bp, "w_down", cfg)), None


def blocks_train(params: Transformer, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, hints, remat: bool):
    """The blocks ``params`` holds (all of them, or a pipeline stage's),
    each under ``torch.utils.checkpoint`` when ``remat`` (JAX's
    ``jax.checkpoint`` of the scan body: only each block's input is kept
    for the backward). Returns (x, the SUM of the blocks' MoE aux; a zero
    for dense configs)."""
    from torch.utils.checkpoint import checkpoint

    inv_freq = rope_frequencies(cfg, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in params.blocks:
        if remat:
            x, a = checkpoint(_block_train, x, bp, cfg, positions, inv_freq,
                              hints, use_reentrant=False)
        else:
            x, a = _block_train(x, bp, cfg, positions, inv_freq, hints)
        if a is not None:
            aux = aux + a
    return x, aux


def logits_train(params: Transformer, x: torch.Tensor, cfg: ModelConfig,
                 hints) -> torch.Tensor:
    """f32 logits [B, s, V] of the final hidden states, as
    :func:`_logits`; under tp each rank's vocabulary shard of the head
    (behind f) is gathered whole (the backward keeps the rank's part)."""
    x = hints.f(rms_norm(x, params.final_norm, cfg.rms_norm_eps))
    if params.lm_head is None:
        local = torch.einsum("bsd,vd->bsv", x.float(),
                             _w(params, "embed", x.dtype).float())
    else:
        local = x.float() @ _w(params, "lm_head", x.dtype).float()
    return hints.vocab(local)


def positions_of(tokens: torch.Tensor, hints) -> torch.Tensor:
    """Global positions [B, s] of this rank's block of the sequence (the
    sp rank's block; the whole sequence without sp)."""
    B, s = tokens.shape
    lo = hints.sp.rank * s
    return torch.arange(lo, lo + s, device=tokens.device)[None].expand(B, s)


def forward_train(params: Transformer, tokens: torch.Tensor,
                  cfg: ModelConfig, hints=None):
    """Teacher-forced logits [B, s, V] f32 and {"moe_lb_loss": the
    layers' mean load-balance aux (zero for dense configs)}, with
    gradients: the route JAX's ``forward(..., remat=True,
    return_aux=True, ring_mesh=...)`` takes (every block
    rematerialized). ``tokens`` are this rank's
    rows and its sp block of the sequence; ``hints`` (default: one rank
    on ``tokens``' device) carries the rank's collectives."""
    if hints is None:
        hints = single_hints(tokens.device)
    x = embed_train(params, tokens, hints)
    x, aux = blocks_train(params, x, cfg, positions_of(tokens, hints),
                          hints, remat=True)
    return (logits_train(params, x, cfg, hints),
            {"moe_lb_loss": true_div(aux, cfg.n_layers)})


# ---------------------------------------------------------------------------
# Dense cache: whole-batch prefill and decode (models/generate.py)
# ---------------------------------------------------------------------------


# The int8 caches' initial scales: never-written slots dequantize to
# exact zeros.
SCALE_INIT = 1e-8


def reset_cache(cache: Cache) -> None:
    """A cache of :func:`init_cache` or :func:`init_paged_cache` back to
    its initial values, in place."""
    for key, arr in cache.items():
        if key.endswith("_scale"):
            arr.fill_(SCALE_INIT)
        else:
            arr.zero_()


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: Optional[torch.dtype] = None,
               device: DeviceLike = None, tp=None) -> Cache:
    """KV cache, HEAD-major [L, B, Hkv, T, Dh] (scales [L, B, Hkv, T]);
    under ``tp`` the rank's Hkv / tp heads. int8 scales start at 1e-8 so
    never-written slots dequantize to exact zeros."""
    device = resolve_device(device)
    shape = (cfg.n_layers, batch, _heads(cfg, tp)[1], max_len,
             cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        if dtype is not None:
            raise ValueError("a dtype override is meaningless for an int8 "
                             "cache (int8 codes + bf16 scales)")
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.full(shape[:-1], SCALE_INIT, dtype=torch.bfloat16,
                                  device=device),
            "v_scale": torch.full(shape[:-1], SCALE_INIT, dtype=torch.bfloat16,
                                  device=device),
        }
    dt = dtype or _dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def _run_blocks_prefill(params, x, cfg, positions, inv_freq, mask,
                        tp=None, ring=None):
    """Layer loop for a cold prefill: attention over the fresh tokens only
    (a prefill starts at position 0), each layer's rope'd k/v kept in the
    head-major cache layout. Returns (x, {"k","v"} [L, B, Hkv, S, Dh]).
    Under ``ring`` the tokens are this sp rank's block and attention is
    the ring; under ``tp`` the heads are the rank's own."""
    ks, vs = [], []
    for bp in params.blocks:
        h = rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = _qkv(h, bp, cfg, positions, inv_freq, tp)
        x = x + _wo(_full_attention(q, k, v, mask, cfg, ring), bp, cfg, tp)
        x, _ = _mlp_res(x, bp, cfg, tp)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


@torch.no_grad()
def prefill(
    params: Transformer,
    tokens: torch.Tensor,  # [B, S] right-padded prompts
    prompt_lens: torch.Tensor,  # [B] true lengths
    cache: Cache,
    cfg: ModelConfig,
    ring=None,
    tp=None,
) -> Tuple[torch.Tensor, Cache]:
    """Run prompts through the model, filling cache columns [0, S) IN
    PLACE. Returns (next-token logits [B, V] f32 at each row's last real
    token, the cache). ``ring`` + ``cfg.attn_impl == "ring"``:
    context-parallel prefill — this sp rank runs its block of the
    prompt, attention is the ring, and the hidden states and k/v blocks
    are all-gathered before the cache write (every rank of the group
    must call it). ``tp``: the rank's heads and cache shard."""
    B, S = tokens.shape
    dev = tokens.device
    inv_freq = rope_frequencies(cfg, dev)
    if _use_ring(cfg, S, ring):
        lo, s = _seq_block(S, ring)
        x = _embed_rows(params, tokens[:, lo:lo + s])
        positions = torch.arange(lo, lo + s, device=dev)[None].expand(B, s)
        x, kv = _run_blocks_prefill(params, x, cfg, positions, inv_freq,
                                    None, tp, ring)
        x = ring.all_gather(x, 1)
        kv = {key: ring.all_gather(val, 3) for key, val in kv.items()}
    else:
        x = _embed_rows(params, tokens)
        positions = torch.arange(S, device=dev)[None].expand(B, S)
        mask = None if _use_flash(cfg, S) else _causal_mask(B, S, dev)
        x, kv = _run_blocks_prefill(params, x, cfg, positions, inv_freq,
                                    mask, tp)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _quantize_kv(kv["k"])
        vq, vs = _quantize_kv(kv["v"])
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        writes = {key: kv[key].to(cache["k"].dtype) for key in ("k", "v")}
    for key in cache:
        # T is dim 3 of k/v and the last dim of the scales.
        cache[key][:, :, :, :S] = writes[key]
    last = torch.clamp(prompt_lens - 1, 0, S - 1)
    return _logits(params, _take_last(x, last), cfg)[:, 0], cache


def _write_cache_column(cache: Cache, fresh: Cache,
                        pos: torch.Tensor) -> Cache:
    """All layers' fresh k/v ({key: [L, B, Hkv, (Dh)]}) at column pos[b]
    of row b, IN PLACE. A pos at or past the cache's end writes nothing,
    as the JAX scatter drops it (decided on the device, no host wait)."""
    T = cache["k"].shape[3]
    rows = torch.arange(pos.shape[0], device=pos.device)
    col = torch.clamp(pos, max=T - 1).long()
    inside = pos < T
    for key in cache:
        new = fresh[key].transpose(0, 1)  # [B, L, Hkv, (Dh)]
        keep = inside.view(-1, *([1] * (new.dim() - 1)))
        cache[key][:, rows, :, col] = torch.where(
            keep, new, cache[key][:, rows, :, col])
    return cache


def _run_blocks_decode(params, x, cfg, positions, inv_freq, pos, cache,
                       tp=None):
    """Decode layer loop: each layer reads the PRE-write cache (the
    current token rides as an exact fresh column in
    gqa_attention_decode); all layers' fresh k/v land after the loop in
    one write. Returns (x, cache)."""
    T = cache["k"].shape[3]
    mask_lt = (torch.arange(T, device=x.device)[None, None, :]
               < pos[:, None, None])
    fresh = []
    for layer, bp in enumerate(params.blocks):
        cl = {key: arr[layer] for key, arr in cache.items()}
        h = rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = _qkv(h, bp, cfg, positions, inv_freq, tp)
        attn = gqa_attention_decode(
            q, cl["k"], cl["v"], k, v, mask_lt,
            k_scale=cl.get("k_scale"), v_scale=cl.get("v_scale"), tp=tp,
        )
        x = x + _wo(attn, bp, cfg, tp)
        x, _ = _mlp_res(x, bp, cfg, tp)
        fresh.append(_fresh_kv(k[:, 0], v[:, 0], cfg, cache["k"].dtype))
    stacked = {key: torch.stack([f[key] for f in fresh]) for key in cache}
    return x, _write_cache_column(cache, stacked, pos)


@torch.no_grad()
def decode_step(
    params: Transformer,
    token: torch.Tensor,  # [B] int32 current tokens
    pos: torch.Tensor,  # [B] int32 positions to write at
    cache: Cache,
    cfg: ModelConfig,
    tp=None,
) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step over the dense cache. Returns (logits
    [B, V] f32, the cache updated in place)."""
    x = _embed_rows(params, token)[:, None, :]
    inv_freq = rope_frequencies(cfg, token.device)
    x, cache = _run_blocks_decode(params, x, cfg, pos[:, None], inv_freq,
                                  pos, cache, tp)
    return _logits(params, x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# Prefill against a resident prefix
# ---------------------------------------------------------------------------


def _run_blocks_prefill_prefix(params, x, cfg, positions, inv_freq, mask,
                               prefix_kv, tp=None):
    """Layer loop for SUFFIX prefill: attention over the resident prefix
    KV (``prefix_kv`` stacked [L, B, Hkv, Pb, (Dh)] in cache dtype, int8
    dequantized into the activation dtype per layer) plus the fresh
    suffix. Returns (x, fresh suffix {"k","v"} [L, B, Hkv, S, Dh])."""
    quantized = "k_scale" in prefix_kv
    ks, vs = [], []
    for layer, bp in enumerate(params.blocks):
        pl = {key: arr[layer] for key, arr in prefix_kv.items()}
        h = rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = _qkv(h, bp, cfg, positions, inv_freq, tp)
        pk = pl["k"].to(q.dtype)
        pv = pl["v"].to(q.dtype)
        if quantized:
            pk = pk * pl["k_scale"][..., None].to(q.dtype)
            pv = pv * pl["v_scale"][..., None].to(q.dtype)
        k_all = torch.cat([pk.transpose(1, 2), k], dim=1)
        v_all = torch.cat([pv.transpose(1, 2), v], dim=1)
        if tp is not None:
            k_all, v_all = tp.heads(k_all, cfg), tp.heads(v_all, cfg)
        attn = gqa_attention(q, k_all, v_all, mask)
        x = x + _wo(attn, bp, cfg, tp)
        x, _ = _mlp_res(x, bp, cfg, tp)
        ks.append(k.transpose(1, 2))
        vs.append(v.transpose(1, 2))
    return x, {"k": torch.stack(ks), "v": torch.stack(vs)}


@torch.no_grad()
def prefill_with_prefix(
    params: Transformer,
    tokens: torch.Tensor,  # [B, Sq] right-padded SUFFIX tokens
    prompt_lens: torch.Tensor,  # [B] FULL prompt lengths
    prefix_kv: Cache,  # [L, B, Hkv, Pb, (Dh)] resident prefix, cache dtype
    prefix_lens: torch.Tensor,  # [B] true prefix lengths (<= Pb)
    cfg: ModelConfig,
    tp=None,
) -> Tuple[torch.Tensor, Cache]:
    """Prefill that resumes at a position offset: suffix q/k rotate at
    their absolute positions, the mask exposes prefix columns
    t < prefix_len plus the causal triangle over the suffix. Returns
    (next-token logits [B, V] f32 at each row's last real suffix token,
    fresh suffix KV {"k","v"} [L, B, Hkv, Sq, Dh])."""
    B, Sq = tokens.shape
    Pb = prefix_kv["k"].shape[3]
    dev = tokens.device
    x = _embed_rows(params, tokens)
    positions = prefix_lens[:, None] + torch.arange(Sq, device=dev)[None, :]
    inv_freq = rope_frequencies(cfg, dev)
    pmask = (torch.arange(Pb, device=dev)[None, None, :]
             < prefix_lens[:, None, None]).expand(B, Sq, Pb)
    smask = torch.ones(Sq, Sq, dtype=torch.bool, device=dev).tril()
    mask = torch.cat([pmask, smask[None].expand(B, Sq, Sq)], dim=2)
    x, kv = _run_blocks_prefill_prefix(params, x, cfg, positions, inv_freq,
                                       mask, prefix_kv, tp)
    last = torch.clamp(prompt_lens - prefix_lens - 1, 0, Sq - 1)
    return _logits(params, _take_last(x, last), cfg)[:, 0], kv


# ---------------------------------------------------------------------------
# Paged KV pool
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block: int,
                     device: DeviceLike = None, tp=None) -> Cache:
    """Paged KV pool: HEAD-major [L, NB, Hkv, block, Dh] (scales
    [L, NB, Hkv, block]); under ``tp`` the rank's Hkv / tp heads. int8
    scales start at 1e-8 so never-written slots dequantize to exact
    zeros."""
    device = resolve_device(device)
    shape = (cfg.n_layers, num_blocks, _heads(cfg, tp)[1], block,
             cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.full(shape[:-1], SCALE_INIT, dtype=torch.bfloat16,
                                  device=device),
            "v_scale": torch.full(shape[:-1], SCALE_INIT, dtype=torch.bfloat16,
                                  device=device),
        }
    dt = _dtype(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def paged_gather_kv(pool_layer: Cache, table: torch.Tensor) -> Cache:
    """ONE layer's dense K/V view through block tables: pool_layer
    [NB, Hkv, block, (Dh)], table [B, nb] -> [B, Hkv, nb*block, (Dh)]."""
    out = {}
    for key, arr in pool_layer.items():
        g = arr[table.long()].movedim(1, 2)  # [B, Hkv, nb, block, (Dh)]
        s = g.shape
        out[key] = g.reshape(s[0], s[1], s[2] * s[3], *s[4:])
    return out


def paged_prefix_view(pool: Cache, table: torch.Tensor, nb: int) -> Cache:
    """Stacked-layer dense view of the first `nb` table blocks:
    pool [L, NB, Hkv, block, (Dh)] -> {key: [L, B, Hkv, nb*block, (Dh)]}."""
    tb = table[:, :nb].long()
    out = {}
    for key, arr in pool.items():
        g = arr[:, tb].movedim(2, 3)  # [L, B, Hkv, nb, block, (Dh)]
        s = g.shape
        out[key] = g.reshape(s[0], s[1], s[2], s[3] * s[4], *s[5:])
    return out


def _write_block_ids(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Block id of each write's table column ``idx``; columns past the
    table's window route to the trash block 0 (clamping would silently
    corrupt the row's last real block)."""
    nbs = table.shape[1]
    inside = idx < nbs
    col = torch.clamp(idx, max=nbs - 1).long()
    if idx.dim() == 1:
        got = table[torch.arange(table.shape[0], device=table.device), col]
    else:
        got = torch.gather(table, 1, col)
    return torch.where(inside, got, torch.zeros_like(got)).long()


@torch.no_grad()
def paged_scatter_tokens(pool: Cache, writes: Cache, table: torch.Tensor,
                         spos: torch.Tensor) -> Cache:
    """Scatter per-token KV writes through block tables, IN PLACE.

    writes: {key: [L, B, Hkv, S, (Dh)]} landing at absolute positions
    spos [B, S]; table [B, NBs]. Rows whose table entry is 0 and
    positions past the window write the trash block (collisions there
    are harmless). Returns ``pool``."""
    block = pool["k"].shape[3]
    bids = _write_block_ids(table, spos // block)
    offs = (spos % block).long()
    for key in pool:
        pool[key][:, bids, :, offs] = (
            writes[key].movedim((1, 3), (0, 1)).to(pool[key].dtype)
        )
    return pool


def write_decode_kv(pool: Cache, fresh: Cache, table: torch.Tensor,
                    pos: torch.Tensor) -> Cache:
    """One decode step's fresh KV for every layer ({key: [L, B, Hkv,
    (Dh)]}) at (table[pos // block], pos % block), IN PLACE; inactive
    rows and pos at the window's end write the trash block."""
    block = pool["k"].shape[3]
    bid = _write_block_ids(table, pos // block)
    off = (pos % block).long()
    for key in pool:
        pool[key][:, bid, :, off] = fresh[key].transpose(0, 1)
    return pool


def _fresh_kv(k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
              pool_dtype: torch.dtype) -> Cache:
    """One decode step's k/v [B, Hkv, Dh] in pool storage form."""
    if cfg.kv_cache_dtype == "int8":
        kq, ksc = _quantize_kv(k)
        vq, vsc = _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    return {"k": k.to(pool_dtype), "v": v.to(pool_dtype)}


def _run_blocks_decode_paged(params, x, cfg, positions, inv_freq, pos,
                             pool, table, tp=None):
    """Paged decode layer loop: per layer K/V are gathered through the
    block table into the dense head-major view and fed to
    gqa_attention_decode; all layers' fresh k/v land after the loop in
    one write."""
    block = pool["k"].shape[3]
    Smax = table.shape[1] * block
    mask_lt = (torch.arange(Smax, device=x.device)[None, None, :]
               < pos[:, None, None])
    fresh = []
    for layer, bp in enumerate(params.blocks):
        pl = {key: arr[layer] for key, arr in pool.items()}
        h = rms_norm(x, bp.attn_norm, cfg.rms_norm_eps)
        q, k, v = _qkv(h, bp, cfg, positions, inv_freq, tp)
        cl = paged_gather_kv(pl, table)
        attn = gqa_attention_decode(
            q, cl["k"], cl["v"], k, v, mask_lt,
            k_scale=cl.get("k_scale"), v_scale=cl.get("v_scale"), tp=tp,
        )
        x = x + _wo(attn, bp, cfg, tp)
        x, _ = _mlp_res(x, bp, cfg, tp)
        fresh.append(_fresh_kv(k[:, 0], v[:, 0], cfg, pool["k"].dtype))
    stacked = {key: torch.stack([f[key] for f in fresh]) for key in pool}
    return x, write_decode_kv(pool, stacked, table, pos)


@torch.no_grad()
def paged_decode_step(
    params: Transformer,
    token: torch.Tensor,  # [B] int32 current tokens
    pos: torch.Tensor,  # [B] int32 positions to write at
    pool: Cache,  # [L, NB, Hkv, block, (Dh)] global block pool
    table: torch.Tensor,  # [B, Smax // block] int32 block tables
    cfg: ModelConfig,
    tp=None,
) -> Tuple[torch.Tensor, Cache]:
    """One autoregressive step over the paged pool. Returns
    (logits [B, V] f32, the pool updated in place)."""
    x = _embed_rows(params, token)[:, None, :]
    inv_freq = rope_frequencies(cfg, token.device)
    x, pool = _run_blocks_decode_paged(params, x, cfg, pos[:, None],
                                       inv_freq, pos, pool, table, tp)
    return _logits(params, x, cfg)[:, 0], pool
