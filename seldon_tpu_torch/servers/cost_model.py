"""graftroof: analytical cost model + MFU/MBU roofline ledger — port of
``seldon_tpu/servers/cost_model.py``. The formulas are the JAX module's,
bit for bit; the peak table is the card's.

The dispatch lattice's static keys ARE shapes (``shape_lattice.FAMILIES``
— ("admit", 64, 4) is 4 rows of 64 prefill tokens, ("decode", 8) is 8
steps over every slot), so the FLOPs and HBM bytes of every variant the
engine can dispatch are closed-form host arithmetic over the model
config. This module prices them:

 * :func:`cost_of_key` — (flops, bytes) for ONE dispatch of any lattice
   key, parameterized by the model config (layers/heads/dims/dtype
   widths) and the engine geometry (slots, cache window, paged block,
   ragged chunk). Formula conventions are documented per family below;
   two deliberate ones up front: a dispatch reads the full weight
   working set once (batched rows amortize it — the serving regime the
   engine exists for), and the ragged wave is priced at its CAPACITY
   ``max_slots * ragged_chunk`` (the static shape), so a lightly packed
   wave reads as low MFU — the roofline's view of the same waste the
   sched ledger attributes token-by-token.
 * :func:`predict` — the per-request cost surface
   ``predict(prompt_len, max_new, config) -> {flops, bytes, est_ms}``:
   prefill plus every decode step at its growing context, weight reads
   amortized over the slot count. This is the marginal-cost signal
   Nitsum-style tier routing consumes (one request's resource-seconds),
   and ``1000 / est_ms`` is its implied saturated req/s.
 * :class:`RoofLedger` (``ROOF_LEDGER=1``; ``from_env`` -> None — and
   zero hot-path cost — otherwise): joins the priced keys with the
   measured per-variant dispatch timing (ROOF_LEDGER implies
   DISPATCH_TIMING) into achieved FLOP/s and bytes/s per variant
   against a per-platform peak table, classifying each variant
   compute-bound / bandwidth-bound / host-bound, and decomposes every
   scheduler boundary into host-pre / device / host-post / overlap wall
   time with a sched-ledger-style conservation audit (components must
   re-sum to the measured boundary span within 1%).

Peak provenance (``snapshot()["peaks"]["source"]``):

 * ``env`` — ``ROOF_PEAK_TFLOPS`` / ``ROOF_PEAK_GBS`` set by the
   operator (either may individually override the table);
 * ``table`` — the builtin entry matched against the card's name
   (``torch.cuda.get_device_name()``), longest fragment first: dense
   bf16 TFLOPS and HBM GB/s from NVIDIA's H100 datasheet. W8A8's int8
   tensor-core rate is 2x this bf16 basis on the H100 too, so an
   int8-serving MFU of ~0.5 is the practical ceiling;
 * ``microbench`` — any other platform (the CPU, an unlisted card): a
   one-shot calibration on the engine's own device (a matmul for FLOP/s
   and a copy for bytes/s with torch, cached per device), run at
   ``bind()`` time (engine init — cold path, never under ``_book``).

Pure stdlib at import — torch is imported only inside the microbench.

Single-writer discipline (the sched-ledger idiom): every ``note_*`` /
``audit`` mutator runs on the scheduler thread (or the fetcher) under
``_book``; ``snapshot()`` reads GIL-atomic fields from any thread and
may observe a torn WINDOW but never a torn record.

``snapshot()`` — the documented /debug/roof schema, the JAX module's
key for key:

    {
      "enabled": True,
      "platform": str,              # device name the peaks matched
      "peaks": {"tflops": float, "gbs": float, "source": str},
      "tp": int,                    # TP group size costs divide over
                                    #   (1 = single chip; peaks stay
                                    #   per-chip either way — graftmesh)
      "boundaries": int,            # dispatched boundaries decomposed
      "waves": int,                 # note_wave joins (keys x timing)
      "step": {                     # cumulative decomposition, ms
        "wall_ms": float,           #   measured boundary span
        "host_pre_ms": float,       #   scheduling under _book, ledger
        "device_ms": float,         #   dispatch (the port: eager launch
                                    #   of the wave's kernels on the
                                    #   host) + the boundary's wait
        "host_post_ms": float,      #   post-fetch bookkeeping
        "overlap_ms": float,        #   pipelined gap (other boundaries'
      },                            #   host work ran here)
      "host_frac": float,           # (pre + post) / wall
      "device_frac": float,         # device / wall
      "conservation": {"checked": int, "breaches": int,
                       "last_breach": str | None},
      "variants": [                 # per dispatch-key roofline, sorted
        {"key": str,                #   compile-ledger spelling
         "family": str,             #   first key segment
         "dispatches": int,
         "flops": float, "bytes": float,
         "device_ms": float,        #   wave device time, est-weighted
         "predicted_ms": float,     #   roofline est at the peak table
         "mfu": float, "mbu": float,  # achieved/peak, clamped to 1.0
         "bound": str}              #   compute | bandwidth | host
      ],
      "totals": {"dispatches": int, "flops": float, "bytes": float,
                 "device_ms": float, "predicted_ms": float,
                 "mfu": float, "mbu": float},
    }
"""

from __future__ import annotations

import logging
import os
from typing import Any, Dict, List, Optional, Tuple

from seldon_tpu_torch.servers.compile_ledger import key_str
from seldon_tpu_torch.servers.shape_lattice import FAMILIES

logger = logging.getLogger(__name__)

Key = Tuple[Any, ...]

# Matmul/embedding dtype widths (cfg.weight_dtype / kv_cache_dtype
# spellings plus the cfg.dtype long form).
_DTYPE_BYTES = {"bf16": 2, "bfloat16": 2, "int8": 1, "fp32": 4,
                "float32": 4}

# Published per-card peaks (NVIDIA H100 datasheet): lower-case device
# name fragment -> (dense bf16 TFLOPS, HBM GB/s). Matched longest
# fragment first, so "h100 nvl" and "h100 pcie" never fall through to
# the bare "h100" (SXM) entry. The bf16 basis is deliberate: one stable
# denominator per card (W8A8 doubles the tensor-core rate, so int8 runs
# top out near mfu 0.5 against it).
_PEAK_TABLE = (
    ("h100", (989.4, 3350.0)),
    ("h100 nvl", (835.0, 3900.0)),
    ("h100 pcie", (756.0, 2000.0)),
)

# Per-variant table cap: past it, new keys fold into one overflow row
# (the sched ledger's _MAX_SHAPES idiom) so the payload stays bounded.
_MAX_VARIANTS = 128
_OVERFLOW_KEY: Key = ("other",)
# predict() memo cap (prompt_len, max_new) -> est_ms; cleared when full.
_MAX_PREDICT_CACHE = 2048
# Below this fraction of BOTH roofs a variant is not meaningfully using
# the hardware at all — its wall time is host overhead, not the device.
HOST_BOUND_FRAC = 0.1

# One-shot microbench results, per device, shared across ledgers in the
# process.
_MICROBENCH_PEAKS: Dict[str, Tuple[float, float]] = {}


# -- model-config arithmetic (duck-typed on models.config.ModelConfig) ------


def _wbytes(cfg) -> int:
    return _DTYPE_BYTES.get(getattr(cfg, "weight_dtype", "bf16"), 2)


def _kvbytes(cfg) -> int:
    return _DTYPE_BYTES.get(getattr(cfg, "kv_cache_dtype", "bf16"), 2)


def matmul_params_per_layer(cfg, tp: int = 1) -> int:
    """Matmul weights one token multiplies through PER CHIP per layer:
    fused qkv + o projections and the SwiGLU triple (per-token active
    experts under MoE — the router's d*E is noise and ignored).

    graftmesh (tp > 1) prices the exact-TP split (models/tp_sharding):
    qkv and gate/up shard their output dim over tp chips, while o and
    down — whose contraction would need a psum — stay replicated and
    run redundantly everywhere. MoE expert weights replicate entirely
    (attention-only sharding), so only the qkv term divides."""
    hd = cfg.d_model // cfg.n_heads
    qkv = cfg.d_model * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd)
    o = cfg.d_model * cfg.d_model
    if getattr(cfg, "n_experts", 0):
        mlp = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts_per_token
    else:
        mlp = (2 * cfg.d_model * cfg.d_ff) // tp + cfg.d_model * cfg.d_ff
    return qkv // tp + o + mlp


def flops_per_token(cfg, tp: int = 1) -> int:
    """Dense forward FLOPs per token PER CHIP, EXCLUDING attention-over-
    context (that term depends on the key's window — see attn_flops): 2
    flops per resident matmul parameter, lm_head included (replicated —
    every chip computes full logits, the exactness contract)."""
    return 2 * (cfg.n_layers * matmul_params_per_layer(cfg, tp)
                + cfg.d_model * cfg.vocab_size)


def attn_flops(cfg, q_tokens: int, kv_len: int, tp: int = 1) -> int:
    """Attention-over-context FLOPs PER CHIP: q_tokens query positions
    each scoring + mixing kv_len cached positions across every layer —
    QK^T and PV are 2 flops per (head, dim, position) each, and GQA
    shares K/V without shrinking the query side: 4 * d_model * q * kv
    per layer. Heads shard on 'tp', so per-chip attention divides."""
    return 4 * cfg.d_model * q_tokens * kv_len * cfg.n_layers // tp


def causal_attn_flops(cfg, s_tokens: int, prior: int = 0,
                      tp: int = 1) -> int:
    """Prefill attention PER CHIP: token i of a fresh s-token segment
    attends prior + i + 1 positions — the arithmetic-series sum of
    attn_flops."""
    total_kv = s_tokens * prior + s_tokens * (s_tokens + 1) // 2
    return 4 * cfg.d_model * total_kv * cfg.n_layers // tp


def weight_bytes(cfg, tp: int = 1) -> int:
    """HBM bytes of one full weight read PER CHIP: matmul weights at
    the serving weight dtype (ALL experts under MoE — a batched wave
    touches the lot), embeddings + lm_head at bf16 (they stay
    unquantized, models/quantize.py). The exact-TP split shards only
    qkv + gate/up; o / down / embeddings / lm_head are read whole on
    every chip."""
    hd = cfg.d_model // cfg.n_heads
    qkv = cfg.d_model * (cfg.n_heads * hd + 2 * cfg.n_kv_heads * hd)
    o = cfg.d_model * cfg.d_model
    if getattr(cfg, "n_experts", 0):
        mlp = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts
    else:
        mlp = (2 * cfg.d_model * cfg.d_ff) // tp + cfg.d_model * cfg.d_ff
    per_layer = qkv // tp + o + mlp
    emb = cfg.vocab_size * cfg.d_model * 2          # bf16 embedding
    head = cfg.d_model * cfg.vocab_size * 2         # bf16 lm_head
    return cfg.n_layers * per_layer * _wbytes(cfg) + emb + head


def kv_bytes_per_token(cfg, tp: int = 1) -> int:
    """KV-cache bytes one token position occupies across every layer
    PER CHIP: K + V at the kv dtype, GQA heads only — the cache shards
    exactly on its head axis, so tp divides cleanly."""
    hd = cfg.d_model // cfg.n_heads
    return 2 * cfg.n_layers * cfg.n_kv_heads * hd * _kvbytes(cfg) // tp


# -- per-key closed forms ---------------------------------------------------


def cost_of_key(key: Key, cfg, *, max_slots: int, max_seq_len: int,
                kv_block: int = 0, ragged_chunk: int = 0,
                draft_cfg=None, tp: int = 1) -> Tuple[float, float]:
    """(flops, hbm_bytes) for ONE dispatch of a lattice key, PER CHIP
    under tp > 1 (graftmesh: the helpers above shard exactly — per-chip
    flops against the per-chip peak is the honest MFU). Covers every
    family in shape_lattice.FAMILIES; raises ValueError on an unknown tag so
    a new dispatch family cannot silently price as zero.

    Window convention: decode-side attention reads the full cache
    window (dense kernels scan max_seq_len every step; paged tables
    are priced at the same bound) — the serving-shape upper bound the
    engine actually dispatches, not the request's live length."""
    fam = key[0]
    B, W = max_slots, max_seq_len
    tp = max(1, int(tp))
    fpt = flops_per_token(cfg, tp)
    kvpt = kv_bytes_per_token(cfg, tp)
    wb = weight_bytes(cfg, tp)
    if fam == "deactivate":
        # One masked write over the per-slot scalars — no matmuls.
        return 0.0, float(B * 64)
    if fam == "cow":
        # One shared block copied read+write across every layer.
        return 0.0, float(2 * kv_block * kvpt)
    if fam == "seed-prefix":
        # (tag, W): trie KV copied into the slot slab, read + write.
        return 0.0, float(2 * key[1] * kvpt)
    if fam == "admit":
        # (tag, Sb, G): G rows prefill Sb tokens, causal attention.
        sb, g = key[1], key[2]
        flops = g * (sb * fpt + causal_attn_flops(cfg, sb, tp=tp))
        return float(flops), float(wb + g * sb * kvpt)
    if fam == "admit-prefix":
        # (tag, Pb, Sb, G): suffix Sb computed over a Pb-token prefix
        # already resident in the cache.
        pb, sb, g = key[1], key[2], key[3]
        flops = g * (sb * fpt + causal_attn_flops(cfg, sb, prior=pb, tp=tp))
        return float(flops), float(wb + g * (pb + sb) * kvpt)
    if fam == "admit-paged":
        # (tag, Sb, G, W): paged admission, prefix width W resident.
        sb, g, pw = key[1], key[2], key[3]
        flops = g * (sb * fpt + causal_attn_flops(cfg, sb, prior=pw, tp=tp))
        return float(flops), float(wb + g * (pw + sb) * kvpt)
    if fam == "chunk":
        # (tag, Sc, G, W): G rows advance Sc prefill tokens against a
        # W-token resident view.
        sc, g, rw = key[1], key[2], key[3]
        flops = g * (sc * fpt + causal_attn_flops(cfg, sc, prior=rw, tp=tp))
        return float(flops), float(wb + g * (rw + sc) * kvpt)
    if fam == "decode":
        # (tag, n): n sequential steps over every slot; every step
        # re-reads the weights and the full cache window.
        n = key[1]
        flops = n * B * (fpt + attn_flops(cfg, 1, W, tp=tp) // 1)
        bytes_ = n * (wb + B * W * kvpt + B * kvpt)
        return float(flops), float(bytes_)
    if fam == "ragged":
        # (tag, C): ONE fused wave priced at its static capacity
        # max_slots * C. Since graftkern this is the CAPACITY figure
        # (exported as capacity_* in /debug/roof): the ledger prices
        # the live fields from per-wave descriptor occupancy
        # (ragged_occupancy_cost via note_ragged_occupancy) when the
        # engine feeds it, falling back to this bound otherwise.
        c = key[1] or ragged_chunk
        t = B * c
        flops = t * fpt + attn_flops(cfg, t, W, tp=tp)
        return float(flops), float(wb + B * W * kvpt + t * kvpt)
    if fam == "verify":
        # (tag, k): every armed row scores k + 1 positions in one wave.
        k = key[1]
        q = k + 1
        flops = B * (q * fpt + attn_flops(cfg, q, W, tp=tp))
        return float(flops), float(wb + B * (W * kvpt + q * kvpt))
    if fam == "draft":
        # (tag, k): the resident draft model's k proposal steps (the
        # host n-gram drafter dispatches nothing and prices zero).
        # The draft replicates across the TP group (tp_sharding shards
        # the target only), so its per-chip cost is the full tp=1 cost.
        if draft_cfg is None:
            return 0.0, 0.0
        return cost_of_key(("decode", key[1]), draft_cfg,
                           max_slots=max_slots,
                           max_seq_len=min(max_seq_len,
                                           draft_cfg.max_seq_len))
    raise ValueError(f"unknown dispatch family {fam!r} (key {key!r})")


def ragged_occupancy_cost(cfg, *, q_tokens: int, kv_read_tokens: int,
                          attn_qk: int, tp: int = 1) -> Tuple[float, float]:
    """(flops, hbm_bytes) of ONE ragged wave priced at its LIVE
    descriptor occupancy (graftkern): ``q_tokens`` query positions
    actually packed (prefill segments + decode rows), ``attn_qk`` the
    summed q*kv attention pairs those rows really score, and
    ``kv_read_tokens`` the pool positions the block-sparse walk
    gathers. This is what the sparse/pallas kernels — and, masked's
    -1e30 columns aside, the useful arithmetic of every leg — actually
    do, so MFU/MBU stop reading capacity padding as waste. The static
    ``cost_of_key`` "ragged" formula stays exported as the capacity_*
    fields (/debug/roof shows both)."""
    tp = max(1, int(tp))
    flops = q_tokens * flops_per_token(cfg, tp) \
        + 4 * cfg.d_model * attn_qk * cfg.n_layers // tp
    kvpt = kv_bytes_per_token(cfg, tp)
    bytes_ = weight_bytes(cfg, tp) + kv_read_tokens * kvpt \
        + q_tokens * kvpt
    return float(flops), float(bytes_)


# -- peaks ------------------------------------------------------------------


def _device_microbench(device=None) -> Tuple[float, float]:
    """One-shot achievable-peak calibration for platforms the table
    does not know, on `device` (None: the CPU): a matmul for FLOP/s
    (bf16 on a card, f32 on the CPU) and a tensor copy for bytes/s,
    cached per device. Cold path only — called from bind() /
    resolve_peaks, never under _book; it waits for the device, which is
    why the engine calls it before serving."""
    import time as _time

    import torch

    dev = torch.device(device if device is not None else "cpu")
    cached = _MICROBENCH_PEAKS.get(str(dev))
    if cached is not None:
        return cached
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    n, reps = (4096, 20) if cuda else (192, 8)
    dtype = torch.bfloat16 if cuda else torch.float32
    a = torch.ones((n, n), dtype=dtype, device=dev)
    b = torch.ones((n, n), dtype=dtype, device=dev)
    a @ b  # warm the GEMM path
    sync()
    t0 = _time.perf_counter()
    for _ in range(reps):
        a @ b
    sync()
    dt = max(_time.perf_counter() - t0, 1e-9)
    tflops = (2.0 * n ** 3 * reps) / dt / 1e12
    src = torch.ones((256 << 20) if cuda else (4 << 20,), dtype=torch.uint8,
                     device=dev)
    dst = torch.empty_like(src)
    dst.copy_(src)  # fault the pages
    sync()
    t0 = _time.perf_counter()
    for _ in range(4):
        dst.copy_(src)
    sync()
    dt = max(_time.perf_counter() - t0, 1e-9)
    gbs = (2.0 * src.numel() * 4) / dt / 1e9
    _MICROBENCH_PEAKS[str(dev)] = (max(tflops, 1e-4), max(gbs, 1e-3))
    return _MICROBENCH_PEAKS[str(dev)]


def match_peaks(platform: str) -> Optional[Tuple[float, float]]:
    """The table's (TFLOPS, GB/s) for a device name, longest matching
    fragment first; None when no entry matches."""
    plat = (platform or "").lower()
    for frag, peaks in sorted(_PEAK_TABLE, key=lambda e: -len(e[0])):
        if frag in plat:
            return peaks
    return None


def resolve_peaks(platform: str = "", device=None) -> Dict[str, Any]:
    """{"tflops", "gbs", "source"} for a platform hint (the card's name).
    Resolution order: ROOF_PEAK_TFLOPS / ROOF_PEAK_GBS env (each may
    override individually; a value that is not a float raises) > the
    builtin table > the one-shot microbench on `device`."""
    source = "table"
    peaks = match_peaks(platform)
    if peaks is None:
        peaks = _device_microbench(device)
        source = "microbench"
    tflops, gbs = peaks
    env_tf = os.environ.get("ROOF_PEAK_TFLOPS", "")
    env_gb = os.environ.get("ROOF_PEAK_GBS", "")
    if env_tf:
        tflops, source = float(env_tf), "env"
    if env_gb:
        gbs, source = float(env_gb), "env"
    return {"tflops": float(tflops), "gbs": float(gbs), "source": source}


def roofline_ms(flops: float, bytes_: float, peaks: Dict[str, Any]) -> float:
    """Roofline time estimate: the binding resource's service time."""
    return 1000.0 * max(flops / (peaks["tflops"] * 1e12),
                        bytes_ / (peaks["gbs"] * 1e9))


def predict(prompt_len: int, max_new: int, config, *,
            max_slots: int = 1, max_seq_len: int = 0,
            peaks: Optional[Dict[str, Any]] = None,
            tp: int = 1) -> Dict[str, float]:
    """Per-request cost surface: prefill `prompt_len` then `max_new`
    decode steps at their true growing context, weight reads amortized
    over `max_slots` concurrent rows (marginal cost at the serving
    batch — the tier-routing signal). est_ms is the roofline service
    time at `peaks` (resolved fresh when not supplied), and
    1000 / est_ms its implied saturated req/s. Under tp > 1 the cost
    is per chip against the (per-chip) peaks — wall time on the mesh,
    since every chip runs the same wave."""
    prompt_len = max(int(prompt_len), 0)
    max_new = max(int(max_new), 0)
    b = max(int(max_slots), 1)
    tp = max(1, int(tp))
    fpt = flops_per_token(config, tp)
    kvpt = kv_bytes_per_token(config, tp)
    wb = weight_bytes(config, tp)
    flops = prompt_len * fpt + causal_attn_flops(config, prompt_len, tp=tp)
    # sum of contexts prompt_len+1 .. prompt_len+max_new
    ctx_sum = max_new * prompt_len + max_new * (max_new + 1) // 2
    flops += max_new * fpt + attn_flops(config, 1, 1, tp=tp) * ctx_sum
    bytes_ = (prompt_len + max_new) * kvpt          # KV writes
    bytes_ += ctx_sum * kvpt                        # decode KV reads
    bytes_ += (1 + max_new) * wb / b                # amortized weights
    if peaks is None:
        peaks = resolve_peaks()
    return {
        "flops": float(flops),
        "bytes": float(bytes_),
        "est_ms": roofline_ms(float(flops), float(bytes_), peaks),
    }


# -- the ledger -------------------------------------------------------------


class RoofLedger:
    """MFU/MBU roofline + host/device step decomposition ledger.

    Mutators run single-writer on the scheduler (or fetcher) thread
    under ``_book``; snapshot() is lock-free and may see a torn window,
    never a torn record (the sched-ledger contract)."""

    def __init__(self):
        self._cfg = None
        self._draft_cfg = None
        self._geom: Dict[str, int] = {
            "max_slots": 1, "max_seq_len": 1, "kv_block": 0,
            "ragged_chunk": 0, "tp": 1,
        }
        self._platform = ""
        self._peaks = resolve_peaks("")
        # key -> [dispatches, flops, bytes, device_ms, predicted_ms,
        #         capacity_flops, capacity_bytes, capacity_predicted_ms]
        # Live (slots 1-4) == capacity (slots 5-7) for every family
        # except "ragged" waves fed live occupancy (graftkern).
        self._variants: Dict[Key, List[float]] = {}
        self._cost_cache: Dict[Key, Tuple[float, float]] = {}
        self._predict_cache: Dict[Tuple[int, int], float] = {}
        self._waves = 0
        # Live ragged-wave occupancy FIFO: the engine notes each
        # dispatched wave's (q_tokens, kv_read_tokens, attn_qk) under
        # _book BEFORE its boundary prices (note_wave consumes oldest-
        # first when it meets a "ragged" key). Empty -> ragged prices
        # at capacity, so occupancy-blind engines are unchanged.
        self._pending_occ: List[Tuple[int, int, int]] = []
        # Step decomposition accumulators (ms).
        self._boundaries = 0
        self._wall_ms = 0.0
        self._host_pre_ms = 0.0
        self._device_ms = 0.0
        self._host_post_ms = 0.0
        self._overlap_ms = 0.0
        # Conservation audit state.
        self._audit_checked = 0
        self._audit_breaches = 0
        self._last_breach: Optional[str] = None

    # -- wiring (engine __init__, cold) --------------------------------------

    def bind(self, cfg, *, max_slots: int, max_seq_len: int,
             kv_block: int = 0, ragged_chunk: int = 0, draft_cfg=None,
             platform: str = "", tp: int = 1, device=None) -> None:
        """Capture the model config + engine geometry and resolve the
        peak table once (the microbench on `device`, when it fires,
        fires HERE — engine init, never the hot path). `tp` is the TP
        group size the engine shards over: costs become per-chip while
        the peaks stay per-chip, so MFU/MBU read honestly on the
        mesh."""
        self._cfg = cfg
        self._draft_cfg = draft_cfg
        self._geom = {
            "max_slots": int(max_slots),
            "max_seq_len": int(max_seq_len),
            "kv_block": int(kv_block),
            "ragged_chunk": int(ragged_chunk),
            "tp": max(1, int(tp)),
        }
        self._platform = platform or ""
        self._peaks = resolve_peaks(self._platform, device)
        self._cost_cache.clear()
        self._predict_cache.clear()

    def _cost(self, key: Key) -> Tuple[float, float]:
        got = self._cost_cache.get(key)
        if got is None:
            # An unknown family raises: the JAX ledger prices it zero,
            # the port reports no price it did not compute.
            got = cost_of_key(key, self._cfg, draft_cfg=self._draft_cfg,
                              **self._geom)
            self._cost_cache[key] = got
        return got

    # -- hot path (scheduler/fetcher thread, under _book) --------------------

    def note_ragged_occupancy(self, q_tokens: int, kv_read_tokens: int,
                              attn_qk: int) -> None:
        """Queue one ragged wave's live descriptor occupancy (graftkern)
        for the boundary that prices it. Called by _dispatch_ragged
        under _book right before the wave call; note_wave pops FIFO when
        it meets the wave's "ragged" key, so the pairing is exact as
        long as every occupancy-noting dispatch reaches note_wave (a
        drained/failed boundary leaves at most one stale entry, bounded
        by the cap here)."""
        if len(self._pending_occ) < 64:
            self._pending_occ.append(
                (int(q_tokens), int(kv_read_tokens), int(attn_qk))
            )

    def note_wave(self, keys: List[Key], device_ms: float) -> None:
        """Join one boundary's dispatch keys with its measured device
        time: the wave's device_ms splits across its keys weighted by
        each key's roofline estimate (equal split when nothing prices),
        so per-variant device time stays conserved across the wave.

        "ragged" keys price their LIVE fields from the engine-fed
        occupancy queue (falling back to the static capacity formula
        when it is empty); every key also accumulates the capacity
        figures, identical to live for every other family."""
        if not keys:
            return
        self._waves += 1
        priced = []
        for key in keys:
            cap_f, cap_b = self._cost(key)
            cap_est = roofline_ms(cap_f, cap_b, self._peaks)
            flops, bytes_, est = cap_f, cap_b, cap_est
            if key[0] == "ragged" and self._pending_occ:
                q, kv, qk = self._pending_occ.pop(0)
                flops, bytes_ = ragged_occupancy_cost(
                    self._cfg, q_tokens=q, kv_read_tokens=kv,
                    attn_qk=qk, tp=self._geom["tp"],
                )
                est = roofline_ms(flops, bytes_, self._peaks)
            priced.append((key, flops, bytes_, est, cap_f, cap_b,
                           cap_est))
        total_est = sum(p[3] for p in priced)
        for key, flops, bytes_, est, cap_f, cap_b, cap_est in priced:
            share = (device_ms * est / total_est if total_est > 0.0
                     else device_ms / len(keys))
            row = self._variants.get(key)
            if row is None and len(self._variants) >= _MAX_VARIANTS:
                key = _OVERFLOW_KEY
                row = self._variants.get(key)
            if row is None:
                row = [0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
                self._variants[key] = row
            row[0] += 1
            row[1] += flops
            row[2] += bytes_
            row[3] += share
            row[4] += est
            row[5] += cap_f
            row[6] += cap_b
            row[7] += cap_est

    def note_step(self, host_pre_ms: float, device_ms: float,
                  host_post_ms: float, span_ms: float) -> None:
        """One dispatched boundary's wall-time decomposition. The span
        is measured independently (step start -> post-processing done);
        overlap is the pipelined gap where THIS boundary sat in flight
        while the scheduler ran other boundaries' host work."""
        self._boundaries += 1
        self._host_pre_ms += max(0.0, host_pre_ms)
        self._device_ms += max(0.0, device_ms)
        self._host_post_ms += max(0.0, host_post_ms)
        self._overlap_ms += max(
            0.0, span_ms - host_pre_ms - device_ms - host_post_ms
        )
        self._wall_ms += max(0.0, span_ms)

    def audit(self) -> None:
        """Conservation check, run under ``_book`` at every boundary
        (the sched ledger's audit slot): the four components must
        re-sum to the measured boundary wall within 1%."""
        self._audit_checked += 1
        parts = (self._host_pre_ms + self._device_ms + self._host_post_ms
                 + self._overlap_ms)
        if abs(parts - self._wall_ms) > max(1.0, 0.01 * self._wall_ms):
            self._breach(
                f"step components {parts:.3f} ms != boundary wall "
                f"{self._wall_ms:.3f} ms (pre {self._host_pre_ms:.3f} + "
                f"device {self._device_ms:.3f} + post "
                f"{self._host_post_ms:.3f} + overlap "
                f"{self._overlap_ms:.3f})"
            )

    def _breach(self, msg: str) -> None:
        self._audit_breaches += 1
        self._last_breach = msg
        logger.warning("roof-ledger conservation breach: %s", msg)

    # -- cost surface --------------------------------------------------------

    def predict_request_ms(self, prompt_len: int, max_new: int) -> float:
        """Memoized per-request roofline estimate at the bound geometry
        — the predicted cost stamped into the sched ledger's wait
        attribution and the pilot's signal snapshot."""
        ck = (int(prompt_len), int(max_new))
        got = self._predict_cache.get(ck)
        if got is None:
            if len(self._predict_cache) >= _MAX_PREDICT_CACHE:
                self._predict_cache.clear()
            got = predict(
                prompt_len, max_new, self._cfg,
                max_slots=self._geom["max_slots"],
                max_seq_len=self._geom["max_seq_len"],
                peaks=self._peaks,
                tp=self._geom["tp"],
            )["est_ms"]
            self._predict_cache[ck] = got
        return got

    # -- readers -------------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        peaks = dict(self._peaks)
        pf = peaks["tflops"] * 1e12
        pb = peaks["gbs"] * 1e9
        variants: List[Dict[str, Any]] = []
        tot_d = 0
        tot_f = tot_b = tot_ms = tot_pred = 0.0
        for k, v in sorted(self._variants.items(),
                           key=lambda kv: key_str(kv[0])):
            disp, flops, bytes_, dms, pred = (
                int(v[0]), v[1], v[2], v[3], v[4]
            )
            cap_f, cap_b, cap_pred = v[5], v[6], v[7]
            secs = dms / 1000.0
            mfu = min(1.0, flops / (secs * pf)) if secs > 0.0 else 0.0
            mbu = min(1.0, bytes_ / (secs * pb)) if secs > 0.0 else 0.0
            if max(mfu, mbu) < HOST_BOUND_FRAC:
                bound = "host"
            elif mfu >= mbu:
                bound = "compute"
            else:
                bound = "bandwidth"
            variants.append({
                "key": key_str(k),
                "family": str(k[0]),
                "dispatches": disp,
                "flops": flops,
                "bytes": bytes_,
                "device_ms": round(dms, 3),
                "predicted_ms": round(pred, 3),
                # Static serving-shape bound (== live for every family
                # except occupancy-fed ragged waves, graftkern).
                "capacity_flops": cap_f,
                "capacity_bytes": cap_b,
                "capacity_predicted_ms": round(cap_pred, 3),
                "mfu": round(mfu, 6),
                "mbu": round(mbu, 6),
                "bound": bound,
            })
            tot_d += disp
            tot_f += flops
            tot_b += bytes_
            tot_ms += dms
            tot_pred += pred
        secs = tot_ms / 1000.0
        wall = self._wall_ms
        return {
            "enabled": True,
            "platform": self._platform,
            "peaks": peaks,
            "tp": self._geom["tp"],
            "boundaries": self._boundaries,
            "waves": self._waves,
            "step": {
                "wall_ms": round(wall, 3),
                "host_pre_ms": round(self._host_pre_ms, 3),
                "device_ms": round(self._device_ms, 3),
                "host_post_ms": round(self._host_post_ms, 3),
                "overlap_ms": round(self._overlap_ms, 3),
            },
            "host_frac": (
                round((self._host_pre_ms + self._host_post_ms) / wall, 6)
                if wall > 0.0 else 0.0
            ),
            "device_frac": (
                round(self._device_ms / wall, 6) if wall > 0.0 else 0.0
            ),
            "conservation": {
                "checked": self._audit_checked,
                "breaches": self._audit_breaches,
                "last_breach": self._last_breach,
            },
            "variants": variants,
            "totals": {
                "dispatches": tot_d,
                "flops": tot_f,
                "bytes": tot_b,
                "device_ms": round(tot_ms, 3),
                "predicted_ms": round(tot_pred, 3),
                "mfu": (round(min(1.0, tot_f / (secs * pf)), 6)
                        if secs > 0.0 else 0.0),
                "mbu": (round(min(1.0, tot_b / (secs * pb)), 6)
                        if secs > 0.0 else 0.0),
            },
        }


def from_env() -> Optional[RoofLedger]:
    """Ledger iff ROOF_LEDGER=1; None otherwise — callers keep a None
    attribute and the raw dispatch path (compile-ledger idiom). The
    engine additionally forces DISPATCH_TIMING on when the roof is up:
    the roofline is the timing join."""
    if os.environ.get("ROOF_LEDGER", "0") not in ("1", "true", "True"):
        return None
    return RoofLedger()


# Every family above must stay priced; a FAMILIES entry this module
# does not handle raises in cost_of_key.
assert set(FAMILIES) == {
    "deactivate", "admit", "admit-prefix", "admit-paged", "chunk",
    "seed-prefix", "cow", "decode", "ragged", "draft", "verify",
}, "shape_lattice.FAMILIES drifted — update cost_of_key"
