"""TorchServer — the PyTorch counterpart of ``seldon_tpu/servers/jaxserver.py``.

Loads a named preset with random weights drawn from a seeded
``torch.Generator`` on the serving device. It serves ``generate``
through the ragged :class:`InferenceEngine`, and ``predict`` (per-row
mean next-token NLL of token ids, the JAX server's scoring parity)
through :func:`score_nll`, the teacher-forced ``forward``. The
constructor takes the JAX server's knobs and environment variables
(``RAGGED=1 RAGGED_KERNEL=pallas`` select the kernel leg, as they do
there) plus a ``device`` argument: ``cuda`` unless the caller passes
another device.

``predict`` needs the weights only: it runs whatever the engine knobs
say, where the JAX server builds its engine first. Its attention is the
preset's (``attn_impl="xla"``); as in JAX, no knob sets ``"flash"`` on a
preset, and :func:`score_nll` takes any config.

``weight_dtype="int8"`` (or ``WEIGHT_DTYPE=int8``) quantizes the
weights on the serving device at load (``models/quantize.py``);
``act_dtype="int8"`` (``ACT_DTYPE``) then runs the projections W8A8, as
the JAX server's knobs do.

It is a :class:`SeldonComponent`, so the port's microservice CLI
(``runtime/microservice.py``) serves it over REST, NDJSON streaming and
gRPC on the JAX server's routes and method paths. ``generate_stream``
yields one chunk per token burst, ``health_status`` / ``drain`` drive
readiness, and ``metrics`` returns the JAX server's gauges under the
``torchserver_`` prefix (the SLO histogram included) from the engine's
stats. With ``TRACING=1`` the server and the engine emit the JAX
server's spans, adopting the caller's ``traceparent``.

Not carried yet (ROADMAP.md queue A): checkpoint loading
(``model_uri``, item A12) and the observability ledgers behind the JAX
server's ``/debug/*`` routes and ``_observatory_metrics`` (item A9);
without the hooks those routes answer 404 "unit has no ...".
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Any, Dict, Iterable, List, Optional

import numpy as np
import torch

from seldon_tpu_torch.core import tracing
from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import ModelConfig, get_config
from seldon_tpu_torch.models.quantize import quantize_params
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.runtime.user_model import SeldonComponent
from seldon_tpu_torch.servers.engine import (KIND_HTTP_STATUS, EngineConfig,
                                             InferenceEngine)
from seldon_tpu_torch.servers.tokenizer import ByteTokenizer

logger = logging.getLogger(__name__)


def mean_nll(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """Per-row mean next-token NLL [B] f32 of teacher-forced logits
    [B, S, V]: an f32 ``log_softmax`` of ``logits[:, :-1]`` gathered at
    ``toks[:, 1:]``."""
    lp = torch.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -torch.gather(lp, -1, toks[:, 1:, None].long())[..., 0]
    return nll.mean(dim=-1)


@torch.no_grad()
def score_nll(params: transformer.Transformer, toks: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """Per-row mean next-token NLL [B] f32 of token ids [B, S]: the JAX
    server's ``_score`` (``forward``, then :func:`mean_nll`)."""
    return mean_nll(transformer.forward(params, toks, cfg), toks)


def _env_int(value: int, name: str) -> int:
    """A unit parameter, or the environment variable when it is unset
    (-1 / 0, the JAX server's convention)."""
    if int(value) < 0:
        return int(os.environ.get(name, "0") or 0)
    return int(value)


class TorchServer(SeldonComponent):
    supports_batching = True

    def __init__(
        self,
        model_uri: Optional[str] = None,
        preset: str = "bench-1b",
        max_slots: int = 32,
        max_seq_len: int = 0,
        init_seed: int = 0,
        warmup: int = 0,
        weight_dtype: str = "",
        act_dtype: str = "",
        mesh_sp: int = 0,
        tp: int = 0,
        prefix_cache: int = -1,
        prefix_cache_mb: int = 0,
        chunked_prefill: int = -1,
        prefill_chunk: int = 0,
        dispatch_token_budget: int = 0,
        paged_kv: int = -1,
        kv_block: int = 0,
        kv_pool_mb: int = 0,
        ragged: int = -1,
        ragged_chunk: int = 0,
        ragged_kernel: str = "",
        spec: int = -1,
        spec_k: int = 0,
        spec_draft: str = "",
        max_queue: int = 0,
        default_deadline_ms: int = 0,
        device: DeviceLike = None,
    ):
        env = os.environ.get
        self.model_uri = model_uri
        self.preset = preset
        self.max_slots = int(max_slots)
        self.max_seq_len = int(max_seq_len)
        self.init_seed = int(init_seed)
        self.warmup = int(warmup)
        self.mesh_sp = int(mesh_sp)
        self.tp = int(tp or env("TP", "0") or 0)
        self.weight_dtype = weight_dtype or env("WEIGHT_DTYPE", "")
        self.act_dtype = act_dtype or env("ACT_DTYPE", "")
        self.prefix_cache = bool(_env_int(prefix_cache, "PREFIX_CACHE"))
        self.prefix_cache_mb = int(
            prefix_cache_mb or env("PREFIX_CACHE_MB", "0") or 0)
        self.chunked_prefill = bool(
            _env_int(chunked_prefill, "CHUNKED_PREFILL"))
        self.prefill_chunk = int(
            prefill_chunk or env("PREFILL_CHUNK", "0") or 0)
        self.dispatch_token_budget = int(
            dispatch_token_budget or env("DISPATCH_TOKEN_BUDGET", "0") or 0)
        self.paged_kv = bool(_env_int(paged_kv, "PAGED_KV"))
        self.kv_block = int(kv_block or env("KV_BLOCK", "0") or 0)
        self.kv_pool_mb = int(kv_pool_mb or env("KV_POOL_MB", "0") or 0)
        # RAGGED=1 alone is a complete switch: it implies paged KV and
        # chunked prefill.
        self.ragged = bool(_env_int(ragged, "RAGGED"))
        self.ragged_chunk = int(ragged_chunk or env("RAGGED_CHUNK", "0") or 0)
        self.ragged_kernel = (ragged_kernel or env("RAGGED_KERNEL", "")
                              or "masked")
        if self.ragged:
            self.paged_kv = True
            self.chunked_prefill = True
        self.spec = bool(_env_int(spec, "SPEC"))
        self.spec_k = int(spec_k or env("SPEC_K", "0") or 0)
        self.spec_draft = spec_draft or env("SPEC_DRAFT", "")
        if self.spec:
            self.paged_kv = True
        self.max_queue = int(max_queue or env("MAX_QUEUE", "0") or 0)
        self.default_deadline_ms = int(
            default_deadline_ms or env("DEFAULT_DEADLINE_MS", "0") or 0)
        self.device = resolve_device(device)
        self._loaded = False
        self._load_lock = threading.Lock()
        self.engine: Optional[InferenceEngine] = None
        self.cfg: Optional[ModelConfig] = None
        self.params: Optional[transformer.Transformer] = None
        self.tokenizer = ByteTokenizer()
        self._tracer = tracing.get_tracer("torchserver")

    # --- lifecycle ----------------------------------------------------------

    def _engine_config(self, cfg: ModelConfig) -> EngineConfig:
        seq = self.max_seq_len or cfg.max_seq_len
        buckets = tuple(
            b for b in (32, 128, 512, 1024, 2048, 4096) if b <= seq
        ) or (seq,)
        ekw: Dict[str, Any] = {}
        if self.prefix_cache:
            ekw["prefix_cache"] = True
            if self.prefix_cache_mb:
                ekw["prefix_cache_bytes"] = self.prefix_cache_mb << 20
        if self.chunked_prefill:
            ekw["chunked_prefill"] = True
            if self.prefill_chunk:
                ekw["prefill_chunk"] = self.prefill_chunk
            if self.dispatch_token_budget:
                ekw["dispatch_token_budget"] = self.dispatch_token_budget
        if self.paged_kv:
            ekw["paged_kv"] = True
            kb = self.kv_block or EngineConfig.kv_block
            ekw["kv_block"] = kb
            buckets = tuple(b for b in buckets if b % kb == 0) or (seq,)
            if self.kv_pool_mb:
                # blocks = pool bytes / (bytes of one block of all layers'
                # K and V); int8 adds one bf16 scale per (head, token).
                int8 = cfg.kv_cache_dtype == "int8"
                per_tok = 2 * cfg.n_layers * cfg.n_kv_heads * (
                    cfg.head_dim * (1 if int8 else 2) + (2 if int8 else 0))
                blocks = (self.kv_pool_mb << 20) // (per_tok * kb)
                ekw["kv_pool_blocks"] = max(2, int(blocks))
        if self.ragged:
            ekw["ragged"] = True
            if self.ragged_chunk:
                ekw["ragged_chunk"] = self.ragged_chunk
        if self.ragged_kernel != "masked":
            ekw["ragged_kernel"] = self.ragged_kernel
        if self.spec:
            ekw["spec_decode"] = True
            if self.spec_k:
                ekw["spec_k"] = self.spec_k
            if self.spec_draft:
                ekw["spec_draft"] = self.spec_draft
        if self.max_queue:
            ekw["max_queue"] = self.max_queue
        if self.default_deadline_ms:
            ekw["default_deadline_ms"] = self.default_deadline_ms
        if self.tp > 1:
            ekw["tp"] = self.tp
        return EngineConfig(max_slots=self.max_slots, max_seq_len=seq,
                            prompt_buckets=buckets, **ekw)

    def _load_model(self) -> None:
        """The config and the seeded weights, once (caller holds
        ``_load_lock``)."""
        if self.params is not None:
            return
        if self.model_uri:
            raise NotImplementedError(
                "checkpoint loading (model_uri) is not ported to "
                "seldon_tpu_torch yet (ROADMAP.md queue A, item A12)")
        if self.mesh_sp > 1:
            raise NotImplementedError(
                "mesh_sp (ring attention) is not ported to "
                "seldon_tpu_torch yet (ROADMAP.md queue A, item A11)")
        cfg = get_config(self.preset)
        if cfg.vocab_size >= ByteTokenizer.vocab_size:
            cfg = get_config(
                cfg,
                eos_token_id=self.tokenizer.eos_token_id,
                pad_token_id=self.tokenizer.pad_token_id,
            )
        if self.weight_dtype:
            cfg = dataclasses.replace(cfg, weight_dtype=self.weight_dtype)
        if self.act_dtype and cfg.weight_dtype == "int8":
            cfg = dataclasses.replace(cfg, act_dtype=self.act_dtype)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.init_seed)
        params = transformer.init_params(cfg, gen, self.device)
        if cfg.weight_dtype == "int8":
            params = quantize_params(params)
        self.params = params
        self.cfg = cfg

    def load(self) -> None:
        with self._load_lock:
            if self._loaded:
                return
            self._load_model()
            ecfg = self._engine_config(self.cfg)
            self.engine = InferenceEngine(self.params, self.cfg, ecfg,
                                          self.device)
            if self.warmup:
                self.engine.warmup()
            self.engine.start()
            self._loaded = True
            logger.info("TorchServer loaded: preset=%s device=%s slots=%d "
                        "seq=%d kernel=%s", self.preset, self.device,
                        self.max_slots, ecfg.max_seq_len, self.ragged_kernel)

    def _ensure_loaded(self):
        if not self._loaded:
            self.load()

    def stop(self) -> None:
        """Stop the engine (every unfinished request gets a retriable
        shutdown error)."""
        if self.engine is not None:
            self.engine.stop()

    def health_status(self):
        """Readiness probe: never blocks on (or triggers) load — not
        loaded IS not ready — and raises from the moment drain starts, so
        load balancers stop routing here while in-flight work finishes."""
        if not self._loaded:
            raise RuntimeError("model loading")
        if self.engine.draining:
            raise RuntimeError("engine draining")
        return {"engine": self.engine.stats.snapshot()}

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, shed the queue (retriable errors), wait for
        in-flight requests; readiness goes 503 at once. True once the
        engine is quiescent."""
        if not self._loaded or self.engine is None:
            return True
        return self.engine.drain(timeout=timeout)

    def init_metadata(self) -> Dict:
        self._ensure_loaded()
        return {
            "name": "torchserver",
            "config": dataclasses.asdict(self.cfg),
            "device": str(self.device),
        }

    # --- text generation ----------------------------------------------------

    def _to_sampling(self, request: Dict) -> SamplingParams:
        # Explicit falsy values are honored (temperature 0.0 = greedy);
        # only absent/None keys fall back to defaults.
        def get(key, default):
            v = request.get(key)
            return default if v is None else v

        # An explicit traceparent (stamped by the transport edge from the
        # HTTP header / gRPC metadata) wins; otherwise the span open on
        # this thread of control is adopted, so the engine's lifecycle
        # spans join the caller's trace.
        tp = str(get("traceparent", "") or "")
        if not tp:
            cur = tracing.current_span()
            if cur is not None:
                tp = cur.context.to_traceparent()
        return SamplingParams(
            temperature=float(get("temperature", 0.7)),
            top_k=int(get("top_k", 0)),
            top_p=float(get("top_p", 1.0)),
            max_new_tokens=int(get("max_new_tokens", 16) or 16),
            seed=int(get("seed", 0)),
            deadline_ms=int(get("deadline_ms", 0) or 0),
            traceparent=tp,
        )

    def _prompt_ids(self, request: Dict) -> List[int]:
        ids = list(request.get("prompt_token_ids") or [])
        if not ids and request.get("prompt"):
            ids = self.tokenizer.encode(request["prompt"])
        if not ids:
            raise ValueError("generate request has no prompt")
        return ids

    def generate(self, request: Dict) -> Dict:
        self._ensure_loaded()
        t0 = time.perf_counter()
        ids = self._prompt_ids(request)
        with self._tracer.span(
            "torchserver.generate", attributes={"prompt_tokens": len(ids)}
        ) as span:
            result = self.engine.generate_blocking(
                ids, self._to_sampling(request))
            toks = result["token_ids"]
            if toks and toks[-1] == self.cfg.eos_token_id:
                toks = toks[:-1]
            span.set_attribute("prefill_ms", result["ttft_ms"] or 0.0)
            span.set_attribute("completion_tokens", len(toks))
        return {
            "text": self.tokenizer.decode(toks),
            "token_ids": toks,
            "ttft_ms": result["ttft_ms"] or 0.0,
            "total_ms": 1000.0 * (time.perf_counter() - t0),
            "prompt_tokens": len(ids),
            "completion_tokens": len(toks),
        }

    def generate_stream(self, request: Dict):
        """Yield one chunk dict per token burst (EOS stripped), with a
        ``None`` heartbeat every 0.1 s while no tokens arrive. A failed
        request raises with ``kind`` / ``retriable`` / ``http_status``;
        closing the generator early cancels the engine request."""
        self._ensure_loaded()
        t0 = time.perf_counter()
        ids = self._prompt_ids(request)
        # Covers the enqueue only; the engine's lifecycle spans join the
        # same trace through _to_sampling's adoption.
        with self._tracer.span("torchserver.generate_stream",
                               attributes={"prompt_tokens": len(ids)}):
            out_q = self.engine.submit(ids, self._to_sampling(request))
        n = 0
        done = False
        try:
            while True:
                try:
                    item = out_q.get(timeout=0.1)
                except queue.Empty:
                    # A poll point for the transport, so a vanished
                    # client is noticed between token bursts.
                    yield None
                    continue
                if item is None:
                    done = True
                    break
                if "error" in item:
                    done = True
                    err = RuntimeError(f"generation failed: {item['error']}")
                    err.kind = item.get("kind", "internal")
                    err.retriable = bool(item.get("retriable", False))
                    err.http_status = KIND_HTTP_STATUS.get(err.kind, 500)
                    raise err
                toks = [t for t in item["tokens"]
                        if t != self.cfg.eos_token_id]
                if not toks:
                    continue
                n += len(toks)
                yield {
                    "text": self.tokenizer.decode(toks),
                    "token_ids": toks,
                    "ttft_ms": item.get("ttft_ms", 0.0),
                    "total_ms": 1000.0 * (time.perf_counter() - t0),
                    "prompt_tokens": len(ids),
                    "completion_tokens": n,
                }
        finally:
            if not done:
                # Closed mid-stream (client gone): stop decoding for it.
                self.engine.cancel(out_q.rid)

    # --- scoring (MODEL predict parity) -------------------------------------

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None) -> np.ndarray:
        """Token ids [B, S] (or [S]) -> per-row mean next-token NLL [B]
        (lower = the model finds the sequence more likely)."""
        with self._load_lock:
            self._load_model()
        toks = torch.as_tensor(np.asarray(X, dtype=np.int32),
                               device=self.device)
        if toks.ndim == 1:
            toks = toks[None]
        return score_nll(self.params, toks, self.cfg).cpu().numpy()

    # --- observability ------------------------------------------------------

    def _slo_metrics(self, s: Dict) -> List[Dict]:
        """SLO attainment as a Prometheus histogram: cumulative
        ``_bucket{le=...}`` series (+Inf included) plus ``_count`` /
        ``_sum``, and the goodput counters, all from the stats snapshot."""
        out: List[Dict] = []
        cum = 0
        edges = s["deadline_margin_edges_ms"]
        for edge, c in zip(list(edges) + ["+Inf"],
                           s["deadline_margin_counts"]):
            cum += c
            out.append({"type": "GAUGE",
                        "key": "torchserver_deadline_margin_ms_bucket",
                        "value": float(cum), "tags": {"le": str(edge)}})
        out.append({"type": "GAUGE",
                    "key": "torchserver_deadline_margin_ms_count",
                    "value": float(cum)})
        for key, field in (
                ("deadline_margin_ms_sum", "deadline_margin_sum_ms"),
                ("deadline_met_total", "deadline_met_total"),
                ("deadline_missed_total", "deadline_missed_total"),
                ("completed_no_deadline_total",
                 "completed_no_deadline_total"),
                ("goodput", "goodput")):
            out.append({"type": "GAUGE", "key": f"torchserver_{key}",
                        "value": float(s[field])})
        return out

    # The JAX server's gauges, in its order (jaxserver.metrics), each read
    # from the stats snapshot; slots_busy comes from the engine.
    _GAUGES = (
        "mean_ttft_ms", "tokens_out", "completed", "slots_busy",
        "decode_dispatches", "decode_steps", "prefix_hits",
        "prefix_tokens_saved", "prefix_evictions", "queue_depth",
        "mean_queue_wait_ms", "itl_p50_ms", "itl_p95_ms", "itl_p99_ms",
        "prefill_chunks", "prefill_chunk_tokens", "budget_utilization",
        "pool_blocks_used", "pool_blocks_free", "pool_blocks_shared",
        "zero_copy_admissions", "cow_copies", "pool_stalls", "preemptions",
        "shed_total", "cancelled_total", "deadline_expired_total",
        "queue_rejects",
    )

    def metrics(self) -> List[Dict]:
        if not self._loaded:
            return []
        s = dict(self.engine.stats.snapshot(),
                 slots_busy=self.engine.slots_busy())
        return self._slo_metrics(s) + [
            {"type": "GAUGE", "key": f"torchserver_{k}",
             "value": float(s[k])} for k in self._GAUGES]

    def tags(self) -> Dict:
        return {"server": "torchserver", "preset": self.preset}
