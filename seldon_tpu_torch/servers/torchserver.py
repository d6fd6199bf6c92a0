"""TorchServer — the PyTorch counterpart of ``seldon_tpu/servers/jaxserver.py``.

Loads a named preset with random weights drawn from a seeded
``torch.Generator`` on the serving device, or, given ``model_uri``, an HF
Llama-family checkpoint (config.json + *.safetensors) or else an orbax
checkpoint directory (config.json + ``params/``, as the JAX package's
``save_checkpoint`` writes it): the URI is fetched to a local directory
(``servers/storage.py``), its tokenizer loaded when it ships one
(``servers/tokenizer.py``) and its weights read onto the serving device
(``servers/hf_loader.py``, ``servers/checkpoint.py``). It serves ``generate``
through the :class:`InferenceEngine` the knobs select, and ``predict``
(per-row mean next-token NLL of token ids, the JAX server's scoring
parity) through :func:`score_nll`, the teacher-forced ``forward``. The
constructor takes the JAX server's knobs and environment variables plus
a ``device`` argument: ``cuda`` unless the caller passes another device.
With no knob set the engine is the JAX server's default, the dense slab;
``PAGED_KV=1`` pages it, ``CHUNKED_PREFILL=1`` chunks its prefills,
``RAGGED=1 RAGGED_KERNEL=pallas`` select the ragged wave on the kernel
leg, and ``SPEC=1`` turns on speculative decoding (it implies
``PAGED_KV=1``) with the n-gram drafter, or with ``SPEC_DRAFT=<preset>``
a resident draft model whose eos / pad ids are the target's, its
weights seeded (``init_seed + 1``) on the serving device.

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
stats and, with the engine's ledgers armed, their gauges too (the JAX
server's ``_observatory_metrics``, key for key). With ``TRACING=1`` the
server and the engine emit the JAX server's spans, adopting the caller's
``traceparent``.

The ``debug_*`` hooks serve the engine's observatory behind the
wrapper's ``/debug/*`` routes, each armed by its environment knob as in
the JAX server: ``/debug/timeline`` (``FLIGHT_RECORDER=1``),
``/debug/compile`` (``COMPILE_LEDGER=1``; ``warmup=1`` seals the
lattice), ``/debug/hbm`` (``HBM_LEDGER=1``), ``/debug/sched``
(``SCHED_LEDGER=1``), ``/debug/pilot`` (``PILOT=1`` or ``PILOT=hold``)
and ``/debug/roof`` (``ROOF_LEDGER=1``); a route whose knob is off
answers 404 with the knob's name.

Supervised recovery and fault injection are environment-only, as in the
JAX server, and read by the engine itself: ``HEAL=1`` (with
``HEAL_MAX_RETRIES`` / ``HEAL_WATCHDOG_MS``) arms the heal supervisor,
served at ``/debug/health`` with its state and pressure in the readiness
detail (recovering and degraded are still ready) and as the
``torchserver_heal_*`` gauges; ``CHAOS=1`` with the ``CHAOS_*`` knobs
arms the fault injector. Neither is a unit parameter, so a deployment
manifest cannot turn them on by accident.

``prefix_cache=1`` (or ``PREFIX_CACHE=1``) turns on the engine's prefix
cache: prompts that share block-aligned prefixes share their KV blocks.

The serving plan is the JAX server's (``_serving_mesh`` and
``_mesh_for``), over the devices :func:`serving_devices` lists (the
visible cards, MESH_DEVICES-capped; one device on the CPU): ``tp=2`` (or
``TP=2``) a tp-wide group (exact tensor parallelism, bit-identical to
tp=1); with ``mesh_sp`` > 1 and a config whose ``attn_impl`` is
``"ring"``, sp x tp x dp (tp the gcd of the devices per sp rank and the
KV heads: scores and dense admissions run context-parallel over sp);
otherwise ``MeshPlan.auto``: tp as wide as the KV heads allow, dp for
the rest. A plan of more than one device serves a ``MeshEngine`` on a
rank group of that plan (``servers/mesh_engine.py``); each rank builds
the shard of its tp coordinate from the seed or the checkpoint
(``mesh_engine.build_shards``), so the whole model never sits on one
card. ``tp`` > 1 and ``mesh_sp`` > 1 exclude each other, as in the JAX
server.

Not carried yet (ROADMAP.md queue A): orbax checkpoint directories (the
JAX server's ``servers/checkpoint.py`` branch of ``model_uri``, item
A27).
"""

from __future__ import annotations

import dataclasses
import logging
import math
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
from seldon_tpu_torch.parallel.mesh import (Mesh, MeshPlan, cuda_devices,
                                            make_mesh)
from seldon_tpu_torch.runtime.user_model import SeldonComponent
from seldon_tpu_torch.servers import mesh_engine
from seldon_tpu_torch.servers.engine import (KIND_HTTP_STATUS, EngineConfig,
                                             InferenceEngine)
from seldon_tpu_torch.servers.tokenizer import ByteTokenizer, load_tokenizer

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
              cfg: ModelConfig, ring=None, tp=None) -> torch.Tensor:
    """Per-row mean next-token NLL [B] f32 of token ids [B, S]: the JAX
    server's ``_score`` (``forward``, then :func:`mean_nll`). ``ring``:
    the sp rank group of a context-parallel score (every rank runs its
    block of the sequence; ``transformer.forward_hidden``). ``tp``: the
    hints of a tensor-parallel score on this rank's shard."""
    return mean_nll(transformer.forward(params, toks, cfg, ring=ring, tp=tp),
                    toks)


def serving_devices(device: torch.device) -> List[torch.device]:
    """The devices a server plans over (the JAX server's
    ``jax.devices()``): on the card the visible cards, capped by
    MESH_DEVICES (``mesh_engine.device_budget``); on the CPU the one
    device. Tests and ``chip_smoke.py`` hand a longer list (CPU ranks,
    or one card named several times) by replacing this function: the
    counterpart of the forced host device count of the JAX package's
    tests."""
    if device.type == "cpu":
        return [device]
    return cuda_devices()[:mesh_engine.device_budget()]


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
        # Context-parallel axis width: with attn_impl == "ring", scores
        # and dense admissions run with the sequence sharded over 'sp'
        # ranks (ring attention), beside tp and dp (_mesh_for); 0 = no
        # sp axis. tp >= 1 serves a tp-wide rank group instead of the
        # auto plan (servers/mesh_engine.py: the first tp cards,
        # MESH_DEVICES-capped; tp CPU ranks on the CPU), bit-identical
        # to tp=1. tp > 1 and mesh_sp > 1 exclude each other.
        self.mesh_sp = int(mesh_sp)
        self.tp = int(tp or env("TP", "0") or 0)
        if self.tp > 1 and self.mesh_sp > 1:
            raise ValueError(
                f"tp={self.tp} and mesh_sp={self.mesh_sp} are mutually "
                "exclusive (ring attention is not tp-threaded)")
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
        # The resident draft model (SPEC_DRAFT): (params, cfg) or None.
        self.draft = None
        self.tokenizer = ByteTokenizer()
        self._tracer = tracing.get_tracer("torchserver")
        # The live rank group (servers/mesh_engine.MeshGroup) of the
        # serving plan, or None on one device.
        self.group = None

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
        tp = self.group.tp if self.group is not None else 1
        if tp > 1:
            ekw["tp"] = tp
        return EngineConfig(max_slots=self.max_slots, max_seq_len=seq,
                            prompt_buckets=buckets, **ekw)

    def _checkpoint_source(self) -> tuple:
        """``model_uri`` fetched to a local directory, its tokenizer
        loaded, and the weight source it holds, in the JAX server's order:
        ``("hf", dir)`` for config.json + *.safetensors, else ``("orbax",
        dir)`` (config.json + ``params/``, ``servers/checkpoint.py``)."""
        from seldon_tpu_torch.servers.storage import download

        local = download(self.model_uri)
        self.tokenizer = load_tokenizer(local)
        if os.path.exists(os.path.join(local, "config.json")) and any(
                f.endswith(".safetensors") for f in os.listdir(local)):
            return ("hf", local)
        return ("orbax", local)

    def _load_model(self) -> None:
        """The config and the weights (seeded, or the checkpoint's), once
        (caller holds ``_load_lock``). On a plan of several devices every
        rank builds the shard of its tp coordinate
        (``mesh_engine.build_shards``)."""
        from seldon_tpu_torch.servers import checkpoint, hf_loader

        if self.params is not None:
            return
        if self.model_uri:
            source = self._checkpoint_source()
            # No config.json: FileNotFoundError, as the JAX load_config.
            cfg = (hf_loader.checkpoint_config(source[1])
                   if source[0] == "hf" else
                   checkpoint.load_config(source[1]))
        else:
            source = ("seed", self.init_seed)
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
        if cfg.act_dtype == "int8" and self.model_uri:
            # Trained checkpoints carry activation outliers in the
            # down-projection inputs that per-token int8 clips; random
            # presets do not show this.
            logger.warning(
                "act_dtype=int8 (W8A8) enabled for loaded checkpoint "
                "%s: down-proj activation outliers can degrade output "
                "quality — validate accuracy before serving traffic "
                "(weights-only int8 is the safe default)",
                self.model_uri,
            )
        mesh = self._serving_mesh(cfg)
        if mesh.devices.size > 1:
            self.group = mesh_engine.spawn_group(mesh)
            params = mesh_engine.build_shards(self.group, cfg, source)
        else:
            if source[0] == "hf":
                params = hf_loader.load_hf_checkpoint(source[1],
                                                      self.device)[0]
            elif source[0] == "orbax":
                params = checkpoint.load_checkpoint(source[1],
                                                    self.device)[0]
            else:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(self.init_seed)
                params = transformer.init_params(cfg, gen, self.device)
            if cfg.weight_dtype == "int8":
                params = quantize_params(params)
        self.params = params
        self.cfg = cfg
        if self.spec and self.spec_draft:
            self.draft = self._draft_model(cfg)

    def _serving_mesh(self, cfg: ModelConfig) -> Mesh:
        """The mesh the server runs on (the JAX server's
        ``_serving_mesh``): with tp >= 1 a tp-wide 'tp' mesh (the first tp
        cards, MESH_DEVICES-capped; tp CPU ranks on the CPU), else
        :meth:`_mesh_for`. A mesh of one device builds no group."""
        if self.tp >= 1:
            return mesh_engine.build_tp_mesh(
                self.tp, [self.device] * self.tp
                if self.device.type == "cpu" else None)
        return self._mesh_for(cfg)

    def _mesh_for(self, cfg: ModelConfig) -> Mesh:
        """The JAX server's ``_mesh_for`` over :func:`serving_devices`:
        with mesh_sp > 1, the ring's attention and the devices splitting
        evenly over sp, ``MeshPlan(sp, tp=gcd(n / sp, n_kv_heads), dp =
        the rest)``; otherwise ``MeshPlan.auto`` (tp as wide as the KV
        heads allow, a power of two; dp for the rest)."""
        devices = serving_devices(self.device)
        n = len(devices)
        if self.mesh_sp > 1 and cfg.attn_impl == "ring" \
                and n % self.mesh_sp == 0:
            rem = n // self.mesh_sp
            tp = math.gcd(rem, cfg.n_kv_heads)
            return make_mesh(MeshPlan(sp=self.mesh_sp, tp=tp, dp=rem // tp),
                             devices)
        return make_mesh(MeshPlan.auto(n, cfg), devices)

    def _draft_model(self, cfg: ModelConfig):
        """The resident draft model of ``spec_draft`` (a preset): its
        proposals must be valid target token ids, so its eos / pad ids are
        the target's; its weights are seeded (``init_seed + 1``) on the
        serving device, as the JAX server's."""
        dcfg = get_config(self.spec_draft, eos_token_id=cfg.eos_token_id,
                          pad_token_id=cfg.pad_token_id)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.init_seed + 1)
        dparams = transformer.init_params(dcfg, gen, self.device)
        if dcfg.weight_dtype == "int8":
            dparams = quantize_params(dparams)
        return dparams, dcfg

    def load(self) -> None:
        with self._load_lock:
            if self._loaded:
                return
            self._load_model()
            ecfg = self._engine_config(self.cfg)
            if self.group is not None:
                self.engine = mesh_engine.MeshEngine(
                    self.params, self.cfg, ecfg, draft=self.draft,
                    group=self.group, sharded=True)
            else:
                self.engine = InferenceEngine(self.params, self.cfg, ecfg,
                                              self.device, draft=self.draft,
                                              mesh=self.group)
            if self.warmup:
                self.engine.warmup()
            self.engine.start()
            self._loaded = True
            logger.info("TorchServer loaded: %s device=%s slots=%d "
                        "seq=%d kernel=%s prefix_cache=%s",
                        self.model_uri or f"preset={self.preset}",
                        self.device, self.max_slots, ecfg.max_seq_len,
                        self.ragged_kernel, self.prefix_cache)

    def _ensure_loaded(self):
        if not self._loaded:
            self.load()

    def stop(self) -> None:
        """Stop the engine (every unfinished request gets a retriable
        shutdown error)."""
        if self.engine is not None:
            self.engine.stop()
        if self.group is not None:
            self.group.close()

    def health_status(self):
        """Readiness probe: never blocks on (or triggers) load — not
        loaded IS not ready — and raises from the moment drain starts, so
        load balancers stop routing here while in-flight work finishes."""
        if not self._loaded:
            raise RuntimeError("model loading")
        if self.engine.draining:
            raise RuntimeError("engine draining")
        out = {"engine": self.engine.stats.snapshot()}
        heal = self.engine.debug_health()
        if heal is not None:
            # Recovering or degraded is still READY: the engine is
            # serving; operators read the state here and at
            # /debug/health.
            out["heal"] = {"state": heal["state"],
                           "pressure": heal["pressure"]}
        return out

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
        (lower = the model finds the sequence more likely). Under tp the
        score runs on every rank's shard; over an sp axis, when the
        sequence splits evenly over it, context-parallel (each dp replica
        scores the whole batch)."""
        with self._load_lock:
            self._load_model()
        ids = np.asarray(X, dtype=np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        toks = torch.as_tensor(ids, device=self.device)
        g = self.group
        S = ids.shape[1]
        ring = g is not None and g.sp > 1 and S > 1 and S % g.sp == 0
        if g is not None and (g.tp > 1 or ring):
            hints = g.hints(g.tp)
            nll = g.score(ids, lambda: score_nll(
                self.params, toks, self.cfg,
                ring=g.sp_ranks if ring else None, tp=hints), ring=ring)
        else:
            nll = score_nll(self.params, toks, self.cfg)
        return nll.cpu().numpy()

    # --- observability ------------------------------------------------------

    def _debug(self, name: str) -> Optional[Dict]:
        if not self._loaded or self.engine is None:
            return None
        return getattr(self.engine, name)()

    def debug_timeline(self) -> Optional[Dict]:
        """Engine flight-recorder snapshot for /debug/timeline (None when
        FLIGHT_RECORDER is off or nothing is loaded)."""
        return self._debug("debug_timeline")

    def debug_compile(self) -> Optional[Dict]:
        """Engine compile-ledger snapshot for /debug/compile (None when
        COMPILE_LEDGER is off or nothing is loaded)."""
        return self._debug("debug_compile")

    def debug_hbm(self) -> Optional[Dict]:
        """Engine HBM-ledger snapshot for /debug/hbm (None when HBM_LEDGER
        is off or nothing is loaded)."""
        return self._debug("debug_hbm")

    def debug_sched(self) -> Optional[Dict]:
        """Engine sched-ledger snapshot for /debug/sched (None when
        SCHED_LEDGER is off or nothing is loaded)."""
        return self._debug("debug_sched")

    def debug_pilot(self) -> Optional[Dict]:
        """Engine pilot snapshot for /debug/pilot (None when PILOT is off
        or nothing is loaded)."""
        return self._debug("debug_pilot")

    def debug_roof(self) -> Optional[Dict]:
        """Engine roofline snapshot for /debug/roof (None when ROOF_LEDGER
        is off or nothing is loaded)."""
        return self._debug("debug_roof")

    def debug_health(self) -> Optional[Dict]:
        """The heal supervisor's snapshot for /debug/health (None when
        HEAL is off or nothing is loaded)."""
        return self._debug("debug_health")

    def _observatory_metrics(self, s: Dict) -> List[Dict]:
        """The ledgers' and the heal supervisor's gauges (the JAX
        server's, under the torchserver_ prefix). Empty when the
        observatory and HEAL are off."""
        out: List[Dict] = []

        def gauge(key, value, **tags):
            g = {"type": "GAUGE", "key": f"torchserver_{key}",
                 "value": float(value)}
            if tags:
                g["tags"] = tags
            out.append(g)

        comp = self.engine.debug_compile()
        if comp is not None:
            gauge("compile_variants", comp["dispatched_variants"])
            gauge("live_retraces", comp["live_retrace_count"])
            gauge("compile_seconds_total", comp["compile_s_total"])
        for key, h in sorted(s.get("variant_timing", {}).items()):
            gauge("dispatch_ms_count", h["count"], variant=key)
            gauge("dispatch_ms_sum", h["sum_ms"], variant=key)
        hbm = self.engine.debug_hbm()
        if hbm is not None:
            for name, cat in sorted(hbm["categories"].items()):
                gauge("hbm_bytes", cat["bytes"], category=name)
        sched = self.engine.debug_sched()
        if sched is not None:
            gauge("padding_waste_frac", sched["padding_waste_frac"])
            gauge("sched_budget_utilization", sched["budget_utilization"])
            gauge("sched_idle_boundaries", sched["idle_boundaries"])
            gauge("preempted_tokens", sched["preempted_tokens"])
            gauge("sched_conservation_breaches",
                  sched["conservation"]["breaches"])
            for cause, frac in sorted(sched["goodput_gap"].items()):
                gauge("goodput_gap", frac, cause=cause)
            for comp_ in ("pool_ms", "bucket_ms", "budget_ms", "sched_ms"):
                gauge("queue_wait_ms_total", sched["wait"][comp_],
                      component=comp_)
            if self.spec:
                spec = sched["spec"]
                gauge("spec_acceptance_rate", spec["acceptance_rate"])
                gauge("spec_drafted_tokens", spec["drafted_tokens"])
                gauge("spec_accepted_tokens", spec["accepted_tokens"])
                gauge("spec_rejected_tokens", spec["rejected_tokens"])
                gauge("spec_verify_waves", spec["verify_waves"])
        pilot = self.engine.debug_pilot()
        if pilot is not None:
            for knob, n in sorted(pilot["decisions_by_knob"].items()):
                gauge("pilot_decisions_total", n, knob=knob)
            gauge("pilot_budget_current",
                  pilot["knobs"]["dispatch_token_budget"])
            gauge("pilot_admit_current", pilot["knobs"]["max_admit"])
            gauge("pilot_spec_k_current", pilot["knobs"]["spec_k"])
            gauge("pilot_edf_inversions", pilot["edf"]["inversions"])
            gauge("pilot_goodput_delta",
                  pilot["counterfactual"]["goodput_delta"])
        roof = self.engine.debug_roof()
        if roof is not None:
            for v in roof["variants"]:
                gauge("mfu", v["mfu"], variant=v["key"])
                gauge("mbu", v["mbu"], variant=v["key"])
            gauge("host_frac", roof["host_frac"])
            gauge("roof_conservation_breaches",
                  roof["conservation"]["breaches"])
        heal = self.engine.debug_health()
        if heal is not None:
            for key in ("resurrected", "quarantined", "watchdog_trips",
                        "retry_exhausted", "pressure"):
                gauge(f"heal_{key}", heal[key])
        return out

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
        return self._slo_metrics(s) + self._observatory_metrics(s) + [
            {"type": "GAUGE", "key": f"torchserver_{k}",
             "value": float(s[k])} for k in self._GAUGES]

    def tags(self) -> Dict:
        return {"server": "torchserver", "preset": self.preset}
