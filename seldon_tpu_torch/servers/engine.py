"""Continuous-batching inference engine — the ragged family of
``seldon_tpu/servers/engine.py``, in PyTorch.

A fixed pool of ``max_slots`` slots shares one paged KV block pool
``[L, NB, Hkv, kv_block, (Dh)]`` addressed through per-slot block tables
(host-side :class:`BlockAllocator`, block 0 the trash block). Every
scheduler step is ONE unified ragged wave
(``models/ragged_attention.ragged_wave``): the prefill chunks of any mix
of new and continuing prompts, packed into the flat token buffer, plus
one decode step for every armed row. The loop is software-pipelined one
wave deep: wave N+1 is dispatched before wave N's results are read, so
the host's bookkeeping overlaps the device's work; results come back
through asynchronous copies into pinned memory and one event per wave.

Carried from the JAX engine: ``EngineConfig`` (every field, default and
validation), ``submit`` / ``generate_blocking`` / ``cancel`` / ``drain``
/ ``start`` / ``stop``, slot and block bookkeeping, optimistic slot
recycling, preemption on pool exhaustion, cancel / deadline reaping and
the shutdown sweep, and both scheduler loops: with ``async_fetch`` (the
default) a fetcher thread reads each wave's results while the scheduler
dispatches on, without it the scheduler reads wave N after dispatching
wave N+1. All three ragged legs of the JAX engine run: ``masked``,
``sparse`` (the masked-matched walk) and ``pallas`` (the kernel leg).
Each dispatch hands the wave the count of live block columns its host
descriptors give, so the sparse leg's walks never wait for the device.
Not carried yet, and rejected by ``__init__`` with
NotImplementedError naming the ROADMAP.md item: ``ragged=False`` (the
bucketed and dense engines) and the knobs that only steer them
(``max_admit``, ``decode_chunk``, ``min_chunk``, ``adaptive_chunk`` away
from their defaults), ``spec_decode``, ``prefix_cache``, ``tp > 1``,
``heal``, ``chaos``, and ``ragged_block_budget`` on the kernel leg on the
card. Ledgers, the pilot and the flight recorder wait for later slices.
:class:`EngineStats` keeps the counters, the inter-token latency
histogram and the SLO accounting the server's metrics read, and each
request's lifecycle is retro-emitted as the JAX engine's spans
(``engine.request`` / ``queued`` / ``prefill`` / ``decode``, with
``TRACING=1``), adopting the caller's ``traceparent``.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import queue
import threading
import time
from typing import Any, Deque, Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from seldon_tpu_torch.core import tracing
from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.models import ragged_attention, transformer
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.servers.block_pool import BlockAllocator

logger = logging.getLogger(__name__)

# HTTP status per error-item kind, for errors surfacing before any stream
# bytes went out.
KIND_HTTP_STATUS = {
    "capacity": 429,
    "draining": 503,
    "shutdown": 503,
    "preempted": 503,
    "deadline": 504,
    "cancelled": 499,
    "poison": 500,
}


class EngineOverloaded(RuntimeError):
    """Admission queue is full — the request was shed at submit time."""

    http_status = 429
    retriable = True


class EngineDraining(RuntimeError):
    """The engine is draining or stopped and not admitting new work."""

    http_status = 503
    retriable = True


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """The JAX engine's config, field for field (defaults and validation
    included). Fields of families this slice does not carry are still
    accepted here; ``InferenceEngine`` rejects the settings it cannot
    serve."""

    max_slots: int = 32
    max_seq_len: int = 2048
    prompt_buckets: Sequence[int] = (32, 128, 512, 1024)
    max_admit: int = 8
    decode_chunk: int = 8
    idle_sleep_s: float = 0.002
    # True: a fetcher thread waits for each wave's results and runs its
    # bookkeeping while the scheduler dispatches on (_loop_async); False:
    # the scheduler reads wave N after dispatching N+1 (_loop_sync_ragged).
    async_fetch: bool = True
    adaptive_chunk: bool = True
    min_chunk: int = 4
    prefix_cache: bool = False
    prefix_block: int = 16
    prefix_cache_bytes: int = 256 << 20
    chunked_prefill: bool = False
    prefill_chunk: int = 128
    dispatch_token_budget: int = 0
    paged_kv: bool = False
    kv_block: int = 16
    kv_pool_blocks: int = 0
    ragged: bool = False
    ragged_chunk: int = 0
    # Ragged attention leg: "masked" (full-width, the oracle), "sparse"
    # (the masked-matched walk over live blocks) or "pallas" (the
    # hand-written CUDA kernel on the card; its plain version on the CPU).
    ragged_kernel: str = "masked"
    ragged_block_budget: int = 0
    spec_decode: bool = False
    spec_k: int = 4
    spec_draft: str = ""
    tp: int = 1
    default_deadline_ms: int = 0
    max_queue: int = 0
    chaos: Optional[Any] = None
    heal: bool = False
    heal_max_retries: int = 4
    heal_watchdog_ms: int = 0

    def __post_init__(self):
        def pow2(n: int) -> bool:
            return n >= 1 and (n & (n - 1)) == 0

        if self.min_chunk > self.decode_chunk:
            raise ValueError(
                f"min_chunk ({self.min_chunk}) must not exceed decode_chunk "
                f"({self.decode_chunk}) — the adaptive ladder interpolates "
                f"between them"
            )
        if not pow2(self.max_admit):
            raise ValueError(
                f"max_admit ({self.max_admit}) must be a power of two — "
                f"admission groups are padded to pow2 to bound jit variants"
            )
        for b in self.prompt_buckets:
            if not pow2(b):
                raise ValueError(
                    f"prompt_buckets entry {b} must be a power of two — "
                    f"each bucket is a compiled prefill variant"
                )
        if self.chunked_prefill:
            if not pow2(self.prefill_chunk):
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a power "
                    f"of two — each chunk length is a compiled variant"
                )
            if self.prefill_chunk % self.prefix_block:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"multiple of the KV block size prefix_block "
                    f"({self.prefix_block}) so chunk boundaries never split "
                    f"a prefix-cache block"
                )
            if self.dispatch_token_budget and (
                self.dispatch_token_budget < self.prefill_chunk
            ):
                raise ValueError(
                    f"dispatch_token_budget ({self.dispatch_token_budget}) "
                    f"must be 0 (one chunk per dispatch) or >= prefill_chunk "
                    f"({self.prefill_chunk}) — a dispatch must fit at least "
                    f"one chunk to make progress"
                )
        if self.paged_kv:
            if not pow2(self.kv_block):
                raise ValueError(
                    f"kv_block ({self.kv_block}) must be a power of two — "
                    f"block offsets are computed with pow2 div/mod"
                )
            if self.kv_block % self.prefix_block:
                raise ValueError(
                    f"kv_block ({self.kv_block}) must be a multiple of "
                    f"prefix_block ({self.prefix_block}) so trie spans never "
                    f"straddle a pool block"
                )
            if self.max_seq_len % self.kv_block:
                raise ValueError(
                    f"max_seq_len ({self.max_seq_len}) must be a multiple of "
                    f"kv_block ({self.kv_block}) — block tables are "
                    f"max_seq_len / kv_block entries wide"
                )
            if any(b % self.kv_block for b in self.prompt_buckets):
                raise ValueError(
                    f"every prompt_buckets entry ({self.prompt_buckets}) "
                    f"must be a multiple of kv_block ({self.kv_block}) — "
                    f"warm prefix widths are bucketed and must cover whole "
                    f"pool blocks"
                )
            if self.chunked_prefill and self.prefill_chunk % self.kv_block:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must be a "
                    f"multiple of kv_block ({self.kv_block}) under paged_kv "
                    f"so chunk boundaries append whole pool blocks"
                )
            if self.kv_pool_blocks and self.kv_pool_blocks < 2:
                raise ValueError(
                    f"kv_pool_blocks ({self.kv_pool_blocks}) must be >= 2 "
                    f"(1 reserved trash block + 1 usable) or 0 for the "
                    f"dense-equivalent budget"
                )
        if self.ragged:
            if not (self.paged_kv and self.chunked_prefill):
                raise ValueError(
                    "ragged=True requires paged_kv=True and "
                    "chunked_prefill=True — the unified wave walks block "
                    "tables and admits prompts chunkwise"
                )
            rc = self.ragged_chunk or self.prefill_chunk
            if not pow2(rc):
                raise ValueError(
                    f"ragged_chunk ({rc}) must be a power of two — it is "
                    f"the ONE compiled wave width"
                )
            if rc % self.kv_block:
                raise ValueError(
                    f"ragged_chunk ({rc}) must be a multiple of kv_block "
                    f"({self.kv_block}) so wave boundaries append whole "
                    f"pool blocks"
                )
        if self.ragged_kernel not in ("masked", "sparse", "pallas"):
            raise ValueError(
                f"ragged_kernel ({self.ragged_kernel!r}) must be one of "
                f"'masked', 'sparse', 'pallas'"
            )
        if self.ragged_block_budget < 0:
            raise ValueError(
                f"ragged_block_budget ({self.ragged_block_budget}) must "
                f"be >= 0 (0 = no budget)"
            )
        if self.spec_decode:
            if not self.paged_kv:
                raise ValueError(
                    "spec_decode=True requires paged_kv=True — rollback "
                    "after a rejected draft is a host-side block-table "
                    "trim, which only the paged engine supports"
                )
            if self.ragged:
                raise ValueError(
                    "spec_decode=True is incompatible with ragged=True — "
                    "each replaces the decode dispatch (a verify wave IS "
                    "a ragged decode wave with k+1 tokens per slot)"
                )
            if not pow2(self.spec_k):
                raise ValueError(
                    f"spec_k ({self.spec_k}) must be a power of two — "
                    f"verify variants compile one rung per pow2 k, and "
                    f"the pilot walks that ladder"
                )
        if self.tp < 1:
            raise ValueError(
                f"tp ({self.tp}) must be >= 1 (1 = no tensor parallelism)"
            )
        if self.default_deadline_ms < 0:
            raise ValueError(
                f"default_deadline_ms ({self.default_deadline_ms}) must be "
                f">= 0 (0 disables the default TTL)"
            )
        if self.max_queue < 0:
            raise ValueError(
                f"max_queue ({self.max_queue}) must be >= 0 (0 leaves the "
                f"admission queue unbounded)"
            )
        if self.heal_max_retries < 1:
            raise ValueError(
                f"heal_max_retries ({self.heal_max_retries}) must be >= 1 "
                f"— a request must be allowed at least one resurrection "
                f"or heal can never recover anything"
            )
        if self.heal_watchdog_ms < 0:
            raise ValueError(
                f"heal_watchdog_ms ({self.heal_watchdog_ms}) must be >= 0 "
                f"(0 disables the boundary-fetch watchdog)"
            )


@dataclasses.dataclass
class _Request:
    rid: int
    tokens: List[int]
    params: SamplingParams
    out: "queue.Queue[Optional[dict]]"
    submitted_at: float
    first_token_at: Optional[float] = None
    n_generated: int = 0
    slot: int = -1
    # Host-side upper bound of tokens produced by dispatched-but-unread
    # waves — drives optimistic slot recycling; the device's `remaining`
    # counter guarantees the row is frozen once the budget is spent.
    expected: int = 0
    finished: bool = False
    # Prompt tokens whose KV is resident, and whether the request is
    # still mid-prefill (holds a slot; decode rosters skip it).
    prefill_done: int = 0
    prefilling: bool = False
    # Every pool block this request's table row points at (one allocator
    # ref each).
    block_ids: List[int] = dataclasses.field(default_factory=list)
    first_dispatch_at: Optional[float] = None
    deadline: Optional[float] = None
    cancelled: bool = False
    outcome: str = ""
    # When the request's last token burst reached the host (ITL gaps).
    last_burst_at: Optional[float] = None
    # The caller's span context (from SamplingParams.traceparent).
    trace: Optional[tracing.SpanContext] = None


class _HostCopy(NamedTuple):
    """Device results on their way to the host: pinned buffers filled by
    non-blocking copies, and the event recorded after them (None on the
    CPU, where the tensors already are host memory)."""

    arrays: List[torch.Tensor]
    event: Optional[Any]

    def wait(self) -> List[np.ndarray]:
        if self.event is not None:
            self.event.synchronize()
        return [a.numpy() for a in self.arrays]


class _PendingWave(NamedTuple):
    """One dispatched-but-unread wave: the prefill group (requests, final
    flags) whose first tokens ride ``host``, the slot->request roster of
    the decode leg, the host copy of (first, first_done, toks, valid,
    active), and the device-state epoch it was dispatched against."""

    group: List[_Request]
    finals: List[bool]
    roster: List[Optional[_Request]]
    host: Optional[_HostCopy]
    epoch: int


class EngineStats:
    """The engine's counters: the JAX engine's ``EngineStats`` minus the
    ledgers' fields (scheduler waste, per-variant dispatch timing), which
    wait for ROADMAP.md queue A, item A9. The ITL histogram, the SLO
    accounting and the budget utilization are the JAX twin's, edge for
    edge, so the snapshots agree on the same inputs. The prefix-cache
    and copy-on-write counters stay 0: the port has no prefix cache yet
    (item A5), as the JAX engine with the cache off."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.completed = 0
        self.tokens_out = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        # Waves dispatched, and how many of them ran a prefill leg (the
        # kernel leg skips it on decode-only waves).
        self.decode_dispatches = 0
        self.prefill_waves = 0
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        self.prefix_evictions = 0
        self.queue_depth = 0
        self.queue_wait_sum = 0.0
        self.queue_wait_count = 0
        # Inter-token latency histogram (ms, per burst gap); quantiles
        # read the bucket's upper edge.
        self.itl_edges_ms = (2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                             500.0, 1000.0)
        self.itl_counts = [0] * (len(self.itl_edges_ms) + 1)
        self.itl_sum_ms = 0.0
        self.prefill_chunks = 0
        self.prefill_chunk_tokens = 0
        # Waves that packed prefill tokens, the tokens they packed, and
        # the per-wave token budget: their ratio is budget_utilization.
        self.budget_dispatches = 0
        self.budget_tokens = 0
        self.budget_limit = 0
        self.zero_copy_admissions = 0
        self.cow_copies = 0
        self.pool_stalls = 0
        self.preemptions = 0
        self.prefix_seed_copies = 0
        # Set by the engine to the allocator's snapshot().
        self.pool_gauges = None
        self.shed_total = 0
        self.cancelled_total = 0
        self.deadline_expired_total = 0
        self.queue_rejects = 0
        # SLO attainment: deadline margin at terminal time (ms left;
        # negative = late) and goodput.
        self.deadline_margin_edges_ms = (
            -1000.0, -500.0, -200.0, -100.0, -50.0, -20.0, 0.0,
            20.0, 50.0, 100.0, 200.0, 500.0, 1000.0,
        )
        self.deadline_margin_counts = [0] * (
            len(self.deadline_margin_edges_ms) + 1)
        self.deadline_margin_sum_ms = 0.0
        self.deadline_met_total = 0
        self.deadline_missed_total = 0
        self.completed_no_deadline_total = 0

    def record_slo_locked(self, margin_ms: Optional[float],
                          ok: bool) -> None:
        """Caller holds self.lock. margin_ms None = the request carried
        no deadline; ok = the terminal outcome was a normal completion.
        A deadline-bearing request counts as met only when it completed
        normally with margin to spare."""
        if margin_ms is None:
            if ok:
                self.completed_no_deadline_total += 1
            return
        i = 0
        for edge in self.deadline_margin_edges_ms:
            if margin_ms <= edge:
                break
            i += 1
        self.deadline_margin_counts[i] += 1
        self.deadline_margin_sum_ms += margin_ms
        if ok and margin_ms >= 0.0:
            self.deadline_met_total += 1
        else:
            self.deadline_missed_total += 1

    def record_itl_locked(self, ms: float) -> None:
        """Caller holds self.lock."""
        i = 0
        for edge in self.itl_edges_ms:
            if ms <= edge:
                break
            i += 1
        self.itl_counts[i] += 1
        self.itl_sum_ms += ms

    def _itl_quantile_locked(self, q: float) -> float:
        total = sum(self.itl_counts)
        if not total:
            return 0.0
        target = q * total
        cum = 0
        for i, c in enumerate(self.itl_counts):
            cum += c
            if cum >= target:
                if i < len(self.itl_edges_ms):
                    return self.itl_edges_ms[i]
                return 2.0 * self.itl_edges_ms[-1]  # overflow bucket
        return 2.0 * self.itl_edges_ms[-1]

    def snapshot(self) -> Dict[str, Any]:
        with self.lock:
            gauges = self.pool_gauges
        # Outside the stats lock: the allocator takes its own.
        pool = (gauges() if gauges is not None
                else {"total": 0, "used": 0, "free": 0, "shared": 0})
        with self.lock:
            itl_count = sum(self.itl_counts)
            met_or_missed = self.deadline_met_total + self.deadline_missed_total
            return {
                "pool_blocks_total": pool["total"],
                "pool_blocks_used": pool["used"],
                "pool_blocks_free": pool["free"],
                "pool_blocks_shared": pool["shared"],
                "zero_copy_admissions": self.zero_copy_admissions,
                "cow_copies": self.cow_copies,
                "pool_stalls": self.pool_stalls,
                "preemptions": self.preemptions,
                "prefix_seed_copies": self.prefix_seed_copies,
                "requests": self.requests,
                "completed": self.completed,
                "tokens_out": self.tokens_out,
                "mean_ttft_ms": (1000.0 * self.ttft_sum / self.ttft_count
                                 if self.ttft_count else 0.0),
                "decode_dispatches": self.decode_dispatches,
                "decode_steps": self.decode_dispatches,
                "prefill_waves": self.prefill_waves,
                "prefix_hits": self.prefix_hits,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "prefix_evictions": self.prefix_evictions,
                "queue_depth": self.queue_depth,
                "mean_queue_wait_ms": (
                    1000.0 * self.queue_wait_sum / self.queue_wait_count
                    if self.queue_wait_count else 0.0),
                "itl_count": itl_count,
                "mean_itl_ms": (self.itl_sum_ms / itl_count
                                if itl_count else 0.0),
                "itl_p50_ms": self._itl_quantile_locked(0.50),
                "itl_p95_ms": self._itl_quantile_locked(0.95),
                "itl_p99_ms": self._itl_quantile_locked(0.99),
                "prefill_chunks": self.prefill_chunks,
                "prefill_chunk_tokens": self.prefill_chunk_tokens,
                "budget_utilization": (
                    self.budget_tokens
                    / (self.budget_dispatches * self.budget_limit)
                    if self.budget_dispatches and self.budget_limit
                    else 0.0),
                "shed_total": self.shed_total,
                "cancelled_total": self.cancelled_total,
                "deadline_expired_total": self.deadline_expired_total,
                "queue_rejects": self.queue_rejects,
                "deadline_margin_edges_ms": list(
                    self.deadline_margin_edges_ms),
                "deadline_margin_counts": list(self.deadline_margin_counts),
                "deadline_margin_sum_ms": self.deadline_margin_sum_ms,
                "deadline_met_total": self.deadline_met_total,
                "deadline_missed_total": self.deadline_missed_total,
                "completed_no_deadline_total":
                    self.completed_no_deadline_total,
                "goodput": (self.deadline_met_total / met_or_missed
                            if met_or_missed else 1.0),
            }


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to seldon_tpu_torch yet (ROADMAP.md queue A, "
        f"item {item})"
    )


# Knobs of the bucketed engine's admission groups and decode chunk ladder,
# which the ragged wave never runs; only their defaults are accepted.
_BUCKETED_KNOBS = ("max_admit", "decode_chunk", "min_chunk", "adaptive_chunk")
_DEFAULTS = {f.name: f.default for f in dataclasses.fields(EngineConfig)}


class InferenceEngine:
    """Slot-based continuous batching over one model on one device, ragged
    family only."""

    def __init__(
        self,
        params: transformer.Transformer,
        cfg: ModelConfig,
        engine_cfg: Optional[EngineConfig] = None,
        device: DeviceLike = None,
    ):
        self.cfg = transformer.check_supported(cfg)
        self.ecfg = engine_cfg or EngineConfig()
        ec = self.ecfg
        if not ec.ragged:
            raise _not_ported("ragged=False (the bucketed and dense "
                              "engines)", "A7")
        if ec.spec_decode:
            raise _not_ported("spec_decode", "A6")
        if ec.prefix_cache:
            raise _not_ported("prefix_cache", "A5")
        if ec.tp > 1:
            raise _not_ported("tp > 1", "A11")
        if ec.heal:
            raise _not_ported("heal (supervised recovery)", "A10")
        if ec.chaos is not None:
            raise _not_ported("chaos fault injection", "A10")
        for name in _BUCKETED_KNOBS:
            if getattr(ec, name) != _DEFAULTS[name]:
                raise _not_ported(
                    f"{name}={getattr(ec, name)!r} (it steers the bucketed "
                    f"engine, which the ragged wave does not run)", "A7")
        self.device = resolve_device(device)
        ragged_attention.check_block_budget(
            ec.ragged_kernel, ec.ragged_block_budget, self.device)
        if params.device.type != self.device.type:
            raise ValueError(
                f"params live on {params.device}, engine device is "
                f"{self.device}"
            )
        self.params = params
        B = ec.max_slots
        Smax = ec.max_seq_len
        self._buckets = tuple(
            b for b in ec.prompt_buckets if b <= Smax
        ) or (Smax,)
        self._kv_block = ec.kv_block
        self._nbs = Smax // self._kv_block  # block-table width
        # Default pool: the dense slab's token budget (B * Smax) plus the
        # reserved trash block.
        self._num_blocks = ec.kv_pool_blocks or B * self._nbs + 1
        self._allocator = BlockAllocator(self._num_blocks)
        self._table_host = np.zeros((B, self._nbs), np.int32)
        self._prefill_chunk = min(ec.prefill_chunk, max(self._buckets))
        self._ragged_chunk = min(ec.ragged_chunk or self._prefill_chunk,
                                 max(self._buckets))
        self._kernel = ec.ragged_kernel

        self._state = self._fresh_state()
        self._active_host = np.zeros((B,), bool)
        # Serializes slot/free-list/active bookkeeping between the
        # scheduler thread and callers (submit, cancel, drain, audits).
        self._book = threading.Lock()
        self._wave_epoch = 0
        self._slots: List[Optional[_Request]] = [None] * B
        self._free: List[int] = list(range(B))
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._waiting: Deque[_Request] = collections.deque()
        self._prefilling: Deque[_Request] = collections.deque()
        self._rid = 0
        self._rid_lock = threading.Lock()
        self._requests: Dict[int, _Request] = {}
        self.stats = EngineStats()
        self.stats.pool_gauges = self._allocator.snapshot
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # async_fetch: the fetcher thread, its bounded queue, and every
        # dispatched wave it has not retired yet (the error path fails
        # the requests they carry).
        self._fetcher: Optional[threading.Thread] = None
        self._fetch_q: "Optional[queue.Queue[Optional[_PendingWave]]]" = None
        self._inflight: List[_PendingWave] = []
        # The wave being dispatched, for the error path (requests
        # recycled out of _slots live only in its roster).
        self._dispatch_wreck: Optional[_PendingWave] = None
        # Lifecycle spans are emitted at terminal time from _Request's
        # perf_counter stamps, turned into wall-clock ns through this
        # pairing.
        self._tracer = tracing.get_tracer("engine")
        self._epoch_perf = time.perf_counter()
        self._epoch_ns = time.time_ns()

    # --- device state -------------------------------------------------------

    def _fresh_state(self) -> Dict[str, Any]:
        B = self.ecfg.max_slots
        dev = self.device
        cache = transformer.init_paged_cache(
            self.cfg, self._num_blocks, self._kv_block, dev)

        def z(dtype, fill=0):
            return torch.full((B,), fill, dtype=dtype, device=dev)

        return {
            "cache": cache,
            "last_tok": z(torch.int32),
            "pos": z(torch.int32),
            "active": z(torch.bool, False),
            "temp": z(torch.float32, 1.0),
            "top_k": z(torch.int32),
            "top_p": z(torch.float32, 1.0),
            # uint32 seed values, held in int64 (torch's uint32 has few ops)
            "seeds": z(torch.int64),
            "remaining": z(torch.int32),
        }

    def _host_copy(self, tensors: Sequence[torch.Tensor]) -> _HostCopy:
        """Start the device->host copies of one wave's results NOW, so
        they are queued right behind the wave and ahead of the next."""
        if self.device.type != "cuda":
            return _HostCopy([t.detach().clone() for t in tensors], None)
        bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for buf, t in zip(bufs, tensors):
            buf.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _HostCopy(bufs, event)

    def warmup(self) -> None:
        """Build the CUDA kernel the configured leg launches (the port's
        counterpart of the JAX engine's ahead-of-time compiles)."""
        if self._kernel == "pallas" and self.device.type == "cuda":
            from seldon_tpu_torch.ops import ragged_paged_attention as rpa

            rpa._kernel_lib()

    # --- public API ---------------------------------------------------------

    def submit(
        self, tokens: Sequence[int], params: Optional[SamplingParams] = None
    ) -> "queue.Queue[Optional[dict]]":
        """Enqueue a request. Returns a queue yielding {"tokens": [...],
        "ttft_ms"?} dicts (one per wave that produced tokens for it), an
        {"error", "kind", "retriable"} item on failure, then None."""
        params = params or SamplingParams()
        if len(tokens) == 0:
            raise ValueError("empty prompt")
        if any(not 0 <= int(t) < self.cfg.vocab_size for t in tokens):
            raise ValueError(
                f"prompt token ids must lie in [0, {self.cfg.vocab_size})"
            )
        max_prompt = max(self._buckets)
        if len(tokens) > max_prompt:
            raise ValueError(
                f"prompt length {len(tokens)} exceeds max bucket {max_prompt}"
            )
        if len(tokens) + params.max_new_tokens > self.ecfg.max_seq_len:
            raise ValueError(
                f"prompt length {len(tokens)} + max_new_tokens "
                f"{params.max_new_tokens} exceeds max_seq_len "
                f"{self.ecfg.max_seq_len}; the decode would be truncated "
                f"mid-stream — lower max_new_tokens or shorten the prompt"
            )
        need = -(-len(tokens) // self._kv_block)
        if need > self._num_blocks - 1:
            raise ValueError(
                f"prompt needs {need} kv blocks but the pool holds "
                f"{self._num_blocks - 1}; it can never be admitted — "
                f"raise kv_pool_blocks or shorten the prompt"
            )
        if self._draining.is_set() or self._stop.is_set():
            raise EngineDraining(
                "engine is draining; retry against another replica"
            )
        if self.ecfg.max_queue:
            with self._book:
                depth = self._pending.qsize() + len(self._waiting)
            if depth >= self.ecfg.max_queue:
                with self.stats.lock:
                    self.stats.queue_rejects += 1
                    self.stats.shed_total += 1
                raise EngineOverloaded(
                    f"admission queue full ({self.ecfg.max_queue} "
                    f"requests); retry with backoff"
                )
        now = time.perf_counter()
        req = _Request(0, [int(t) for t in tokens], params, queue.Queue(),
                       now)
        ttl_ms = params.deadline_ms or self.ecfg.default_deadline_ms
        if ttl_ms:
            req.deadline = now + ttl_ms / 1000.0
        with self._rid_lock:
            self._rid += 1
            req.rid = self._rid
            self._requests[req.rid] = req
        req.out.rid = req.rid  # transports cancel() through it
        if self._tracer.enabled and params.traceparent:
            req.trace = tracing.SpanContext.from_traceparent(
                params.traceparent)
        with self.stats.lock:
            self.stats.requests += 1
        self._pending.put(req)
        return req.out

    def generate_blocking(
        self, tokens: Sequence[int], params: Optional[SamplingParams] = None
    ) -> Dict[str, Any]:
        """Submit and collect the full completion. Raises RuntimeError
        (with kind / retriable / http_status) if the engine failed it."""
        out = self.submit(tokens, params)
        toks: List[int] = []
        ttft_ms = None
        error = None
        while True:
            item = out.get()
            if item is None:
                break
            if "error" in item:
                error = item
                continue
            toks.extend(item["tokens"])
            if ttft_ms is None:
                ttft_ms = item.get("ttft_ms")
        if error is not None:
            exc = RuntimeError(f"generation failed: {error['error']}")
            exc.kind = error.get("kind", "internal")
            exc.retriable = bool(error.get("retriable", False))
            exc.http_status = KIND_HTTP_STATUS.get(exc.kind, 500)
            raise exc
        return {"token_ids": toks, "ttft_ms": ttft_ms}

    def cancel(self, rid: int) -> bool:
        """Flag a request for cancellation; reaped at the next wave."""
        with self._rid_lock:
            req = self._requests.get(rid)
        if req is None or req.finished:
            return False
        req.cancelled = True
        return True

    @property
    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting, shed the queue (retriable errors) and wait up to
        `timeout` seconds for in-flight requests. True once quiescent."""
        self._draining.set()
        if self._thread is None or not self._thread.is_alive():
            with self._book:
                self._shed_queued_locked()
        deadline = time.perf_counter() + max(0.0, timeout)
        while time.perf_counter() < deadline:
            with self._book:
                idle = (
                    all(r is None for r in self._slots)
                    and not self._waiting
                    and not self._prefilling
                    and self._pending.empty()
                    and not self._active_host.any()
                )
            if idle:
                return True
            time.sleep(0.005)
        return False

    def debug_lifecycle_check(self) -> Dict[str, Any]:
        """Leak audit: with no queued or in-flight work every entry of the
        returned dict is a leak. Empty dict == clean."""
        leaks: Dict[str, Any] = {}
        with self._book:
            held = [r.rid for r in self._slots if r is not None]
            if held:
                leaks["slots"] = held
            if len(self._free) + len(held) != self.ecfg.max_slots:
                leaks["free_list"] = len(self._free)
            if self._active_host.any():
                leaks["active_host"] = int(self._active_host.sum())
            if self._waiting or not self._pending.empty():
                leaks["queued"] = len(self._waiting) + self._pending.qsize()
            if self._prefilling:
                leaks["prefilling"] = [r.rid for r in self._prefilling]
            with self._rid_lock:
                if self._requests:
                    leaks["registry"] = sorted(self._requests)
            snap = self._allocator.snapshot()
            if snap["used"]:
                leaks["pool_blocks"] = snap
        return leaks

    def slots_busy(self) -> int:
        with self._book:
            return sum(1 for r in self._slots if r is not None)

    def table_host_snapshot(self) -> np.ndarray:
        with self._book:
            return self._table_host.copy()

    def start(self):
        if self._thread is None:
            self._stop.clear()
            self._draining.clear()
            loop = self._loop_sync_ragged
            if self.ecfg.async_fetch:
                # Bounded: caps how far the host's slot view may lag the
                # dispatched waves.
                self._fetch_q = queue.Queue(maxsize=4)
                self._fetcher = threading.Thread(target=self._fetch_loop,
                                                 daemon=True)
                self._fetcher.start()
                loop = self._loop_async
            self._thread = threading.Thread(target=loop, daemon=True)
            self._thread.start()

    def stop(self):
        self._draining.set()
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=60)
            if self._thread.is_alive():
                raise RuntimeError("engine scheduler thread did not stop")
            self._thread = None
        if self._fetcher is not None:
            # Queued behind every wave the scheduler handed over.
            self._fetch_q.put(None)
            self._fetcher.join(timeout=60)
            if self._fetcher.is_alive():
                raise RuntimeError("engine fetcher thread did not stop")
            self._fetcher = None
        self._shutdown_sweep()

    # --- queue and request lifecycle ----------------------------------------

    def _drain_pending(self) -> None:
        while True:
            try:
                self._waiting.append(self._pending.get_nowait())
            except queue.Empty:
                break
        with self.stats.lock:
            self.stats.queue_depth = len(self._waiting)

    def _shed_queued_locked(self) -> None:
        self._drain_pending()
        while self._waiting:
            req = self._waiting.popleft()
            with self.stats.lock:
                self.stats.shed_total += 1
            self._fail_req(req, "engine draining: request was not admitted",
                           kind="draining", retriable=True)

    def _shutdown_sweep(self) -> None:
        """After the scheduler exits: fail everything that never reached a
        terminal state, registry included."""
        with self._book:
            self._drain_pending()
            live: Dict[int, _Request] = {}
            for req in [*self._slots, *self._prefilling, *self._waiting]:
                if req is not None:
                    live[req.rid] = req
            self._waiting.clear()
            with self._rid_lock:
                for rid, req in list(self._requests.items()):
                    live.setdefault(rid, req)
            for req in live.values():
                if not req.finished:
                    with self.stats.lock:
                        self.stats.shed_total += 1
                    self._fail_req(
                        req, "engine stopped before the request completed",
                        kind="shutdown", retriable=True,
                    )
            self._prefilling.clear()

    def _record_first_dispatch(self, group: List[_Request]) -> None:
        now = time.perf_counter()
        wait, n = 0.0, 0
        for req in group:
            if req.first_dispatch_at is None:
                req.first_dispatch_at = now
                wait += now - req.submitted_at
                n += 1
        if n:
            with self.stats.lock:
                self.stats.queue_wait_sum += wait
                self.stats.queue_wait_count += n

    def _fail_req(self, req: _Request, msg: str, kind: str = "internal",
                  retriable: bool = False) -> None:
        if req.finished:
            return
        req.outcome = kind
        req.out.put({"error": msg, "kind": kind, "retriable": retriable})
        self._complete(req)

    def _complete(self, req: _Request) -> None:
        """Finish a request (idempotent); free its slot unless the slot has
        already been recycled to a newer request."""
        if req.finished:
            return
        req.finished = True
        now = time.perf_counter()
        margin_ms = (1000.0 * (req.deadline - now)
                     if req.deadline is not None else None)
        if self._tracer.enabled:
            self._emit_request_spans(req, now, margin_ms)
        with self._rid_lock:
            self._requests.pop(req.rid, None)
        self._release_blocks(req)
        req.out.put(None)
        slot = req.slot
        if 0 <= slot < len(self._slots) and self._slots[slot] is req:
            self._slots[slot] = None
            self._active_host[slot] = False
            self._free.append(slot)
        with self.stats.lock:
            self.stats.completed += 1
            self.stats.record_slo_locked(margin_ms, req.outcome == "")

    def _perf_ns(self, t: float) -> int:
        """perf_counter seconds -> wall-clock ns (span timestamps)."""
        return self._epoch_ns + int((t - self._epoch_perf) * 1e9)

    def _emit_request_spans(self, req: _Request, now: float,
                            margin_ms: Optional[float]) -> None:
        """Retro-emit the request's lifecycle spans: one
        ``engine.request`` root (a child of the caller's traceparent when
        one arrived) with ``engine.queued`` / ``engine.prefill`` /
        ``engine.decode`` children, from the stamps ``_Request`` carries.
        Runs once per request, behind ``_complete``'s ``finished`` flip."""
        outcome = req.outcome or "ok"
        attrs: Dict[str, Any] = {
            "rid": req.rid,
            "outcome": outcome,
            "prompt_tokens": len(req.tokens),
            "completion_tokens": req.n_generated,
        }
        if margin_ms is not None:
            attrs["deadline_margin_ms"] = round(margin_ms, 3)
        root = self._tracer.emit_span(
            "engine.request", self._perf_ns(req.submitted_at),
            self._perf_ns(now), parent=req.trace, attributes=attrs,
            status="OK" if outcome == "ok" else f"ERROR: {outcome}",
        )
        first = req.first_dispatch_at
        self._tracer.emit_span(
            "engine.queued", self._perf_ns(req.submitted_at),
            self._perf_ns(first if first is not None else now), parent=root,
        )
        if first is None:
            return
        tok = req.first_token_at
        self._tracer.emit_span(
            "engine.prefill", self._perf_ns(first),
            self._perf_ns(tok if tok is not None else now), parent=root,
        )
        if tok is not None:
            self._tracer.emit_span(
                "engine.decode", self._perf_ns(tok), self._perf_ns(now),
                parent=root, attributes={"tokens": req.n_generated},
            )

    def _reap_lifecycle(self) -> None:
        """Drain shedding, queued cancel/deadline shedding, then in-flight
        cancel/deadline finalization; reaped rows are frozen device-side
        by one masked write, made only when a reap happened."""
        if self._draining.is_set():
            self._shed_queued_locked()
        now = time.perf_counter()
        self._drain_pending()
        if any(r.cancelled or (r.deadline is not None and now >= r.deadline)
               for r in self._waiting):
            kept: List[_Request] = []
            for req in self._waiting:
                if req.cancelled:
                    with self.stats.lock:
                        self.stats.cancelled_total += 1
                        self.stats.shed_total += 1
                    self._fail_req(req, "cancelled before admission",
                                   kind="cancelled")
                elif req.deadline is not None and now >= req.deadline:
                    with self.stats.lock:
                        self.stats.deadline_expired_total += 1
                        self.stats.shed_total += 1
                    self._fail_req(
                        req,
                        f"deadline exceeded after "
                        f"{1000.0 * (now - req.submitted_at):.0f} ms in "
                        f"queue",
                        kind="deadline",
                    )
                else:
                    kept.append(req)
            self._waiting = collections.deque(kept)
        dead: List[int] = []
        for slot, req in enumerate(self._slots):
            if req is None or req.finished:
                continue
            if req.cancelled:
                with self.stats.lock:
                    self.stats.cancelled_total += 1
                self._fail_req(
                    req, f"cancelled after {req.n_generated} tokens",
                    kind="cancelled",
                )
                dead.append(slot)
            elif req.deadline is not None and now >= req.deadline:
                with self.stats.lock:
                    self.stats.deadline_expired_total += 1
                self._fail_req(
                    req, f"deadline exceeded after {req.n_generated} tokens",
                    kind="deadline",
                )
                dead.append(slot)
        if dead:
            keep = torch.ones((self.ecfg.max_slots,), dtype=torch.bool)
            keep[dead] = False
            keep = keep.to(self.device)
            st = self._state
            self._state = {
                **st,
                "active": st["active"] & keep,
                "remaining": torch.where(keep, st["remaining"], 0),
            }

    # --- paged pool bookkeeping ---------------------------------------------

    def _pool_reserve(self, n: int) -> bool:
        return self._allocator.free_count >= n

    def _secure_blocks(self, n: int, requester: Optional[_Request] = None
                       ) -> Optional[List[int]]:
        """Allocate n blocks; when the pool is exhausted the YOUNGEST live
        stream other than the requester is preempted (failed, retriable)
        until they fit. None when even that cannot free enough."""
        while True:
            got = self._allocator.alloc_many(n)
            if got is not None:
                return got
            victim = None
            for r in self._slots:
                if r is None or r.finished or r is requester:
                    continue
                at = r.first_dispatch_at or float("inf")
                if victim is None or at > (
                    victim.first_dispatch_at or float("inf")
                ):
                    victim = r
            if victim is None:
                return None
            with self.stats.lock:
                self.stats.preemptions += 1
            logger.warning("preempting request %d: kv cache pool exhausted",
                           victim.rid)
            self._fail_req(victim, "preempted: kv cache pool exhausted",
                           kind="preempted", retriable=True)

    def _release_blocks(self, req: _Request) -> None:
        """Drop every allocator ref req's table row holds (idempotent); the
        row is zeroed so in-flight strays land in the trash block."""
        if not req.block_ids:
            return
        slot = req.slot
        if 0 <= slot < len(self._slots) and (
            self._slots[slot] is req or self._slots[slot] is None
        ):
            self._table_host[slot, :] = 0
        for bid in req.block_ids:
            self._allocator.unref(bid)
        req.block_ids = []

    def _grow_decode_blocks(self, n: int) -> None:
        """Extend each decoding slot's table to cover this wave's
        worst-case write position; slots that cannot grow are failed."""
        bs = self._kv_block
        for slot, req in enumerate(self._slots):
            if req is None or req.finished or req.prefilling:
                continue
            maxpos = min(len(req.tokens) + req.expected + n - 2,
                         self.ecfg.max_seq_len - 1)
            need = min(self._nbs, maxpos // bs + 1)
            have = len(req.block_ids)
            if need <= have:
                continue
            got = self._secure_blocks(need - have, requester=req)
            if got is None:
                self._fail_req(req, "kv cache pool exhausted",
                               kind="capacity", retriable=True)
                continue
            for j, bid in enumerate(got):
                self._table_host[slot, have + j] = bid
            req.block_ids.extend(got)

    def _roster(self) -> List[Optional[_Request]]:
        """Slot -> request snapshot for this wave's decode leg; mid-prefill
        requests are masked out."""
        return [None if (r is not None and r.prefilling) else r
                for r in self._slots]

    def _recycle_budget_spent(self, roster: List[Optional[_Request]]) -> None:
        """Optimistic slot recycling: a slot whose token budget is provably
        spent by the waves already dispatched takes a new request at once
        (its device row freezes at its budget; its blocks go back now and
        strays land in the trash block)."""
        for slot, req in enumerate(roster):
            if req is None or req.finished:
                continue
            req.expected += 1
            if req.expected >= req.params.max_new_tokens:
                if self._slots[slot] is req:
                    self._slots[slot] = None
                    self._active_host[slot] = False
                    self._free.append(slot)
                    self._release_blocks(req)

    # --- the ragged wave ------------------------------------------------------

    def _admit_chunk_slot(self, req: _Request) -> None:
        self._record_first_dispatch([req])
        req.slot = self._free.pop()
        req.prefilling = True
        self._slots[req.slot] = req

    def _collect_ragged_work(self, left: int):
        """One wave's prefill packing: each dispatchable request claims its
        slot's segment with exactly its real token count. Continuing
        prefills go first; new admissions need a free slot and their first
        chunk's blocks before the slot pop. Returns (req, chunk_len, final)
        rows, one per request at most."""
        C = self._ragged_chunk
        work = []
        while left > 0:
            if self._prefilling:
                req = self._prefilling.popleft()
                if req.finished:
                    continue
            elif self._waiting and self._free:
                req = self._waiting[0]
                est = min(C, len(req.tokens))
                if est > left:
                    break
                if not self._pool_reserve(est // self._kv_block + 2):
                    with self.stats.lock:
                        self.stats.pool_stalls += 1
                    break
                self._waiting.popleft()
                self._admit_chunk_slot(req)
            else:
                break
            rem = len(req.tokens) - req.prefill_done
            final = rem <= C
            clen = rem if final else C
            if clen > left:
                self._prefilling.appendleft(req)
                break
            work.append((req, clen, final))
            left -= clen
        return work

    def _live_blocks(self, starts: np.ndarray, is_prefill: np.ndarray,
                     roster: List[Optional[_Request]]):
        """(prefill, decode) live block columns of this wave, from the
        host's own descriptors: ``ceil(max bound / kv_block)`` where a
        prefilling row's bound is its start and a decoding row's is its
        position, ``len(prompt) + expected - 1`` (exact while the row
        runs; a row that finished on the device in a wave the host has
        not read yet still counts, which only adds dead columns)."""
        bs = self._kv_block
        pre = int(starts[is_prefill].max()) if is_prefill.any() else 0
        dec = max((min(len(r.tokens) + r.expected - 1,
                       self.ecfg.max_seq_len - 1)
                   for r in roster if r is not None and not r.finished),
                  default=0)
        return -(-pre // bs), -(-dec // bs)

    def _dispatch_ragged(self) -> Optional[_PendingWave]:
        """One unified wave: pack admissions and chunk continuations into
        the token buffer and run ONE ragged wave that prefills every packed
        segment and decodes every armed row. None when idle."""
        self._drain_pending()
        B = self.ecfg.max_slots
        C = self._ragged_chunk
        budget = self.ecfg.dispatch_token_budget or B * C
        work = self._collect_ragged_work(budget)
        if not work and not self._active_host.any():
            return None
        Smax = self.ecfg.max_seq_len
        toks = np.full((B, C), self.cfg.pad_token_id, np.int32)
        plens = np.ones((B,), np.int32)
        # Idle rows trash-route every KV write: start = Smax puts the
        # whole segment past the table.
        starts = np.full((B,), Smax, np.int32)
        seeds = np.zeros((B,), np.int64)
        temps = np.ones((B,), np.float32)
        top_ks = np.zeros((B,), np.int32)
        top_ps = np.ones((B,), np.float32)
        max_news = np.ones((B,), np.int32)
        finals = np.zeros((B,), bool)
        is_prefill = np.zeros((B,), bool)
        packed = 0
        for req, clen, final in work:
            s = req.slot
            sp = req.params
            start = req.prefill_done
            toks[s, :clen] = req.tokens[start:start + clen]
            plens[s] = len(req.tokens)
            starts[s] = start
            seeds[s] = int(sp.seed) & 0xFFFFFFFF
            temps[s] = sp.temperature
            top_ks[s] = sp.top_k
            top_ps[s] = sp.top_p
            max_news[s] = sp.max_new_tokens
            finals[s] = final
            is_prefill[s] = True
            packed += clen
        # Append each packed row's pool blocks (preempting younger streams
        # if needed — real KV must never scatter into the trash block).
        bs = self._kv_block
        for req, clen, _ in work:
            need = min(self._nbs, -(-(req.prefill_done + clen) // bs))
            have = len(req.block_ids)
            if need > have:
                got = self._secure_blocks(need - have, requester=req)
                if got is None:
                    raise RuntimeError("kv cache pool exhausted (ragged wave)")
                for j, bid in enumerate(got):
                    self._table_host[req.slot, have + j] = bid
                req.block_ids.extend(got)
        # Final rows flip to decoding BEFORE the roster / growth pass, so
        # this wave's decode leg covers them.
        group: List[_Request] = []
        finals_l: List[bool] = []
        for req, clen, final in work:
            if req.finished:
                # Preempted by a later row's block grab: drop its writes.
                finals[req.slot] = False
                is_prefill[req.slot] = False
                continue
            req.prefill_done += clen
            group.append(req)
            finals_l.append(final)
            if final:
                req.prefilling = False
                req.expected = 1  # the wave samples the first token
            else:
                self._prefilling.append(req)
        roster = self._roster()
        self._dispatch_wreck = _PendingWave(group, finals_l, roster, None,
                                            self._wave_epoch)
        self._grow_decode_blocks(1)
        has_prefill = bool(is_prefill.any())
        live_blocks = self._live_blocks(starts, is_prefill, roster)
        dev = self.device

        def d(a: np.ndarray) -> torch.Tensor:
            # A copy from pageable memory would wait for the stream (the
            # previous wave); from a pinned copy it is queued behind it.
            t = torch.from_numpy(a)
            if dev.type != "cuda":
                return t
            return t.pin_memory().to(dev, non_blocking=True)

        out = ragged_attention.ragged_wave(
            self.params, self._state, d(self._table_host),
            d(toks.reshape(-1)), d(plens), d(starts), d(seeds), d(temps),
            d(top_ks), d(top_ps), d(max_news), d(finals), d(is_prefill),
            self.cfg, kernel=self._kernel,
            block_budget=self.ecfg.ragged_block_budget,
            has_prefill=has_prefill, live_blocks=live_blocks,
        )
        self._state, first, first_done, toks_d, valid_d = out
        host = self._host_copy(
            [first, first_done, toks_d, valid_d, self._state["active"]])
        with self.stats.lock:
            self.stats.decode_dispatches += 1
            self.stats.prefill_waves += int(
                has_prefill or self._kernel == "masked")
            if group:
                self.stats.prefill_chunks += len(group)
                self.stats.prefill_chunk_tokens += packed
                self.stats.budget_dispatches += 1
                self.stats.budget_tokens += packed
                self.stats.budget_limit = budget
        self._recycle_budget_spent(roster)
        self._dispatch_wreck = None
        return _PendingWave(group, finals_l, roster, host, self._wave_epoch)

    # --- boundary processing ----------------------------------------------------

    def _process_admits(self, group, finals, first_h, done_h) -> None:
        now = time.perf_counter()
        ttft_total, n_first, n_armed = 0.0, 0, 0
        for req, final in zip(group, finals):
            if not final or req.finished:
                continue
            slot = req.slot
            first_tok = int(first_h[slot])
            req.last_burst_at = now
            req.n_generated = 1
            n_armed += 1
            if req.first_token_at is None:
                req.first_token_at = now
                ttft_ms = 1000.0 * (now - req.submitted_at)
                ttft_total += ttft_ms
                n_first += 1
                req.out.put({"tokens": [first_tok], "ttft_ms": ttft_ms})
            else:
                req.out.put({"tokens": [first_tok]})
            if bool(done_h[slot]):
                self._complete(req)
            elif self._slots[slot] is req:
                # Not armed when the slot was already recycled.
                self._active_host[slot] = True
        with self.stats.lock:
            self.stats.ttft_sum += ttft_total / 1000.0
            self.stats.ttft_count += n_first
            self.stats.tokens_out += n_armed

    def _process_chunk(self, toks_h, valid_h, active_h, roster) -> None:
        """toks_h / valid_h [K, B], active_h [B]; `roster` is the slot ->
        request snapshot taken when THIS wave was dispatched."""
        n_valid = valid_h.sum(axis=0)
        total = 0
        now = time.perf_counter()
        gaps_ms: List[float] = []
        for slot, req in enumerate(roster):
            if req is None or req.finished:
                continue
            n = int(n_valid[slot])
            if n:
                req.out.put({"tokens": toks_h[:n, slot].tolist()})
                req.n_generated += n
                total += n
                if req.last_burst_at is not None:
                    # One ITL sample per burst gap, as the JAX engine.
                    gaps_ms.append(1000.0 * (now - req.last_burst_at))
                req.last_burst_at = now
            if not active_h[slot]:
                self._complete(req)
        if total or gaps_ms:
            with self.stats.lock:
                self.stats.tokens_out += total
                for g in gaps_ms:
                    self.stats.record_itl_locked(g)

    def _process_boundary(self, wave: _PendingWave) -> None:
        """Read one wave's results (waits for its copies) and run the host
        bookkeeping. A wave from before a device-state rebuild is dropped."""
        if wave.epoch != self._wave_epoch:
            return
        first_h, done_h, toks_h, valid_h, active_h = wave.host.wait()
        self._process_admits(wave.group, wave.finals, first_h, done_h)
        self._process_chunk(toks_h, valid_h, active_h, wave.roster)

    # --- failure --------------------------------------------------------------

    def _fail_all(self, err: str, waves=()) -> None:
        """Fail every live request — slots plus the requests alive only in
        in-flight wave rosters — and rebuild the device state."""
        live: Dict[int, _Request] = {}
        for req in self._slots:
            if req is not None:
                live[req.rid] = req
        for wave in waves:
            if wave is None:
                continue
            for req in [*wave.group, *wave.roster]:
                if req is not None:
                    live[req.rid] = req
        for req in live.values():
            self._fail_req(req, err, kind="internal", retriable=True)
        self._rebuild_device_state()

    def _rebuild_device_state(self) -> None:
        self._wave_epoch += 1
        B = self.ecfg.max_slots
        self._slots = [None] * B
        self._free = list(range(B))
        self._active_host[:] = False
        self._prefilling.clear()
        self._allocator = BlockAllocator(self._num_blocks)
        with self.stats.lock:
            self.stats.pool_gauges = self._allocator.snapshot
        self._table_host[:] = 0
        for req in self._waiting:
            req.block_ids = []
        self._state = None  # free the old pool before the new one lands
        self._state = self._fresh_state()

    # --- the scheduler loop -----------------------------------------------------

    def _dispatch_once(self) -> Optional[_PendingWave]:
        self._dispatch_wreck = None
        self._reap_lifecycle()
        return self._dispatch_ragged()

    def _loop_async(self) -> None:
        """Scheduler loop under ``async_fetch``: each iteration dispatches
        ONE wave and hands it to :meth:`_fetch_loop`, so the scheduler
        never waits for the device. A wave stays in ``_inflight`` from
        its dispatch until the fetcher retires it, so the error path fails
        the requests that live only in its roster."""
        while not self._stop.is_set():
            try:
                with self._book:
                    work = self._dispatch_once()
                    if work is not None:
                        self._inflight.append(work)
            except Exception as e:  # fail requests, reset, keep serving
                logger.exception("engine dispatch failed")
                with self._book:
                    wreck, self._dispatch_wreck = self._dispatch_wreck, None
                    self._fail_all(str(e), [*self._inflight, wreck])
                continue
            if work is not None:
                # Blocks outside the lock while the queue is full; the
                # fetcher keeps draining it.
                self._fetch_q.put(work)
            elif self._pending.empty():
                time.sleep(self.ecfg.idle_sleep_s)

    def _fetch_loop(self) -> None:
        """Fetcher thread: waits for each wave's results OUTSIDE the
        bookkeeping lock (the scheduler dispatches meanwhile), then runs
        the wave's boundary under it. A wave from before a device-state
        rebuild is dropped unread."""
        while True:
            wave = self._fetch_q.get()
            if wave is None:
                return
            try:
                if wave.epoch == self._wave_epoch:
                    wave.host.wait()
                    with self._book:
                        self._process_boundary(wave)
            except Exception as e:
                logger.exception("boundary fetch failed")
                with self._book:
                    self._fail_all(str(e), [*self._inflight])
            finally:
                with self._book:
                    self._inflight = [w for w in self._inflight
                                      if w is not wave]

    def _loop_sync_ragged(self) -> None:
        """Each iteration dispatches ONE wave, then reads the previous
        one: the pipeline is one wave deep. Requests recycled out of
        _slots live in `pending` rosters and the dispatch wreck, so the
        error path fails both."""
        pending: Optional[_PendingWave] = None
        while not self._stop.is_set():
            try:
                with self._book:
                    work = self._dispatch_once()
                    if pending is not None:
                        self._process_boundary(pending)
                    pending = work
                    idle = pending is None and not self._active_host.any()
                if idle and self._pending.empty():
                    time.sleep(self.ecfg.idle_sleep_s)
            except Exception as e:  # fail requests, reset, keep serving
                logger.exception("engine iteration failed")
                with self._book:
                    wreck, self._dispatch_wreck = self._dispatch_wreck, None
                    self._fail_all(str(e), [pending, wreck])
                pending = None
        if pending is not None:
            try:
                with self._book:
                    self._process_boundary(pending)
            except Exception as e:
                logger.exception("final boundary failed")
                with self._book:
                    self._fail_all(str(e), [pending])
