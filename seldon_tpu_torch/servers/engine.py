"""Continuous-batching inference engine — port of
``seldon_tpu/servers/engine.py``, in PyTorch.

A fixed pool of ``max_slots`` slots serves every request. The KV cache
is either the dense slab ``[L, max_slots, Hkv, max_seq_len, (Dh)]`` (the
JAX engine's default) or, with ``paged_kv``, one block pool
``[L, NB, Hkv, kv_block, (Dh)]`` addressed through per-slot block tables
(host-side :class:`BlockAllocator`, block 0 the trash block). The
families of the JAX engine, each a static method that keeps its JAX
name and updates the cache in place:
 * the bucketed engine (``ragged=False``): admissions in FIFO groups of
   one prompt bucket, padded to a power of two (``_admit_impl``, warm
   ``_admit_prefix_impl``; paged ``_paged_admit_impl``), or, with
   ``chunked_prefill``, prompt chunks packed under a token budget
   (``_admit_chunk_impl`` / ``_paged_admit_chunk_impl``), each boundary
   followed by one decode chunk of 1 to ``decode_chunk`` steps
   (``_chunk_impl`` / ``_paged_chunk_impl``) whose length the adaptive
   ladder picks from the free slots;
 * the ragged wave (``ragged=True``): ONE unified wave per step
   (``models/ragged_attention.ragged_wave``) packs the prefill chunks of
   any mix of new and continuing prompts plus one decode step for every
   armed row, on the ``masked``, ``sparse`` or ``pallas`` (kernel B1)
   leg; each dispatch hands the wave the count of live block columns its
   host descriptors give, so the sparse leg never waits for the device;
 * speculative decoding (``spec_decode``, on the paged bucketed engine):
   a drafter (``servers/spec_decode.py``: the n-gram drafter, or a draft
   model passed as ``draft=(params, cfg)``) proposes up to ``spec_k``
   tokens per armed row and ONE verify wave
   (``models/spec_decode.verify_wave``, :meth:`_verify_impl`) replaces the
   decode chunk; rejected tails roll back by trimming each row's block
   table. Its loop never pipelines (:meth:`_loop_sync_spec`).

With ``prefix_cache`` the paged engines index pool block ids
(:class:`PagedPrefixIndex`: a warm admission refs matched blocks into its
table row, copies a partly matched block on the device — copy-on-write,
:meth:`_cow_copy_impl`, queued before the dispatch that writes it) and
the dense engine keeps KV copies (:class:`PrefixIndex`: a warm admission
gathers the pinned path and runs the suffix only). The bucketed and
ragged loops are software-pipelined one boundary deep: with
``async_fetch`` (the default) a fetcher thread reads each boundary's
results while the scheduler dispatches on; without it the scheduler
reads boundary N after dispatching N+1. Results come back through
asynchronous copies into pinned memory and one event per boundary.

Carried from the JAX engine: ``EngineConfig`` (every field, default and
validation), ``submit`` / ``generate_blocking`` / ``cancel`` / ``drain``
/ ``start`` / ``stop``, slot and block bookkeeping, optimistic slot
recycling, preemption on pool exhaustion, cancel / deadline reaping
(:meth:`_deactivate_impl`) and the shutdown sweep. ``ragged_block_budget``
routes a wave leg over the budget to the masked head on every leg and
device, as the JAX wave does; the other legs run B1 on the kernel leg.

Exact tensor parallelism (``tp > 1``, ``models/tp_sharding.py``) runs on
a live rank group passed as ``mesh`` (``servers/mesh_engine.py``: one
process per rank, built by ``MeshEngine``): this engine is rank 0 and
keeps every piece of host state; every device family goes through
:meth:`_run`, which sends the family's name and host arguments to the
other ranks before running it here, so every rank runs the same family
on its own shards of the weights and of the KV cache. The dense
engine's prefix cache keeps its trie here, and each rank the KV spans of
its own heads: the workers mirror every insertion and drop by node id
(``prefix_cache.KVStore``), and a warm admission names its prefix by
node ids (``prefix_cache.StoreGather``), which every rank gathers from
its own spans. Under dp a node's span is computed on one replica and
broadcast to the others at its insertion, so every rank holds every
node; the paged prefix cache moves a shared block to a replica that
reads it without holding it (``servers/dp_replicas.py``). Every process
of the engine reports its GEMM settings (``device.configure_gemms``) and
runs its column-sharded projections through ``ops/lt_gemm``; its
attention products batched over the slots and heads run at dp = 1 and
tp = 1's batch count where they were seen to differ
(``lt_gemm.whole_einsum``). Under ``attn_impl="ring"`` with an sp group
as ``mesh`` the dense admissions prefill context-parallel.

Supervised recovery and fault injection, at the JAX engine's sites on
every family: with ``heal`` (or ``HEAL=1``) a wrecked wave goes to
:meth:`_heal_recover` (``servers/supervisor.py`` classifies the cohort;
innocents fold their delivered tokens into the prompt and replay at the
front of the queue, on the same device through the same kernels), a
failed admission group to :meth:`_heal_requeue_group`, and the boundary
fetch runs under the watchdog and the token sentinel
(:meth:`_fetch_boundary`); without it a wrecked wave takes the raw
:meth:`_fail_all` path. ``chaos`` (or ``CHAOS=1``, ``servers/chaos.py``)
injects dispatch faults (:meth:`_chaos_dispatch`), allocator exhaustion,
slow and hung fetches, poisoned token ids and disconnects. :class:`EngineStats`
keeps the counters, the inter-token latency histogram and the SLO
accounting the server's metrics read, and each request's lifecycle is
retro-emitted as the JAX engine's spans (``engine.request`` / ``queued``
/ ``prefill`` / ``decode``, with ``TRACING=1``), adopting the caller's
``traceparent``.

The observatory, each part armed by its environment knob as in the JAX
engine (off: the attribute is None and the dispatch path is the raw
one): the flight recorder (``FLIGHT_RECORDER``), the compile ledger of
static-shape dispatch keys (``COMPILE_LEDGER``) with the lattice of
``servers/shape_lattice.py`` that :meth:`warmup` dispatches key by key,
per-variant boundary timing (``DISPATCH_TIMING``), device bytes by
category (``HBM_LEDGER``), the scheduler waste ledger
(``SCHED_LEDGER``), the roofline ledger (``ROOF_LEDGER``, which implies
the timing) and the pilot controller (``PILOT=1`` / ``PILOT=hold``,
which implies the sched ledger), served by the ``debug_*`` methods.
Every dispatch of a device family goes through :meth:`_note_dispatch`
under the JAX engine's key. The timings read the host clock only: a
dispatch's "device" seconds are the host's enqueue of the family (a
captured program's replay, else its eager launch of every kernel), and
a boundary's fetch is the wait on the event its host copy already
records, so no ledger adds a wait for the device.

The lattice runs as captured programs (``servers/wave_program.py``, the
JAX engine's ``jax.jit`` of it): on a single-rank engine on the kernel
or masked leg, each key of ``shape_lattice.dispatch_keys`` (each branch
of the ragged and verify waves) is a CUDA graph captured once (by
:meth:`warmup`, or at its first dispatch) and replayed at every
dispatch (:meth:`_dispatch`), holding the engine's state tensors in
place; on the CPU the same body runs on the same buffers. Rank groups,
the sparse and reference legs and ``attn_impl="ring"`` dispatch
eagerly, as does everything inside ``wave_program.disabled()``.
``TRACE_PROFILE_N`` captures ``torch.profiler`` over the first N
dispatched boundaries into ``TRACE_PROFILE_DIR``.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import os
import queue
import threading
import time
from typing import (Any, Deque, Dict, List, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from seldon_tpu_torch.core import tracing
from seldon_tpu_torch.device import (DeviceLike, configure_gemms,
                                     resolve_device)
from seldon_tpu_torch.models import ragged_attention, tp_sharding, transformer
from seldon_tpu_torch.models import spec_decode as spec_model
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.sampling import SamplingParams, sample_per_row
from seldon_tpu_torch.ops import lt_gemm
from seldon_tpu_torch.servers import (compile_ledger, controller, cost_model,
                                      dp_replicas, flight_recorder, graftsan,
                                      hbm_ledger, prefix_cache, sched_ledger,
                                      shape_lattice, supervisor,
                                      wave_program)
from seldon_tpu_torch.servers import spec_decode as spec_host
from seldon_tpu_torch.servers.block_pool import BlockAllocator
from seldon_tpu_torch.servers.chaos import ChaosConfig, ChaosMonkey
from seldon_tpu_torch.servers.prefix_cache import (PagedPrefixIndex,
                                                   PrefixHandle, PrefixIndex,
                                                   StoreGather)

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
    included). ``tp > 1`` needs a rank group (``servers/mesh_engine``)."""

    max_slots: int = 32
    max_seq_len: int = 2048
    prompt_buckets: Sequence[int] = (32, 128, 512, 1024)
    max_admit: int = 8
    decode_chunk: int = 8
    idle_sleep_s: float = 0.002
    # True: a fetcher thread waits for each wave's results and runs its
    # bookkeeping while the scheduler dispatches on (_loop_async); False:
    # the scheduler reads boundary N after dispatching N+1 (_loop_sync).
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
    # Prefix-cache match: None until the trie lookup at admission, then
    # the reused token count; the handle pins the matched path until
    # _complete.
    prefix_len: Optional[int] = None
    prefix_handle: Optional[PrefixHandle] = None
    # Every token emitted so far, in order: the drafter's history and
    # the heal supervisor's replay source (filled under spec_decode or
    # heal only).
    gen_hist: List[int] = dataclasses.field(default_factory=list)
    # How many gen_hist tokens resurrection replays folded into `tokens`.
    # The drafter's history is tokens + gen_hist[replayed:]; n_generated
    # counts tokens since the CURRENT admission, so replayed +
    # n_generated is what the client received.
    replayed: int = 0


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
    """One dispatched-but-unread boundary: its admission groups
    ``(requests, finals)`` (finals None: every row of a one-shot
    admission is armed), the slot->request roster of its decode leg (None
    when nothing decoded), the host copy of each group's (first,
    first_done) followed, when ``decoded``, by the decode leg's (toks,
    valid, active), and the device-state epoch it was dispatched
    against. A ragged wave has one group whose arrays are slot-indexed."""

    admits: List[Tuple[List[_Request], Optional[List[bool]]]]
    roster: Optional[List[Optional[_Request]]]
    host: Optional[_HostCopy]
    epoch: int
    decoded: bool = False
    # DISPATCH_TIMING's (dispatch-end stamp, wave keys, roof rider), None
    # when timing is off (_make_timing).
    timing: Optional[tuple] = None


class EngineStats:
    """The engine's counters: the JAX engine's ``EngineStats``, field for
    field. The ITL histogram, the SLO accounting, the budget utilization,
    the sched ledger's mirror (``sched_*``, ``padding_waste_frac`` and the
    per-boundary ``waste_counts`` histogram, SCHED_LEDGER=1) and the
    per-variant dispatch timing (``variant_timing``, DISPATCH_TIMING=1)
    are the JAX twin's, edge for edge, so the snapshots agree on the same
    inputs. ``prefix_seed_copies`` counts the dense engine's prefix KV
    moves and stays 0 under ``paged_kv``, as in the JAX engine.

    The port's own fields (:data:`PORT_FIELDS`) are counts the JAX
    engine keeps nowhere a reader outside it can reach:
    ``prefill_waves`` (ragged waves that ran a prefill leg: with
    ``decode_dispatches`` it gives the kernel leg's launches per layer),
    ``admit_dispatches`` / ``cold_admit_dispatches`` (one-shot admission
    groups, and those of them that ran a cold prefill — the bucketed
    path's flash-attention launches count one per layer of each cold
    group), and the speculative-decoding counters (drafted, accepted and
    rejected tokens, verify waves, the acceptance rate), which the JAX
    engine keeps in private fields and its sched ledger. The server's
    spec gauges read the sched ledger, as the JAX server's do; these
    counters stay so that acceptance can be audited without arming it."""

    def __init__(self):
        self.lock = threading.Lock()
        self.requests = 0
        self.completed = 0
        self.tokens_out = 0
        self.ttft_sum = 0.0
        self.ttft_count = 0
        # Decode dispatches (decode chunks, verify waves, ragged waves)
        # and the decode steps they ran; the ragged waves that ran a
        # prefill leg (the kernel leg skips it on decode-only waves).
        self.decode_dispatches = 0
        self.decode_steps = 0
        self.prefill_waves = 0
        self.admit_dispatches = 0
        self.cold_admit_dispatches = 0
        self.spec_drafted_tokens = 0
        self.spec_accepted_tokens = 0
        self.spec_rejected_tokens = 0
        self.spec_verify_waves = 0
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
        # Per-variant dispatch timing (DISPATCH_TIMING=1; empty otherwise),
        # keyed by the compile-ledger string ("admit/64/4"): dispatch end
        # to boundary processed, host wall time, on the ITL's idiom.
        self.dispatch_edges_ms = (0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
                                  100.0, 200.0, 500.0)
        self.variant_ms = {}
        # The sched ledger's mirror (SCHED_LEDGER=1; zero otherwise), and
        # each dispatched boundary's padding fraction bucketed.
        self.sched_boundaries = 0
        self.sched_idle_boundaries = 0
        self.sched_useful_tokens = 0
        self.sched_bucket_pad_tokens = 0
        self.sched_group_pad_tokens = 0
        self.sched_frag_tokens = 0
        self.waste_edges_frac = (0.01, 0.02, 0.05, 0.10, 0.20, 0.35,
                                 0.50, 0.75)
        self.waste_counts = [0] * (len(self.waste_edges_frac) + 1)

    def record_waste_locked(self, frac: float) -> None:
        """Caller holds self.lock. One dispatched boundary's padding
        fraction (pad cells / offered cells) from the sched ledger."""
        i = 0
        for edge in self.waste_edges_frac:
            if frac <= edge:
                break
            i += 1
        self.waste_counts[i] += 1
        self.sched_boundaries += 1

    def record_variant_locked(self, key: str, ms: float) -> None:
        """Caller holds self.lock. One boundary duration for `key`."""
        h = self.variant_ms.get(key)
        if h is None:
            h = {"count": 0, "sum_ms": 0.0,
                 "counts": [0] * (len(self.dispatch_edges_ms) + 1)}
            self.variant_ms[key] = h
        i = 0
        for edge in self.dispatch_edges_ms:
            if ms <= edge:
                break
            i += 1
        h["counts"][i] += 1
        h["count"] += 1
        h["sum_ms"] += ms

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
            offered = (self.sched_useful_tokens + self.sched_bucket_pad_tokens
                       + self.sched_group_pad_tokens)
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
                "decode_steps": self.decode_steps,
                "prefill_waves": self.prefill_waves,
                "admit_dispatches": self.admit_dispatches,
                "cold_admit_dispatches": self.cold_admit_dispatches,
                "spec_drafted_tokens": self.spec_drafted_tokens,
                "spec_accepted_tokens": self.spec_accepted_tokens,
                "spec_rejected_tokens": self.spec_rejected_tokens,
                "spec_verify_waves": self.spec_verify_waves,
                "spec_acceptance_rate": (
                    self.spec_accepted_tokens / self.spec_drafted_tokens
                    if self.spec_drafted_tokens else 0.0),
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
                "sched_boundaries": self.sched_boundaries,
                "sched_idle_boundaries": self.sched_idle_boundaries,
                "sched_useful_tokens": self.sched_useful_tokens,
                "sched_bucket_pad_tokens": self.sched_bucket_pad_tokens,
                "sched_group_pad_tokens": self.sched_group_pad_tokens,
                "sched_frag_tokens": self.sched_frag_tokens,
                "padding_waste_frac": (
                    (self.sched_bucket_pad_tokens
                     + self.sched_group_pad_tokens) / offered
                    if offered else 0.0),
                "waste_edges_frac": list(self.waste_edges_frac),
                "waste_counts": list(self.waste_counts),
                "dispatch_edges_ms": list(self.dispatch_edges_ms),
                "variant_timing": {
                    k: {"count": h["count"], "sum_ms": h["sum_ms"],
                        "counts": list(h["counts"])}
                    for k, h in self.variant_ms.items()
                },
            }


PORT_FIELDS = frozenset({
    "prefill_waves", "admit_dispatches", "cold_admit_dispatches",
    "spec_drafted_tokens", "spec_accepted_tokens", "spec_rejected_tokens",
    "spec_verify_waves", "spec_acceptance_rate"})


def _set_rows(state: Dict[str, Any], slots: torch.Tensor,
              **rows: torch.Tensor) -> Dict[str, Any]:
    """A new state dict with ``state[key][slots] = rows[key]`` for each
    given per-slot field (the JAX ``.at[slots].set``). Duplicate slots
    (admission padding rows) carry identical values."""
    out = dict(state)
    idx = slots.long()
    for key, val in rows.items():
        out[key] = state[key].index_put((idx,), val.to(state[key].dtype))
    return out


def _first_done(first: torch.Tensor, max_news: torch.Tensor,
                plens: torch.Tensor, Smax: int,
                cfg: ModelConfig) -> torch.Tensor:
    """An admission's first token ends its request: EOS, a one-token
    budget, or no room left in the window."""
    return ((first == cfg.eos_token_id) | (max_news <= 1)
            | (plens + 1 >= Smax))


def _decode_step_carry(state: Dict[str, Any], cache, logits: torch.Tensor,
                       Smax: int, cfg: ModelConfig):
    """The decode chunk's step body after the model: sample every row with
    its sequential key (seed, pos + 1), freeze finished rows by value
    (EOS, spent budget, window end). Returns (state, tok [B], run [B])."""
    run = state["active"]
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
    return {
        **state,
        "cache": cache,
        "last_tok": torch.where(run, tok, state["last_tok"]),
        "pos": pos,
        "active": state["active"] & ~done,
        "remaining": remaining,
    }, tok, run


def _cache_writes(kv: Dict[str, torch.Tensor], cfg: ModelConfig,
                  dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Fresh KV {"k","v"} in cache storage form (int8 codes + bf16 scales
    for an int8 cache)."""
    if cfg.kv_cache_dtype == "int8":
        kq, ksc = transformer._quantize_kv(kv["k"])
        vq, vsc = transformer._quantize_kv(kv["v"])
        return {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
    return {"k": kv["k"].to(dtype), "v": kv["v"].to(dtype)}


def _scatter_dense(cache: Dict[str, torch.Tensor],
                   writes: Dict[str, torch.Tensor], slots: torch.Tensor,
                   spos: torch.Tensor) -> None:
    """Dense-cache scatter of per-token writes [L, G, Hkv, S, (Dh)] at
    (slots[g], spos[g, s]), IN PLACE. Positions past the window keep the
    cache's value there, as the JAX scatter drops them."""
    T = cache["k"].shape[3]
    rows = slots.long()[:, None]
    col = torch.clamp(spos, max=T - 1).long()
    inside = spos < T
    for key in cache:
        new = writes[key].movedim((1, 3), (0, 1)).to(cache[key].dtype)
        keep = inside.view(*inside.shape, *([1] * (new.dim() - 2)))
        old = cache[key][:, rows, :, col]  # [G, S, L, Hkv, (Dh)]
        cache[key][:, rows, :, col] = torch.where(keep, new, old)


def _scalar(i: int) -> np.ndarray:
    """A slot or block number as a family's host argument: one int32
    (``[1]``), a device scalar once dispatched."""
    return np.array([i], np.int32)


def _device_index(i, device: torch.device) -> torch.Tensor:
    """A family's slot or block number (a device scalar, or an int) as a
    ``[1]`` index on ``device``."""
    if isinstance(i, torch.Tensor):
        return i.reshape(1).long()
    return torch.tensor([int(i)], device=device)


def init_state(cfg: ModelConfig, max_slots: int, max_seq_len: int,
               pages: Optional[Tuple[int, int]], device: torch.device,
               tp=None, cache_slots: Optional[int] = None
               ) -> Dict[str, Any]:
    """A fresh engine state: the KV cache (the paged pool of
    ``pages = (num_blocks, kv_block)``, or the dense slab) and the
    per-slot fields. Under ``tp`` the cache is allocated at this rank's
    shard shape (Hkv / tp heads) directly: a full cache per rank would be
    a transient the card may not hold. ``cache_slots``: the dense slab's
    rows when they are fewer than the slots (a dp replica's block,
    ``servers/dp_replicas.py``)."""
    B = max_slots
    if pages is not None:
        cache = transformer.init_paged_cache(cfg, pages[0], pages[1],
                                             device, tp=tp)
    else:
        cache = transformer.init_cache(cfg, cache_slots or B, max_seq_len,
                                       device=device, tp=tp)

    state = {"cache": cache}
    for key, (dtype, fill) in _FIELDS.items():
        state[key] = torch.full((B,), fill, dtype=dtype, device=device)
    if tp is not None:
        tp.constrain_state(state, cfg)
    return state


# The per-slot fields of a fresh state: (dtype, fill). Seeds are uint32
# values held in int64 (torch's uint32 has few ops).
_FIELDS = {
    "last_tok": (torch.int32, 0),
    "pos": (torch.int32, 0),
    "active": (torch.bool, False),
    "temp": (torch.float32, 1.0),
    "top_k": (torch.int32, 0),
    "top_p": (torch.float32, 1.0),
    "seeds": (torch.int64, 0),
    "remaining": (torch.int32, 0),
}


def reset_state(state: Dict[str, Any]) -> None:
    """``state`` back to :func:`init_state`'s values, in place: the
    recovery of an engine whose captured programs hold its tensors'
    addresses (``servers/wave_program.py``)."""
    transformer.reset_cache(state["cache"])
    for key, (_, fill) in _FIELDS.items():
        state[key].fill_(fill)


def state_of(cfg: ModelConfig, geometry: tuple, device: torch.device,
             tp=None) -> Dict[str, Any]:
    """:func:`init_state` of an engine's geometry
    (``InferenceEngine._state_geometry``: slots, window, pool, slab
    rows)."""
    max_slots, max_seq_len, pages, rows = geometry
    return init_state(cfg, max_slots, max_seq_len, pages, device, tp,
                      cache_slots=rows)


def check_tp_attention(cfg: ModelConfig, tp: int, sp: int) -> None:
    """Refuse an attention family exact tp does not thread: flash (as
    JAX's exact tp), and the ring unless the plan has an 'sp' axis
    beside 'tp' (``sp`` > 1) for it to run over."""
    if cfg.attn_impl == "flash" or (cfg.attn_impl == "ring" and sp <= 1):
        raise ValueError(
            f"tp={tp} is not supported with attn_impl={cfg.attn_impl!r}: "
            f"only the xla attention family is tp-threaded, and the ring "
            f"on a group whose plan has an 'sp' axis beside 'tp'")


# The device families by name: InferenceEngine's static impls and the
# ragged wave. A rank group's workers run them by these names.
FAMILIES = frozenset({
    "_admit_impl", "_admit_prefix_impl", "_admit_chunk_impl",
    "_seed_prefix_impl", "_chunk_impl", "_paged_admit_impl",
    "_paged_admit_chunk_impl", "_paged_chunk_impl", "_deactivate_impl",
    "_cow_copy_impl", "_verify_impl", "ragged_wave"})
# Families of the state alone (no weights, no config).
_STATE_ONLY = frozenset({"_deactivate_impl", "_cow_copy_impl",
                         "_seed_prefix_impl"})


def run_family(name: str, params, state: Dict[str, Any], args: Sequence,
               kw: Dict[str, Any], cfg: ModelConfig, tp=None,
               rows: Tuple[int, int] = (1, 1)) -> tuple:
    """Run device family ``name`` on ``(params, state)``: ``args`` are its
    positional inputs after the state (tensors on the state's device),
    ``kw`` its keywords; weight families also get ``cfg`` and ``tp``.
    ``rows``: a dp replica's (mine, total) items of the whole batch
    (``dp_replicas.Cut.items``), under whose ``lt_gemm.row_share`` the
    family's products run. Returns the family's outputs as a tuple, the
    new state first."""
    if name not in FAMILIES:
        raise ValueError(f"unknown device family {name!r}")
    with lt_gemm.row_share(*rows):
        if name in _STATE_ONLY:
            out = getattr(InferenceEngine, name)(state, *args, **kw)
        else:
            fn = (ragged_attention.ragged_wave if name == "ragged_wave"
                  else getattr(InferenceEngine, name))
            out = fn(params, state, *args, cfg=cfg, tp=tp, **kw)
    return out if isinstance(out, tuple) else (out,)


def check_f32_gemms(cfg: ModelConfig, device: torch.device,
                    gemms: Dict[str, Any]) -> None:
    """Refuse a float32 model on the card in a process whose f32 matmuls
    may run in TF32 (``gemms``: ``device.configure_gemms()``): the model
    would quietly compute with ~10 mantissa bits instead of the f32 the
    JAX package computes. The port sets no such flag; the caller does."""
    if cfg.dtype == "float32" and device.type == "cuda" and gemms["tf32"]:
        raise ValueError(
            "a float32 model on the card needs f32 matmuls: this process "
            "has torch.backends.cuda.matmul.allow_tf32 set, which runs "
            "them in TF32")


class InferenceEngine:
    """Slot-based continuous batching over one model on one device, or,
    with ``mesh`` (a live rank group: ``servers/mesh_engine.py``), over
    the group: this process is rank 0 and keeps every piece of host
    state; every device family it dispatches (:meth:`_run`) is sent to
    the group's other ranks first, which run it on their shards (under a
    dp axis each replica on its own slots: ``servers/dp_replicas.py``)."""

    def __init__(
        self,
        params: transformer.Transformer,
        cfg: ModelConfig,
        engine_cfg: Optional[EngineConfig] = None,
        device: DeviceLike = None,
        draft: Optional[Tuple[transformer.Transformer, ModelConfig]] = None,
        mesh=None,
    ):
        self.cfg = transformer.check_supported(cfg)
        self.ecfg = engine_cfg or EngineConfig()
        ec = self.ecfg
        # The projection GEMM tp = 2 shares with tp = 1 (device.py).
        gemms = configure_gemms()
        # Exact tensor parallelism (EngineConfig.tp > 1;
        # models/tp_sharding.py): the gate is the CONFIG field. ``mesh``
        # is the live rank group (servers/mesh_engine.MeshGroup) and
        # ``params`` this rank's shard; self._tp threads the hints through
        # every family, and tp=1 leaves it None and every family unhinted.
        self._mesh = mesh
        # Every family goes through the group when it has more than one
        # rank (whatever its plan); _dp is its dp axis (one replica
        # otherwise).
        self._grouped = mesh is not None and mesh.world > 1
        self._dp = mesh.dp if self._grouped else 1
        self._tp = None
        if ec.tp > 1:
            tp_sharding.validate(self.cfg, ec.tp)
            check_tp_attention(self.cfg, ec.tp,
                               mesh.sp if mesh is not None else 1)
            self._tp = (mesh.hints(ec.tp) if mesh is not None
                        else tp_sharding.hints(None, ec.tp))
        if self._dp > 1:
            dp_replicas.check_slots(ec.max_slots, self._dp)
        # Context-parallel prefill: with attn_impl == "ring" and a rank
        # group with an sp axis, dense admissions prefill with the
        # sequence sharded across the ranks (ring attention; under tp
        # each sp rank passes its own KV heads).
        self._ring = (mesh.sp_ranks if mesh is not None
                      and self.cfg.attn_impl == "ring" else None)
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        check_f32_gemms(self.cfg, self.device, gemms)
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
        # EngineConfig's validation makes ragged imply paged + chunked.
        self._paged = bool(ec.paged_kv)
        self._chunked = bool(ec.chunked_prefill)
        self._ragged = bool(ec.ragged)
        self._spec = bool(ec.spec_decode)
        self._kernel = ec.ragged_kernel
        self._allocator: Optional[BlockAllocator] = None
        self._holders: Dict[int, set] = {}
        self._paged_prefix: Optional[PagedPrefixIndex] = None
        self._prefix: Optional[PrefixIndex] = None
        if self._paged:
            self._kv_block = ec.kv_block
            self._nbs = Smax // self._kv_block  # block-table width
            # Default pool: the dense slab's token budget (B * Smax) plus
            # the reserved trash block.
            self._num_blocks = ec.kv_pool_blocks or B * self._nbs + 1
            self._allocator = self._new_allocator()
            self._table_host = np.zeros((B, self._nbs), np.int32)
            if ec.prefix_cache:
                # The trie indexes pool BLOCK IDS, so a warm hit refs
                # cached blocks into the new slot's table (zero-copy).
                self._paged_prefix = self._new_prefix_index()
        elif ec.prefix_cache:
            # The dense engine's trie holds KV copies per block.
            self._prefix = self._new_dense_index()
        # Largest power of two <= min(max_admit, max_slots).
        ma = max(1, min(ec.max_admit, B))
        self._max_admit = 1 << (ma.bit_length() - 1)
        self._prefill_chunk = min(ec.prefill_chunk, max(self._buckets))
        # Chunk lengths are bucketed like prompts, clamped to the chunk.
        self._chunk_buckets = tuple(sorted(
            {min(b, self._prefill_chunk) for b in self._buckets}
            | {self._prefill_chunk}))
        if self._ragged:
            self._ragged_chunk = min(ec.ragged_chunk or self._prefill_chunk,
                                     max(self._buckets))
        # The decode chunk ladder: min / geometric mid / top, or the one
        # fixed length without adaptive_chunk.
        top = max(1, ec.decode_chunk)
        if ec.adaptive_chunk and top > ec.min_chunk:
            lo = max(1, min(ec.min_chunk, top))
            mid = 1 << int(round((lo * top) ** 0.5)).bit_length() - 1
            sizes = [lo, mid, top]
        else:
            sizes = [top]
        self._chunk_sizes = tuple(sorted(set(sizes)))
        self._async_fetch = bool(ec.async_fetch)
        self._drafter = None
        self._draft_cfg: Optional[ModelConfig] = None
        if self._spec:
            # Rollback trims block tables the next wave sizes its growth
            # from, so the spec loop processes every boundary before the
            # next dispatch.
            self._async_fetch = False
            # The pow2 k ladder 1..spec_k.
            self._spec_rungs = tuple(1 << i
                                     for i in range(ec.spec_k.bit_length()))
            self._spec_window = min(64, Smax)
            if draft is not None:
                dparams, dcfg = draft
                self._draft_cfg = transformer.check_supported(dcfg)
                draft = (dparams, self._draft_cfg)
            self._drafter = spec_host.make_drafter(
                draft, self._spec_window, self.cfg.pad_token_id)
            # The verify rung the last boundary flew (the pilot may move
            # it inside the ladder).
            self._spec_k_live = self._spec_rungs[-1]
            # Acceptance accounting (host, under _book).
            self._spec_drafted = 0
            self._spec_accepted = 0
            self._spec_waves = 0
            # The in-flight wave's (k, wave mask, n_wave) between dispatch
            # and _spec_post_process.
            self._spec_wave = None

        self._state = self._fresh_state()
        # The lattice's captured programs (servers/wave_program.py) on a
        # single-rank engine off the ring; used on the legs of
        # wave_program.CAPTURED_LEGS (:meth:`_captured`).
        self._programs: Optional[wave_program.Programs] = (
            wave_program.Programs(self.device)
            if not self._grouped and self._tp is None
            and self.cfg.attn_impl != "ring" else None)
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
        if self._paged:
            self.stats.pool_gauges = self._allocator.snapshot
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # Deterministic fault injection (opt-in; CHAOS=1 arms it without
        # config plumbing).
        chaos_cfg = ec.chaos or ChaosConfig.from_env()
        self._chaos: Optional[ChaosMonkey] = None
        if chaos_cfg is not None and chaos_cfg.any_enabled():
            self._chaos = ChaosMonkey(chaos_cfg)
            logger.warning("chaos fault injection enabled: %s", chaos_cfg)
        # Supervised recovery (opt-in; HEAL=1 arms it too). None keeps the
        # raw _fail_all failure path.
        self._heal: Optional[supervisor.HealSupervisor] = supervisor.build(ec)
        if self._heal is not None:
            logger.warning("supervised recovery enabled: %s",
                           self._heal.describe())
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
        self._build_observatory()
        # Runtime concurrency sanitizer (GRAFTSAN=1; None, and no code on
        # any hot path, otherwise). It wraps every lock above in an
        # order-asserting proxy, so it stays the LAST piece of engine
        # state __init__ builds.
        self._san = graftsan.instrument(self)

    def _build_observatory(self) -> None:
        """The env-gated ledgers (the JAX engine's ``__init__`` tail): each
        is None when its knob is off, and every dispatch site keeps its
        raw, untimed call on the off path."""
        ec = self.ecfg
        self._recorder = flight_recorder.from_env()
        # TRACE_PROFILE_N: torch.profiler over the first N dispatched
        # boundaries (0 = off), exported as a Chrome trace under
        # TRACE_PROFILE_DIR.
        self._profile_n = int(os.environ.get("TRACE_PROFILE_N", "0") or 0)
        self._profile_dir = os.environ.get("TRACE_PROFILE_DIR",
                                           "seldon-torch-profile")
        self._profile_count = 0
        self._profiler = None
        self._cledger = compile_ledger.from_env()
        if self._cledger is not None and self._grouped:
            # One lattice serves the whole group: every rank runs the
            # same family per key (a dp replica its cut), so the keys and
            # the sealed lattice are one device's; the snapshot carries
            # the group's geometry.
            self._cledger.set_mesh(ec.tp, self._mesh.world)
        self._timing_on = os.environ.get(
            "DISPATCH_TIMING", "0") in ("1", "true", "True")
        # The roofline is the timing join: ROOF_LEDGER implies
        # DISPATCH_TIMING.
        self._roof = cost_model.from_env()
        if self._roof is not None:
            self._timing_on = True
            platform = (torch.cuda.get_device_name(self.device)
                        if self.device.type == "cuda" else self.device.type)
            # Per chip: a dp replica's families run on its B / dp slots.
            self._roof.bind(
                self.cfg, max_slots=ec.max_slots // self._dp,
                max_seq_len=ec.max_seq_len,
                kv_block=self._kv_block if self._paged else 0,
                ragged_chunk=self._ragged_chunk if self._ragged else 0,
                draft_cfg=self._draft_cfg, platform=platform,
                tp=ec.tp if self._tp is not None else 1,
                device=self.device)
        self._observe = self._cledger is not None or self._timing_on
        # Keys dispatched since the last boundary, and the roofline's
        # step-entry stamp and the wave's summed dispatch seconds (the
        # scheduler thread writes them between dispatch and boundary).
        self._wave_keys: List[Tuple[Any, ...]] = []
        self._step_t0 = 0.0
        self._wave_enq_s = 0.0
        self._hbm = hbm_ledger.from_env()
        if self._hbm is not None:
            # The cache's shapes are fixed for the engine's life (a
            # rebuild allocates the same), so its size is taken once: the
            # bytes every device of the group holds, each rank's cache
            # the size of this rank's (under tp alone: the logical
            # cache, tp shards of this rank's).
            world = self._mesh.world if self._grouped else 1
            self._kv_reserved = world * sum(
                t.numel() * t.element_size()
                for t in self._state["cache"].values())
            if not self._grouped:
                self._hbm.set_static("weights", self._hbm_weights_bytes())
                self._hbm.gauge("kv_cache", self._hbm_kv_reserved_bytes)
                self._hbm.gauge("kv_live", self._hbm_kv_live_bytes)
            else:
                # Per-device accounting over the group (every device of
                # the plan's world): weights priced from this rank's
                # shard shapes (replicated leaves whole, sharded leaves
                # their slice; every rank's are the same size), the group
                # total devices x per-device; every rank's cache is the
                # size of this rank's, so per-device = total // world.
                self._hbm.set_devices(world)
                per_dev = self._hbm_weights_device_bytes()
                self._hbm.set_static("weights", per_dev * world,
                                     per_device=per_dev)
                self._hbm.gauge(
                    "kv_cache", self._hbm_kv_reserved_bytes,
                    per_device_fn=lambda:
                        self._hbm_kv_reserved_bytes() // world)
                self._hbm.gauge(
                    "kv_live", self._hbm_kv_live_bytes,
                    per_device_fn=lambda:
                        self._hbm_kv_live_bytes() // world)
            self._hbm.gauge("prefix_cache", self._hbm_prefix_bytes)
        self._sled = sched_ledger.from_env()
        # The pilot reads its signals from the sched ledger: PILOT implies
        # one even without SCHED_LEDGER=1.
        self._pilot = controller.from_env()
        if self._pilot is not None:
            if self._sled is None:
                self._sled = sched_ledger.SchedLedger()
            self._pilot.bind(
                chunked=self._chunked,
                prefill_chunk=self._prefill_chunk if self._chunked else 0,
                max_slots=ec.max_slots, max_admit=self._max_admit,
                dispatch_token_budget=ec.dispatch_token_budget,
                spec=self._spec,
                spec_rungs=self._spec_rungs if self._spec else ())

    # --- device state -------------------------------------------------------

    def _state_geometry(self) -> tuple:
        """The arguments of :func:`init_state` after the config: slots,
        window, pool, and the dense slab's rows (a dp replica's block;
        None for all the slots)."""
        rows = (self.ecfg.max_slots // self._dp
                if self._dp > 1 and not self._paged else None)
        return (self.ecfg.max_slots, self.ecfg.max_seq_len,
                (self._num_blocks, self._kv_block) if self._paged else None,
                rows)

    def _fresh_state(self) -> Dict[str, Any]:
        """A fresh state on this rank; in a group every worker builds its
        own (its shard under tp, its replica's cache under dp: the JAX
        engine's shard_state site). A group that lost a rank rebuilds
        rank 0's alone: its next dispatch raises the loss, so every
        request fails with it."""
        geometry = self._state_geometry()

        def local():
            return state_of(self.cfg, geometry, self.device, self._tp)

        if not self._grouped:
            return local()
        return self._mesh.new_state(geometry, local)

    def _run(self, name: str, *args, **kw) -> tuple:
        """Run device family ``name`` on this rank's weights and state and
        keep the new state; returns the family's other outputs. Host
        arrays (numpy) among ``args`` become tensors on the engine's
        device here, and a :class:`StoreGather` the trie spans it names.
        In a group every worker runs the same family on its shards with
        the same host arguments (a StoreGather from its own spans; a
        ``ring`` keyword, a context-parallel admission of :meth:`_admit`,
        its own sp group); under dp each replica runs its cut
        (:meth:`_run_dp`)."""
        if self._dp > 1:
            return self._run_dp(name, args, kw)
        dargs = self._dargs(args)

        def local():
            return run_family(name, self.params, self._state, dargs, kw,
                              self.cfg, self._tp)

        out = (self._mesh.family(name, args, kw, local) if self._grouped
               else local())
        self._state = out[0]
        return out[1:]

    def _captured(self) -> bool:
        """Whether this dispatch runs the family as a captured program:
        a single-rank engine (not on the ring) on a captured leg, outside
        ``wave_program.disabled()``."""
        return (self._programs is not None
                and self._kernel in wave_program.CAPTURED_LEGS
                and wave_program.enabled())

    def _program_body(self, name: str, kw: Dict[str, Any]):
        """The body of family ``name``'s program: :func:`run_family`, as
        the eager route runs it."""
        def body(state, *tensors):
            return run_family(name, self.params, state, tensors, kw,
                              self.cfg)
        return body

    def _dispatch(self, key: Tuple[Any, ...], name: str, args: Sequence,
                  fresh: int = 0, branch: Tuple[str, ...] = (),
                  **kw) -> tuple:
        """Run device family ``name`` at lattice key ``key`` and keep the
        new state; returns the family's other outputs. On a captured
        engine (:meth:`_captured`) as the program of ``(key, branch)``
        (``branch``: the host-side choices its keywords make), captured
        at its first run and replayed after; its first ``fresh`` outputs
        are copied out of the program's static buffers, which its next
        run overwrites. Otherwise eagerly (:meth:`_run`). ``args`` are
        host arrays and :class:`StoreGather` s; every dispatch site of a
        family goes through here."""
        if not self._captured():
            return self._run(name, *args, **kw)
        captures = self._programs.captures
        self._state, outs = self._programs.run(
            (key, branch), self._program_body(name, kw), self._state,
            [self._prefix.resolve(a, self._state["cache"])
             if isinstance(a, StoreGather) else a for a in args])
        if self._programs.captures != captures:
            self._note_pool()
        return tuple(o.clone() if i < fresh else o
                     for i, o in enumerate(outs))

    def _note_pool(self) -> None:
        """The HBM ledger's ``graph_pool``, on the card: the bytes the
        programs' shared graph pool holds, noted after a capture and a
        release (a static category: no replay changes it)."""
        if self._hbm is not None and self.device.type == "cuda":
            self._hbm.set_static("graph_pool", self._programs.pool_bytes())

    def _ragged_warm(self) -> List[np.ndarray]:
        """The ragged wave's trash descriptors (the JAX engine's warm
        recipe): every row idle, its start at the window's end so every
        KV write lands in the trash block, one new token each."""
        B, C, Smax = (self.ecfg.max_slots, self._ragged_chunk,
                      self.ecfg.max_seq_len)
        return [np.zeros((B, self._nbs), np.int32),
                np.zeros((B * C,), np.int32), np.ones((B,), np.int32),
                np.full((B,), Smax, np.int32), np.zeros((B,), np.int64),
                np.ones((B,), np.float32), np.zeros((B,), np.int32),
                np.ones((B,), np.float32), np.ones((B,), np.int32),
                np.zeros((B,), bool), np.zeros((B,), bool)]

    def _wave_key(self, kw: Dict[str, Any]) -> Tuple[Any, ...]:
        """A ragged wave's program key: its lattice key and the branch
        its keywords take (``ragged_attention.wave_branch``)."""
        return (("ragged", self._ragged_chunk), ragged_attention.wave_branch(
            kw["kernel"], kw["block_budget"], kw["has_prefill"],
            kw["live_blocks"], self._nbs))

    def _wave_kws(self) -> Dict[Tuple[Any, ...], Dict[str, Any]]:
        """One ragged wave's keywords per program key its config can
        reach: with and without a prefill leg, each leg at one live
        block column and at the table's width."""
        out: Dict[Tuple[Any, ...], Dict[str, Any]] = {}
        for has_prefill in (False, True):
            for live in itertools.product((1, self._nbs), repeat=2):
                kw = dict(kernel=self._kernel,
                          block_budget=self.ecfg.ragged_block_budget,
                          has_prefill=has_prefill, live_blocks=live)
                out.setdefault(self._wave_key(kw), kw)
        return out

    def _verify_kws(self, k: int) -> Dict[Tuple[Any, ...], Dict[str, Any]]:
        """One verify wave's keywords at rung ``k`` per program key its
        config can reach: the pool walk at one live block column and at
        the table's width (``spec_decode.verify_branch``)."""
        out: Dict[Tuple[Any, ...], Dict[str, Any]] = {}
        for n_live in (1, self._nbs):
            out.setdefault(self._verify_key(k, n_live), dict(
                kernel=self._kernel,
                block_budget=self.ecfg.ragged_block_budget, n_live=n_live))
        return out

    def _verify_key(self, k: int, n_live: int) -> Tuple[Any, ...]:
        return (("verify", k), spec_model.verify_branch(
            self._kernel, self.ecfg.ragged_block_budget, n_live, self._nbs))

    def _ragged_wave(self, args: Sequence[np.ndarray], **kw) -> tuple:
        """One ragged wave."""
        key, branch = self._wave_key(kw)
        return self._dispatch(key, "ragged_wave", args, branch=branch, **kw)

    def _deactivate(self, keep: np.ndarray) -> None:
        """Freeze the rows ``keep`` drops."""
        self._dispatch(("deactivate",), "_deactivate_impl", [keep])

    def _dargs(self, args: Sequence) -> list:
        """A family's arguments on this rank: host arrays on the device,
        a :class:`StoreGather` the trie spans it names."""
        return [self._d(a) if isinstance(a, np.ndarray)
                else self._prefix.resolve(a, self._state["cache"])
                if isinstance(a, StoreGather) else a for a in args]

    def _run_dp(self, name: str, args: Sequence, kw: Dict[str, Any]
                ) -> tuple:
        """:meth:`_run` over dp replicas (``servers/dp_replicas.py``):
        each replica with live rows runs its cut of the family on its
        view of the state (this rank replica 0's); the replicas' leaders
        send their slots' fields and outputs here, which become this
        rank's per-slot fields and the whole batch's outputs. A family's
        KV writes for the dense trie stay on each replica
        (``dp_replicas.RowWrites``)."""
        B = self.ecfg.max_slots
        active = self._state["active"].cpu().numpy()
        cuts = {}
        for d in range(self._dp):
            c = dp_replicas.cut(name, args, kw,
                                *dp_replicas.slot_range(d, B, self._dp),
                                active)
            if c is not None:
                cuts[d] = c

        def local(c):
            return run_family(name, self.params, dp_replicas.sub_state(
                self._state, c.lo, c.hi), self._dargs(c.args), c.kw,
                self.cfg, self._tp, c.items)

        mine, theirs = self._mesh.family_dp(name, cuts, local)
        writes = dp_replicas.has_writes(name, kw)
        blocks, pieces, local_writes = [], {}, None
        if mine is not None:
            self._state = dict(self._state, cache=mine[0]["cache"])
            blocks.append((cuts[0].lo, cuts[0].hi, mine[0]))
            pieces[0] = mine[1:-1] if writes else mine[1:]
            local_writes = mine[-1] if writes else None
        for d, (fields, outs) in theirs.items():
            blocks.append((cuts[d].lo, cuts[d].hi,
                           {k: self._d(v) for k, v in fields.items()}))
            pieces[d] = [self._d(o) for o in outs]
        self._state = dp_replicas.put_fields(self._state, blocks)
        out = dp_replicas.merge(name, args, kw, cuts, pieces, B,
                                self.cfg.pad_token_id, self.device)
        if writes:
            out += (dp_replicas.row_writes(cuts, local_writes),)
        return out

    def _admit(self, toks: np.ndarray, *args, **kw) -> tuple:
        """The dense admission (``_admit_impl``) at its key ``("admit",
        Sb, G)``, its first tokens and first-done flags copied out:
        context-parallel over the sp ranks when the engine has a ring and
        the bucket splits evenly over it (a static per-bucket decision,
        as in JAX)."""
        if self._ring is not None and toks.shape[1] % self._ring.world == 0:
            kw = dict(kw, ring=self._ring)
        return self._dispatch(("admit", toks.shape[1], toks.shape[0]),
                              "_admit_impl", [toks, *args], fresh=2, **kw)

    def _new_dense_index(self) -> PrefixIndex:
        """The dense trie. Under tp its nodes hold this rank's spans,
        charged at the group's width (the global bytes), and every drop
        is queued for the workers' stores (:meth:`_store_sync`)."""
        self._store_ops: List[tuple] = []
        self._store_lock = threading.Lock()
        if not self._grouped:
            return PrefixIndex(block=self.ecfg.prefix_block,
                               byte_budget=self.ecfg.prefix_cache_bytes)

        def dropped(ids):
            with self._store_lock:
                self._store_ops.extend(("drop", nid) for nid in ids)

        return PrefixIndex(block=self.ecfg.prefix_block,
                           byte_budget=self.ecfg.prefix_cache_bytes,
                           byte_scale=self.ecfg.tp, on_drop=dropped)

    def _trie_insert(self, tokens, writes, row: int, off: int,
                     handle) -> int:
        """Insert ``tokens``' full blocks into the dense trie; a new block
        at prompt positions [s, e) is ``[s - off, e - off)`` of row
        ``row`` of ``writes`` (the last family's cache-dtype KV
        ``[L, G, Hkv, S, (Dh)]``), copied out so the node holds its own
        span. Under tp the workers copy the same span from their own
        ``writes``; under dp (``writes`` a ``dp_replicas.RowWrites``) the
        ranks of the replica that ran the row do, and the node's span is
        filled from them at :meth:`_store_sync` when that replica is not
        this rank's. Returns the number of nodes evicted."""
        owner, src = 0, writes
        if isinstance(writes, dp_replicas.RowWrites):
            owner, row = int(writes.owner[row]), int(writes.index[row])
            src = writes.local if owner == 0 else None

        def get_span(s, e):
            if src is None:
                return prefix_cache.span_like(self._state["cache"], e - s)
            return {key: w[:, row, :, s - off:e - off].clone()
                    for key, w in src.items()}

        def new(nid, s, e):
            with self._store_lock:
                self._store_ops.append(("put", nid, row, s - off, e - off,
                                        owner))

        return self._prefix.insert(
            tokens, get_span, handle=handle,
            on_new=new if self._grouped else None)

    def _store_sync(self) -> None:
        """Send the queued store operations (puts of the last family's
        spans, drops) to the workers, in the order rank 0 made them."""
        if not self._grouped or self._prefix is None:
            return
        with self._store_lock:
            ops, self._store_ops = self._store_ops, []
        if not ops:
            return
        if self._dp == 1:
            self._mesh.store(ops)
            return
        like = self._state["cache"]

        def local():
            # Rank 0's part of the spans' broadcasts: a node dropped since
            # its put still takes part, through a scratch span.
            puts = [(op[5], self._prefix.arrays_of(op[1])
                     or prefix_cache.span_like(like, op[4] - op[3]))
                    for op in ops if op[0] == "put"]
            return prefix_cache.share_spans(
                self._mesh.axes.group("dp"), 0, puts) if puts else 0

        self._mesh.store(ops, local)

    def _new_allocator(self) -> BlockAllocator:
        """The pool's allocator; a block it frees leaves the holders."""
        return BlockAllocator(self._num_blocks,
                              on_free=lambda bid: self._holders.pop(bid,
                                                                    None))

    def _new_prefix_index(self) -> PagedPrefixIndex:
        """The paged trie over the current allocator, with no block held
        by any replica yet (``_holders``: under dp, pool block id -> the
        replicas whose pool holds its KV)."""
        self._holders = {}
        return PagedPrefixIndex(block=self.ecfg.prefix_block,
                                kv_block=self._kv_block,
                                allocator=self._allocator)

    def _replica(self, slot: int) -> int:
        return dp_replicas.replica_of(slot, self.ecfg.max_slots, self._dp)

    def _fetch_blocks(self, slot: int, bids: Sequence[int]) -> None:
        """Under dp: move every trie block of ``bids`` that the replica of
        ``slot`` does not hold to it from a holder, before the dispatch
        that reads it (one move per holder, in the group's stream
        order); the replica then holds it too."""
        d = self._replica(slot)
        need: Dict[int, List[int]] = {}
        for bid in dict.fromkeys(bids):
            held = self._holders.get(bid)
            if not held:
                raise RuntimeError(f"trie block {bid} has no holder replica")
            if d not in held:
                need.setdefault(min(held), []).append(bid)
        cache = self._state["cache"]
        group = self._mesh
        for src, moved in sorted(need.items()):
            group.move_blocks(src, d, moved, lambda: dp_replicas.move_blocks(
                cache, group.axes.group("dp"), 0, src, d, moved))
            for bid in moved:
                self._holders[bid].add(d)

    # --- the device families (the JAX engine's jitted impls) ---------------
    #
    # Each keeps its JAX name and argument order; host arrays arrive as
    # tensors on the engine's device. The per-slot fields of the state
    # are replaced (``_set_rows``), the cache is written IN PLACE.

    @staticmethod
    @torch.no_grad()
    def _admit_impl(params, state, toks, plens, seeds, temps, top_ks,
                    top_ps, max_news, slots, *, cfg, return_sub=False,
                    ring=None, tp=None):
        """Fused admission on the dense slab: prefill [G, Sb] (under
        ``attn_impl="flash"`` through the flash kernel), scatter into the
        slots' cache rows, sample first tokens keyed (seed, plen), arm the
        slots. Duplicate slot indices (admission padding rows) carry
        identical data, so the duplicate writes are well-defined. With
        ``return_sub`` also the cache-dtype KV [L, G, Hkv, Sb, (Dh)] for
        the prefix trie. ``ring`` (an sp rank group, under
        ``attn_impl="ring"``): context-parallel prefill when the bucket
        splits evenly over the ranks, else the plain one (a static
        per-bucket decision, as in JAX)."""
        G, Sb = toks.shape
        if ring is not None and Sb % ring.world:
            ring = None
        sub = transformer.init_cache(cfg, G, Sb, device=toks.device, tp=tp)
        logits, sub = transformer.prefill(params, toks, plens, sub, cfg,
                                          ring=ring, tp=tp)
        first = sample_per_row(logits, seeds, plens, temps, top_ks, top_ps)
        cache = state["cache"]
        first_done = _first_done(first, max_news, plens, cache["k"].shape[3],
                                 cfg)
        idx = slots.long()
        for key in cache:
            cache[key][:, idx, :, :Sb] = sub[key]
        new_state = _set_rows(
            state, slots, last_tok=first, pos=plens, active=~first_done,
            temp=temps, top_k=top_ks, top_p=top_ps, seeds=seeds,
            remaining=max_news - 1)
        if tp is not None:
            tp.constrain_state(new_state, cfg)
        if return_sub:
            return new_state, first, first_done, sub
        return new_state, first, first_done

    @staticmethod
    @torch.no_grad()
    def _admit_prefix_impl(params, state, toks, plens, prefix_lens,
                           prefix_kv, seeds, temps, top_ks, top_ps, max_news,
                           slots, *, cfg, tp=None):
        """Fused WARM admission on the dense slab: suffix-only prefill
        against the reused prefix KV ``prefix_kv`` [L, G, Hkv, Pb, (Dh)]
        (gathered from the trie, zero-padded past each row's prefix),
        prefix and suffix scattered into the slots, first tokens sampled
        with the cold path's keys (``plens`` are FULL prompt lengths).
        Returns the suffix writes too, for the trie."""
        G, Sq = toks.shape
        logits, kv = transformer.prefill_with_prefix(
            params, toks, plens, prefix_kv, prefix_lens, cfg, tp)
        first = sample_per_row(logits, seeds, plens, temps, top_ks, top_ps)
        cache = state["cache"]
        first_done = _first_done(first, max_news, plens, cache["k"].shape[3],
                                 cfg)
        writes = _cache_writes(kv, cfg, cache["k"].dtype)
        Pb = prefix_kv["k"].shape[3]
        idx = slots.long()
        for key in cache:
            cache[key][:, idx, :, :Pb] = prefix_kv[key].to(cache[key].dtype)
        spos = prefix_lens[:, None] + torch.arange(
            Sq, device=toks.device)[None, :]
        _scatter_dense(cache, writes, slots, spos)
        new_state = _set_rows(
            state, slots, last_tok=first, pos=plens, active=~first_done,
            temp=temps, top_k=top_ks, top_p=top_ps, seeds=seeds,
            remaining=max_news - 1)
        if tp is not None:
            tp.constrain_state(new_state, cfg)
        return new_state, first, first_done, writes

    @staticmethod
    @torch.no_grad()
    def _admit_chunk_impl(params, state, toks, plens, starts, seeds, temps,
                          top_ks, top_ps, max_news, slots, finals, *,
                          prefix_width, cfg, return_sub=False, tp=None):
        """Fused prefill CHUNK on the dense slab: tokens [start, start+Sc)
        of each prompt against the KV its earlier chunks (and any trie
        seed) left in the slot, the fresh KV scattered back. Final rows
        sample the first token with the one-shot key and arm the slot;
        the others only deposit KV. ``pos`` is set to start + Sc (clamped
        to plen), so a decode chunk between two prefill chunks scribbles
        only where the next chunk writes first. ``prefix_width`` buckets
        the resident KV the chunk attends to."""
        G, Sc = toks.shape
        cache = state["cache"]
        Smax = cache["k"].shape[3]
        idx = slots.long()
        prefix_kv = {key: cache[key][:, idx, :, :prefix_width]
                     for key in cache}
        logits, kv = transformer.prefill_with_prefix(
            params, toks, plens, prefix_kv, starts, cfg, tp)
        first = sample_per_row(logits, seeds, plens, temps, top_ks, top_ps)
        first_done = _first_done(first, max_news, plens, Smax, cfg)
        new_pos = torch.minimum(plens, starts + Sc)
        writes = _cache_writes(kv, cfg, cache["k"].dtype)
        spos = starts[:, None] + torch.arange(Sc, device=toks.device)[None, :]
        _scatter_dense(cache, writes, slots, spos)
        new_state = _set_rows(
            state, slots, last_tok=first, pos=new_pos,
            active=finals & ~first_done, temp=temps, top_k=top_ks,
            top_p=top_ps, seeds=seeds, remaining=max_news - 1)
        if tp is not None:
            tp.constrain_state(new_state, cfg)
        if return_sub:
            return new_state, first, first_done, writes
        return new_state, first, first_done

    @staticmethod
    @torch.no_grad()
    def _seed_prefix_impl(state, prefix_kv, slot):
        """Chunked-prefill warm start on the dense slab: write a trie hit's
        KV [L, Hkv, W, (Dh)] into the slot's rows [0, W). ``slot`` is a
        device scalar (``[1]`` int32, JAX's traced scalar), so one program
        serves every slot; an int is taken too."""
        cache = state["cache"]
        W = prefix_kv["k"].shape[2]
        idx = _device_index(slot, cache["k"].device)
        for key in cache:
            cache[key][:, idx, :, :W] = prefix_kv[key].to(
                cache[key].dtype)[:, None]
        return state

    @staticmethod
    @torch.no_grad()
    def _chunk_impl(params, state, *, cfg, n_steps, tp=None):
        """``n_steps`` decode steps over every slot of the dense slab.
        Per-row termination is value-level: finished rows stop advancing
        and emit invalid tokens until the chunk ends (inactive rows still
        write at their frozen ``pos``, as in the JAX chunk). Nothing here
        waits for the device. Returns (state, toks [K, B], valid [K, B],
        active [B])."""
        Smax = state["cache"]["k"].shape[3]
        toks, valid = [], []
        for _ in range(n_steps):
            logits, cache = transformer.decode_step(
                params, state["last_tok"], state["pos"], state["cache"], cfg,
                tp)
            state, tok, run = _decode_step_carry(state, cache, logits, Smax,
                                                 cfg)
            toks.append(tok)
            valid.append(run)
        if tp is not None:
            tp.constrain_state(state, cfg)
        return state, torch.stack(toks), torch.stack(valid), state["active"]

    @staticmethod
    @torch.no_grad()
    def _paged_admit_impl(params, state, table, toks, plens, prefix_lens,
                          seeds, temps, top_ks, top_ps, max_news, slots, *,
                          prefix_width, cfg, tp=None):
        """Paged fused admission, cold and warm. ``prefix_width == 0``
        (cold): the full-prompt prefill of :meth:`_admit_impl` (the flash
        kernel under ``attn_impl="flash"``), its writes scattered through
        the group's block tables. ``prefix_width > 0`` (warm): the reused
        prefix is a gather of the table's first prefix_width / kv_block
        blocks (the blocks a zero-copy admission refs from the trie) fed
        to ``prefill_with_prefix``. Positions past a row's blocks route
        to the trash block."""
        G, Sb = toks.shape
        pool = state["cache"]
        block = pool["k"].shape[3]
        Smax = table.shape[1] * block
        if prefix_width:
            prefix_kv = transformer.paged_prefix_view(
                pool, table, prefix_width // block)
            logits, kv = transformer.prefill_with_prefix(
                params, toks, plens, prefix_kv, prefix_lens, cfg, tp)
            writes = _cache_writes(kv, cfg, pool["k"].dtype)
            spos = prefix_lens[:, None] + torch.arange(
                Sb, device=toks.device)[None, :]
        else:
            sub = transformer.init_cache(cfg, G, Sb, device=toks.device,
                                         tp=tp)
            logits, writes = transformer.prefill(params, toks, plens, sub,
                                                 cfg, tp=tp)
            spos = torch.arange(Sb, device=toks.device)[None, :].expand(
                G, Sb)
        first = sample_per_row(logits, seeds, plens, temps, top_ks, top_ps)
        first_done = _first_done(first, max_news, plens, Smax, cfg)
        transformer.paged_scatter_tokens(pool, writes, table, spos)
        new_state = _set_rows(
            state, slots, last_tok=first, pos=plens, active=~first_done,
            temp=temps, top_k=top_ks, top_p=top_ps, seeds=seeds,
            remaining=max_news - 1)
        if tp is not None:
            tp.constrain_state(new_state, cfg)
        return new_state, first, first_done

    @staticmethod
    @torch.no_grad()
    def _paged_admit_chunk_impl(params, state, table, toks, plens, starts,
                                seeds, temps, top_ks, top_ps, max_news,
                                slots, finals, *, prefix_width, cfg,
                                tp=None):
        """Paged twin of :meth:`_admit_chunk_impl`: the resident KV of the
        earlier chunks (and any zero-copy warm prefix) is a block-table
        gather of each row's first prefix_width / kv_block blocks, and
        the chunk's KV scatters back through the table."""
        G, Sc = toks.shape
        pool = state["cache"]
        block = pool["k"].shape[3]
        Smax = table.shape[1] * block
        prefix_kv = transformer.paged_prefix_view(pool, table,
                                                  prefix_width // block)
        logits, kv = transformer.prefill_with_prefix(
            params, toks, plens, prefix_kv, starts, cfg, tp)
        first = sample_per_row(logits, seeds, plens, temps, top_ks, top_ps)
        first_done = _first_done(first, max_news, plens, Smax, cfg)
        new_pos = torch.minimum(plens, starts + Sc)
        writes = _cache_writes(kv, cfg, pool["k"].dtype)
        spos = starts[:, None] + torch.arange(Sc, device=toks.device)[None, :]
        transformer.paged_scatter_tokens(pool, writes, table, spos)
        new_state = _set_rows(
            state, slots, last_tok=first, pos=new_pos,
            active=finals & ~first_done, temp=temps, top_k=top_ks,
            top_p=top_ps, seeds=seeds, remaining=max_news - 1)
        if tp is not None:
            tp.constrain_state(new_state, cfg)
        return new_state, first, first_done

    @staticmethod
    @torch.no_grad()
    def _paged_chunk_impl(params, state, table, *, cfg, n_steps, tp=None):
        """Paged twin of :meth:`_chunk_impl`: ``n_steps`` steps of
        ``transformer.paged_decode_step`` reading K/V through the block
        tables. Inactive rows' writes route through table entry 0 (the
        trash block) once the host zeroes a freed row."""
        Smax = table.shape[1] * state["cache"]["k"].shape[3]
        toks, valid = [], []
        for _ in range(n_steps):
            logits, pool = transformer.paged_decode_step(
                params, state["last_tok"], state["pos"], state["cache"],
                table, cfg, tp)
            state, tok, run = _decode_step_carry(state, pool, logits, Smax,
                                                 cfg)
            toks.append(tok)
            valid.append(run)
        if tp is not None:
            tp.constrain_state(state, cfg)
        return state, torch.stack(toks), torch.stack(valid), state["active"]

    @staticmethod
    def _deactivate_impl(state, keep):
        """Freeze rows where ``keep`` is False (cancel / deadline reap):
        dropping ``active`` and zeroing ``remaining`` leaves the row as
        one that just hit EOS."""
        return {
            **state,
            "active": state["active"] & keep,
            "remaining": torch.where(keep, state["remaining"], 0),
        }

    @staticmethod
    def _cow_copy_impl(state: Dict[str, Any], src, dst) -> Dict[str, Any]:
        """Copy-on-write block copy: duplicate pool block `src` into
        `dst` in every cache array (k/v and int8 scales), in place. The
        block ids are device scalars (``[1]`` int32, JAX's traced
        scalars), so one program serves every copy; ints are taken too.
        On the card the copy is queued on the stream BEFORE the dispatch
        that writes into `dst`, and `src` is pinned by the request's
        trie handle, so stream order makes it race-free."""
        for arr in state["cache"].values():
            arr.index_copy_(1, _device_index(dst, arr.device),
                            arr.index_select(1, _device_index(
                                src, arr.device)))
        return state

    @staticmethod
    def _verify_impl(params, state, table, drafts, wave, *, cfg,
                     kernel="masked", block_budget=0,
                     n_live: Optional[int] = None, tp=None):
        """One verify wave (``models/spec_decode.verify_wave``) in place of
        up to k + 1 decode steps; the k rung is the drafts' width. Returns
        the decode chunk's contract (toks / valid [k+1, B], True-prefix
        columns) and the active mask."""
        state, toks, valid = spec_model.verify_wave(
            params, state, table, drafts, wave, cfg, kernel=kernel,
            block_budget=block_budget, n_live=n_live, tp=tp)
        if tp is not None:
            tp.constrain_state(state, cfg)
        return state, toks, valid, state["active"]

    def _cow(self, src: int, dst: int, rid: int = -1) -> None:
        """Copy-on-write block copy; every call site (warmup and live)
        funnels through here, so the ledger sees one "cow" key."""
        t0 = time.perf_counter() if self._observe else 0.0
        self._dispatch(("cow",), "_cow_copy_impl",
                       [_scalar(src), _scalar(dst)])
        if self._observe:
            self._note_dispatch(("cow",), rid, time.perf_counter() - t0)

    def _d(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device. A copy from pageable
        memory would wait for the stream (the previous dispatch); from a
        pinned copy it is queued behind it."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _host_copy(self, tensors: Sequence[torch.Tensor]) -> _HostCopy:
        """Start the device->host copies of one boundary's results NOW,
        so they are queued right behind its work and ahead of the next."""
        if self.device.type != "cuda":
            return _HostCopy([t.detach().clone() for t in tensors], None)
        bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in tensors]
        for buf, t in zip(bufs, tensors):
            buf.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _HostCopy(bufs, event)

    # --- static shape lattice --------------------------------------------------

    def lattice_spec(self) -> shape_lattice.LatticeSpec:
        """The shape-relevant slice of this engine's config, as consumed
        by ``servers/shape_lattice.py`` (the JAX engine's, field for
        field)."""
        chunked = self._chunked
        return shape_lattice.LatticeSpec(
            buckets=self._buckets,
            max_seq_len=self.ecfg.max_seq_len,
            max_slots=self.ecfg.max_slots,
            max_admit=self._max_admit,
            decode_rungs=self._chunk_sizes,
            paged=self._paged,
            chunked=chunked,
            prefix=(self._prefix is not None
                    or self._paged_prefix is not None),
            prefix_block=self.ecfg.prefix_block,
            chunk_buckets=self._chunk_buckets if chunked else (),
            prefill_chunk=self._prefill_chunk if chunked else 0,
            token_budget=(
                self.ecfg.dispatch_token_budget or self._prefill_chunk
            ) if chunked else 0,
            ragged=self._ragged,
            ragged_chunk=self._ragged_chunk if self._ragged else 0,
            spec=self._spec,
            spec_rungs=self._spec_rungs if self._spec else (),
            spec_draft=self._draft_cfg is not None,
        )

    def static_lattice(self) -> List[str]:
        """Key strings of every variant live scheduling can dispatch, in
        warmup order — the /debug/compile "declared" set."""
        keys = shape_lattice.dispatch_keys(self.lattice_spec())
        return [compile_ledger.key_str(k)
                for k in shape_lattice.warmup_order(keys)]

    def warmup(self) -> None:
        """Dispatch every key of the static shape lattice once, in
        ``warmup_order`` (the JAX engine's ahead-of-time compiles): each
        family runs on zero-filled inputs of the key's shapes whose rows
        finish at once and whose KV writes land in the trash block, so no
        slot state leaks; on the card the first dispatch builds the CUDA
        kernels the family launches (B1 on the kernel leg of the ragged
        and verify waves, B2 in the bucketed cold prefill under
        ``attn_impl="flash"``). A captured engine (:meth:`_captured`)
        captures every program its config can reach instead: one per
        key, one per branch of ``("ragged", C)`` (:meth:`_wave_kws`) and
        of ``("verify", k)`` (:meth:`_verify_kws`), so the ledger's
        compile time of a key is its capture and instantiation (and one
        replay, but for the ragged wave's); ``_programs.captures`` counts
        every capture (none after warmup unless the programs were
        released). With the compile
        ledger armed every key is declared first and the lattice sealed
        after, so a key live traffic dispatches outside it is a live
        retrace. Call before start()."""
        keys = shape_lattice.warmup_order(
            shape_lattice.dispatch_keys(self.lattice_spec()))
        if self._cledger is not None:
            for key in keys:
                self._cledger.declare(key)
        for key in keys:
            self._warm_key(key)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # Warmup's dispatches belong to no boundary.
        self._wave_keys = []
        self._wave_enq_s = 0.0
        if self._cledger is not None:
            self._cledger.warmup_done()
        logger.info("engine warmed: %d lattice variants across %d families",
                    len(keys), len({k[0] for k in keys}))

    def _warm_key(self, key: Tuple[Any, ...]) -> None:
        """Dispatch ONE lattice key on zero-filled inputs of its static
        shapes (the JAX engine's ``_warm_key``): max_new = 1 everywhere,
        so every row finishes at its first token; tables all point at the
        trash block; prefix lengths and starts are clamped into the
        window. A family with host-side branches runs each branch its
        config can reach (the verify wave's); on a captured engine the
        ragged wave's branches are prepared (captured) without a run."""
        kind = key[0]
        B, Smax = self.ecfg.max_slots, self.ecfg.max_seq_len
        t0 = time.perf_counter() if self._observe else 0.0

        def knobs(G):
            return (np.zeros((G,), np.int64), np.ones((G,), np.float32),
                    np.zeros((G,), np.int32), np.ones((G,), np.float32),
                    np.ones((G,), np.int32), np.arange(G, dtype=np.int32))

        def full(G, v):
            return np.full((G,), v, np.int32)

        def zeros(*shape, dtype=np.int32):
            return np.zeros(shape, dtype)

        if kind == "decode":
            # _dispatch_decode_chunk notes its own key.
            self._dispatch_decode_chunk(key[1])
            return
        if kind == "cow" and self._paged:
            self._cow(0, 0)  # notes its own key
            return
        if kind == "deactivate":
            self._deactivate(np.ones((B,), bool))
        elif kind == "admit" and not self._paged:
            _, Sb, G = key
            self._admit(zeros(G, Sb), full(G, 1), *knobs(G),
                        return_sub=self._prefix is not None)
        elif kind == "admit-prefix" and self._prefix is not None:
            _, Pb, Sb, G = key
            pref = min(Pb, Smax - 1)
            # Rows of no trie nodes: zero prefix KV on every rank's heads.
            pkv = StoreGather(rows=((),) * G, pad_to=Pb, stack=True)
            self._dispatch(key, "_admit_prefix_impl", [
                zeros(G, Sb), full(G, pref + 1), full(G, pref), pkv,
                *knobs(G)])
        elif kind == "admit-paged" and self._paged:
            _, Sb, G, W = key
            pref = min(W, Smax - 1)
            self._dispatch(key, "_paged_admit_impl", [
                zeros(G, self._nbs), zeros(G, Sb), full(G, pref + 1),
                full(G, pref), *knobs(G)], prefix_width=W)
        elif kind == "ragged" and self._ragged and self._captured():
            # Every branch the config can reach, captured (the JAX
            # engine's one compile holds them all).
            for pkey, kw in self._wave_kws().items():
                self._programs.prepare(
                    pkey, self._program_body("ragged_wave", kw),
                    self._state, self._ragged_warm())
            self._state = self._programs.state()
            self._note_pool()
        elif kind == "ragged" and self._ragged:
            for kw in self._wave_kws().values():
                self._run("ragged_wave", *self._ragged_warm(), **kw)
        elif kind == "chunk" and self._chunked:
            _, Sc, G, W = key
            start = min(W, Smax - Sc)
            args = [zeros(G, Sc), full(G, start + Sc), full(G, start),
                    *knobs(G), np.ones((G,), bool)]
            if self._paged:
                self._dispatch(key, "_paged_admit_chunk_impl",
                               [zeros(G, self._nbs), *args], prefix_width=W)
            else:
                self._dispatch(key, "_admit_chunk_impl", args,
                               prefix_width=W,
                               return_sub=self._prefix is not None)
        elif kind == "seed-prefix" and self._prefix is not None:
            self._dispatch(key, "_seed_prefix_impl", [StoreGather(
                rows=((),), pad_to=key[1], stack=False), _scalar(0)])
        elif kind == "verify" and self._spec:
            for (_, branch), kw in self._verify_kws(key[1]).items():
                self._dispatch(key, "_verify_impl", [
                    zeros(B, self._nbs), zeros(B, key[1]),
                    zeros(B, dtype=bool)], branch=branch, **kw)
        elif kind == "draft" and self._draft_cfg is not None:
            self._drafter.draft_batch([], key[1], B, self._draft_programs())
        else:
            raise ValueError(
                f"lattice key {key!r} has no warm recipe for this config — "
                f"shape_lattice.dispatch_keys and _warm_key have drifted")
        if self._observe:
            self._note_dispatch(key, -1, time.perf_counter() - t0)

    def _draft_programs(self) -> Optional[wave_program.Programs]:
        """The programs a model drafter's ``("draft", k)`` runs as on a
        captured engine (stateless: no state, no write-back); None
        otherwise."""
        return self._programs if self._captured() else None

    # --- the observatory's taps ---------------------------------------------

    def _note_dispatch(self, key: Tuple[Any, ...], rid: int,
                       seconds: float) -> None:
        """The tap behind every dispatch of a device family (the warmup
        caller or the scheduler thread: the ledgers' single writer); the
        call sites take their perf_counter pair only when ``_observe``,
        so the off path stays raw."""
        if self._cledger is not None:
            witness = self._cledger.dispatch(key, rid, seconds)
            if witness is not None:
                logger.warning(
                    "live retrace: variant %s first dispatched in %.1f ms on "
                    "the serving path (rid=%d)", witness["key"],
                    witness["compile_ms"], rid)
                if self._recorder is not None:
                    self._recorder.record("retrace", rid, witness)
        if self._timing_on:
            self._wave_keys.append(key)
            if self._roof is not None:
                # Dispatch seconds are the roofline's device component;
                # the host-pre residue is the step span minus them.
                self._wave_enq_s += seconds

    def _noted(self, key: Tuple[Any, ...], rid: int, t0: float,
               toks: np.ndarray, rows: int) -> None:
        """The admission and chunk families' tap: the dispatch's key, and
        its transient footprint (the token array and f32 logits rows) in
        the HBM ledger's workspace watermark."""
        if self._observe:
            self._note_dispatch(key, rid, time.perf_counter() - t0)
        if self._hbm is not None:
            self._hbm.note_workspace(int(toks.nbytes)
                                     + rows * self.cfg.vocab_size * 4)

    def _make_timing(self):
        """The boundary's timing token, built at dispatch end: (stamp,
        wave keys, roof rider); the rider (host_pre_s, dispatch_s) is
        None when the roof ledger is off."""
        now = time.perf_counter()
        rider = None
        if self._roof is not None:
            enq = self._wave_enq_s
            rider = (max(0.0, now - self._step_t0 - enq), enq)
            self._wave_enq_s = 0.0
        keys = self._wave_keys
        self._wave_keys = []
        return (now, keys, rider)

    def _record_wave_timing(self, timing) -> None:
        """Per-variant boundary timing: the wave's keys against the
        dispatch -> boundary-processed wall time, into EngineStats and one
        flight-recorder "dispatch" record per key."""
        if timing is None:
            return
        t0, keys = timing[0], timing[1]
        if not keys:
            return
        ms = 1000.0 * (time.perf_counter() - t0)
        with self.stats.lock:
            for key in keys:
                self.stats.record_variant_locked(compile_ledger.key_str(key),
                                                 ms)
        if self._recorder is not None:
            for key in keys:
                self._recorder.record(
                    "dispatch", -1,
                    {"variant": compile_ledger.key_str(key),
                     "ms": round(ms, 3)})

    def _roof_note_boundary(self, timing, f0: float, f1: float) -> None:
        """Close one boundary's step decomposition (host-pre from the
        dispatch rider; device = the wave's dispatch seconds + the wait
        on the boundary's host-copy event, f0 -> f1; host-post = the
        bookkeeping after it; overlap = the pipelined gap), join the
        wave's keys with the device time and audit, as the JAX engine's
        ``_roof_note_boundary``."""
        t0, keys, rider = timing
        if rider is None:
            return
        f2 = time.perf_counter()
        host_pre_s, enq_s = rider
        fetch_s = max(0.0, f1 - f0)
        gap_s = max(0.0, f0 - t0)
        post_s = max(0.0, f2 - f1)
        device_s = enq_s + fetch_s
        span_s = host_pre_s + enq_s + max(0.0, f2 - t0)
        self._roof.note_step(1000.0 * host_pre_s, 1000.0 * device_s,
                             1000.0 * post_s, 1000.0 * span_s)
        if keys:
            self._roof.note_wave(keys, 1000.0 * device_s)
        self._roof.audit()
        if self._recorder is not None:
            self._recorder.record(
                "roof", -1,
                {"pre_ms": round(1000.0 * host_pre_s, 3),
                 "enq_ms": round(1000.0 * enq_s, 3),
                 "gap_ms": round(1000.0 * gap_s, 3),
                 "fetch_ms": round(1000.0 * fetch_s, 3),
                 "post_ms": round(1000.0 * post_s, 3)})

    def _profile_tick(self) -> None:
        """TRACE_PROFILE_N window: start ``torch.profiler`` at the first
        dispatched boundary and stop it after N, exporting a Chrome trace
        under TRACE_PROFILE_DIR (scheduler thread, outside ``_book``)."""
        from torch.profiler import ProfilerActivity, profile

        if self._profiler is None:
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._profiler = profile(activities=acts)
            self._profiler.__enter__()
            if self._recorder is not None:
                self._recorder.record("profile-start", -1,
                                      {"dir": self._profile_dir})
        self._profile_count += 1
        if self._profile_count >= self._profile_n:
            self._profile_stop()

    def _profile_stop(self) -> None:
        prof, self._profiler = self._profiler, None
        self._profile_n = 0  # window done; ticks stop
        if prof is None:
            return
        prof.__exit__(None, None, None)
        os.makedirs(self._profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            self._profile_dir, f"engine-{os.getpid()}.trace.json"))
        if self._recorder is not None:
            self._recorder.record(
                "profile-stop", -1,
                {"dir": self._profile_dir,
                 "boundaries": self._profile_count})

    # --- debug surfaces -------------------------------------------------------

    def debug_timeline(self) -> Optional[Dict[str, Any]]:
        """Flight-recorder snapshot, or None when FLIGHT_RECORDER is off —
        the /debug/timeline payload."""
        if self._recorder is None:
            return None
        return self._recorder.snapshot()

    def debug_compile(self) -> Optional[Dict[str, Any]]:
        """Compile-ledger snapshot, or None when COMPILE_LEDGER is off —
        the /debug/compile payload."""
        if self._cledger is None:
            return None
        return self._cledger.snapshot()

    def debug_hbm(self) -> Optional[Dict[str, Any]]:
        """HBM-ledger snapshot, or None when HBM_LEDGER is off — the
        /debug/hbm payload."""
        if self._hbm is None:
            return None
        return self._hbm.snapshot()

    def debug_sched(self) -> Optional[Dict[str, Any]]:
        """Sched-ledger snapshot, or None when SCHED_LEDGER (and PILOT) is
        off — the /debug/sched payload."""
        if self._sled is None:
            return None
        return self._sled.snapshot()

    def debug_pilot(self) -> Optional[Dict[str, Any]]:
        """Pilot snapshot, or None when PILOT is off — the /debug/pilot
        payload. The controller's state is scheduler state, so the
        snapshot takes ``_book``."""
        if self._pilot is None:
            return None
        with self._book:
            return self._pilot.snapshot()

    def debug_roof(self) -> Optional[Dict[str, Any]]:
        """Roofline snapshot, or None when ROOF_LEDGER is off — the
        /debug/roof payload."""
        if self._roof is None:
            return None
        return self._roof.snapshot()

    def roof_predict_ms(self, prompt_len: int,
                        max_new: int) -> Optional[float]:
        """The cost model's roofline estimate for one request at this
        engine's geometry, or None when ROOF_LEDGER is off."""
        if self._roof is None:
            return None
        return self._roof.predict_request_ms(prompt_len, max_new)

    def _hbm_weights_bytes(self) -> int:
        """Bytes of every parameter and buffer of the model (int8 codes
        and their scales included), each tensor once."""
        seen, total = set(), 0
        for t in (*self.params.parameters(), *self.params.buffers()):
            if id(t) not in seen:
                seen.add(id(t))
                total += t.numel() * t.element_size()
        return total

    def _hbm_weights_device_bytes(self) -> int:
        """Per-device resident weight bytes: this rank's leaves at their
        shard shapes (the whole model at tp=1). Shape metadata only."""
        return self._hbm_weights_bytes()

    def _hbm_kv_reserved_bytes(self) -> int:
        """The KV reservation: every tensor of the cache (dense slab or
        paged pool, int8 scales included)."""
        return self._kv_reserved

    def _hbm_kv_live_bytes(self) -> int:
        """The reservation's bytes holding request state: used blocks
        (paged) or occupied slots (dense), prorated over the reservation
        (snapshot path only: the allocator's and ``_book``'s locks are
        taken cold here)."""
        total = self._hbm_kv_reserved_bytes()
        if self._paged:
            snap = self._allocator.snapshot()
            return total * snap["used"] // max(1, snap["total"])
        return total * self.slots_busy() // max(1, self.ecfg.max_slots)

    def _hbm_prefix_bytes(self) -> int:
        """The dense prefix trie's KV copies (outside the slab); the paged
        trie shares pool blocks already counted in kv_live."""
        if self._prefix is None:
            return 0
        return int(self._prefix.snapshot()["bytes"])

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
        if self._paged:
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
        out_q = (queue.Queue() if self._san is None
                 else graftsan.TerminalQueue(self._san))
        req = _Request(0, [int(t) for t in tokens], params, out_q, now)
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
        if self._recorder is not None:
            self._recorder.record(
                "submit", req.rid,
                {"prompt_tokens": len(req.tokens), "deadline_ms": ttl_ms})
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
        if self._recorder is not None and not self._draining.is_set():
            self._recorder.record("drain", -1, {"timeout_s": timeout})
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
                    and (self._heal is None or self._heal.pen_empty())
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
            if self._heal is not None and not self._heal.pen_empty():
                leaks["heal_pen"] = sorted(
                    r.rid for r in self._heal.pen_scan())
            # Retained prefixes are cache: drop them, so that what stays
            # pinned (or in use) is a leak.
            index = self._paged_prefix or self._prefix
            if index is not None:
                index.flush()
                if index.n_nodes:
                    leaks["trie_pins"] = index.n_nodes
            if self._paged:
                snap = self._allocator.snapshot()
                if snap["used"]:
                    leaks["pool_blocks"] = snap
        return leaks

    def chaos_counts(self) -> Dict[str, int]:
        """Injected-fault counters (all zero when chaos is off)."""
        return self._chaos.snapshot() if self._chaos is not None else {
            "dispatch_faults": 0, "alloc_faults": 0,
            "slow_boundaries": 0, "disconnects": 0,
            "nan_injects": 0, "hangs": 0, "sticky_faults": 0,
        }

    def debug_health(self) -> Optional[Dict[str, Any]]:
        """The heal supervisor's snapshot for /debug/health (None when
        HEAL is off: the raw failure path is in effect)."""
        return self._heal.snapshot() if self._heal is not None else None

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
            loop = self._loop_sync
            if self._async_fetch:
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
        if self._profiler is not None:
            # The TRACE_PROFILE_N window is still open: flush it.
            self._profile_stop()
        self._shutdown_sweep()
        if self._programs is not None:
            # Free the graphs and their pool (a process that builds many
            # engines would keep every pool otherwise).
            self._programs.release()
            self._note_pool()

    # --- queue and request lifecycle ----------------------------------------

    def _drain_pending(self) -> None:
        while True:
            try:
                self._waiting.append(self._pending.get_nowait())
            except queue.Empty:
                break
        if self._pilot is not None:
            # EDF ordering (stable; an already-ordered queue comes back as
            # the same object).
            self._waiting = self._pilot.order_queue(self._waiting)
        with self.stats.lock:
            self.stats.queue_depth = len(self._waiting)

    def _admit_cap(self) -> int:
        """Admission group-size cap: the pilot's live value when flying,
        the config's otherwise."""
        if self._pilot is not None:
            return self._pilot.admit_cap()
        return self._max_admit

    def _shed_expired_head(self) -> bool:
        """EDF pop-time re-check (pilot callers only): fail the queue's
        head if it already missed its deadline, before it claims a slot,
        blocks or budget, and return True so the caller looks again."""
        req = self._waiting[0]
        now = time.perf_counter()
        if req.deadline is None or now < req.deadline:
            return False
        self._waiting.popleft()
        with self.stats.lock:
            self.stats.deadline_expired_total += 1
            self.stats.shed_total += 1
        self._fail_req(
            req,
            f"deadline exceeded after "
            f"{1000.0 * (now - req.submitted_at):.0f} ms in queue",
            kind="deadline")
        self._pilot.note_expired_pop()
        return True

    def _pilot_signals(self) -> Dict[str, float]:
        """The pilot's cumulative signal sample (the controller's
        signal_snapshot schema): sched-ledger counters, the SLO mirror,
        queue and slot levels, and the heal supervisor's recovery
        pressure (0.0 when HEAL is off)."""
        sled = self._sled.snapshot()
        with self.stats.lock:
            budget_dispatches = self.stats.budget_dispatches
            expired = self.stats.deadline_expired_total
            met = self.stats.deadline_met_total
            missed = self.stats.deadline_missed_total
        finished = met + missed
        return {
            "boundaries": sled["dispatch_boundaries"],
            "dispatch_cells": sled["dispatch_cells"],
            "useful_tokens": sled["useful_tokens"],
            "frag_tokens": sled["frag_tokens"],
            "budget_dispatches": budget_dispatches,
            "budget_starved_passes": sled["budget_starved_passes"],
            "budget_offered_tokens": sled["budget_offered_tokens"],
            "budget_used_tokens": sled["budget_used_tokens"],
            "pool_stall_events": sled["pool_stall_events"],
            "preemptions": sled["preemptions"],
            "deadline_expired": expired,
            "goodput": met / finished if finished else 1.0,
            "queue_depth": len(self._waiting),
            "free_slots": len(self._free),
            "spec_drafted": sled["spec"]["drafted_tokens"],
            "spec_accepted": sled["spec"]["accepted_tokens"],
            "roof_backlog_ms": self._roof_backlog_ms(),
            "heal_pressure": (
                self._heal.pressure() if self._heal is not None else 0.0),
        }

    def _roof_backlog_ms(self) -> float:
        """The cost model's predicted time (ms) of everything queued; 0.0
        when the roof ledger is off."""
        if self._roof is None:
            return 0.0
        total = 0.0
        for req in self._waiting:
            total += self._roof.predict_request_ms(
                len(req.tokens), req.params.max_new_tokens)
        return round(total, 3)

    def _pilot_tick(self) -> None:
        """One pilot boundary: advance the control loop and mirror its
        decisions into the flight recorder."""
        decisions = self._pilot.on_boundary(self._pilot_signals)
        if self._recorder is not None:
            for dec in decisions:
                self._recorder.record(
                    "pilot", -1,
                    {"knob": dec["knob"], "old": dec["old"],
                     "new": dec["new"], "rationale": dec["rationale"],
                     "budget": self._pilot.dispatch_budget(),
                     "max_admit": self._pilot.admit_cap(),
                     "chunk_bias": self._pilot.chunk_bias()})

    def _sched_boundary(self) -> float:
        """The sched ledger's per-boundary tap (a dispatched boundary):
        returns its padding fraction, 0.0 with the ledger off."""
        if self._sled is None:
            return 0.0
        self._sled.note_boundary()
        wf = self._sled.boundary_waste()
        with self.stats.lock:
            self.stats.record_waste_locked(wf)
        return wf

    def _note_idle(self) -> None:
        """The sched ledger's idle tick (a scheduler pass with nothing to
        dispatch)."""
        if self._sled is not None:
            self._sled.note_idle()
            with self.stats.lock:
                self.stats.sched_idle_boundaries += 1

    def _record_boundary(self, detail: Dict[str, Any], wf: float) -> None:
        """The flight recorder's "boundary" record, with the wave's
        padding fraction when the sched ledger is armed."""
        if self._sled is not None:
            detail["waste_frac"] = round(wf, 4)
        self._recorder.record("boundary", -1, detail)

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
            if self._heal is not None:
                # Penned resurrectees are in neither _slots nor _waiting.
                for req in self._heal.pen_take(0.0, flush=True):
                    live.setdefault(req.rid, req)
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
                if self._sled is not None:
                    self._sled.note_first_dispatch(
                        req.rid, req.submitted_at, now,
                        predicted_ms=(
                            self._roof.predict_request_ms(
                                len(req.tokens), req.params.max_new_tokens)
                            if self._roof is not None else 0.0))
                if self._recorder is not None:
                    self._recorder.record(
                        "admit", req.rid,
                        {"queue_wait_ms":
                            round(1000.0 * (now - req.submitted_at), 3),
                         "prompt_tokens": len(req.tokens),
                         "prefix_tokens": req.prefix_len or 0})
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
        if self._san is not None:
            self._san.assert_holds("_book")
        if req.finished:
            return
        req.finished = True
        if self._heal is not None:
            self._heal.note_done(req.rid)
        now = time.perf_counter()
        margin_ms = (1000.0 * (req.deadline - now)
                     if req.deadline is not None else None)
        if self._tracer.enabled:
            self._emit_request_spans(req, now, margin_ms)
        if self._recorder is not None:
            self._recorder.record(
                "terminal", req.rid,
                {"outcome": req.outcome or "ok",
                 "n_generated": req.n_generated})
        with self._rid_lock:
            self._requests.pop(req.rid, None)
        if req.prefix_handle is not None:
            # Unpin the trie path: the slot no longer depends on it, so
            # eviction may reclaim it.
            (self._paged_prefix or self._prefix).release(req.prefix_handle)
            req.prefix_handle = None
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
            "prompt_tokens": len(req.tokens) - req.replayed,
            "completion_tokens": req.replayed + req.n_generated,
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
                parent=root,
                attributes={"tokens": req.replayed + req.n_generated},
            )

    def _reap_lifecycle(self) -> None:
        """Drain shedding, queued cancel/deadline shedding, then in-flight
        cancel/deadline finalization; reaped rows are frozen device-side
        by one masked write, made only when a reap happened. Chaos
        disconnects come first, and the heal supervisor's pen is reaped
        and released after the drain shedding."""
        if self._san is not None:
            self._san.perturb("reap")
        if self._chaos is not None:
            victim = self._chaos.pick_disconnect(self._live_wave_rids())
            if victim is not None:
                self.cancel(victim)
        if self._draining.is_set():
            self._shed_queued_locked()
        if self._heal is not None:
            self._heal_tick()
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
            keep = np.ones((self.ecfg.max_slots,), bool)
            keep[dead] = False
            t0 = time.perf_counter() if self._observe else 0.0
            self._deactivate(keep)
            if self._observe:
                self._note_dispatch(("deactivate",), -1,
                                    time.perf_counter() - t0)

    # --- paged pool bookkeeping ---------------------------------------------

    def _pool_reserve(self, n: int) -> bool:
        """True iff n free blocks are (or can be made) available without
        touching live streams: retained trie prefixes are evicted
        LRU-first. Frees only ARRIVE between this check and the
        allocation (the scheduler alone allocates), so True stays true.
        Chaos may report exhaustion (scheduler thread only)."""
        if self._chaos is not None and (
            threading.current_thread() is self._thread
        ) and self._chaos.steal_alloc():
            return False  # injected exhaustion: admission stalls/preempts
        if self._allocator.free_count >= n:
            return True
        if self._paged_prefix is not None:
            evicted = self._paged_prefix.evict_for(n)
            if evicted:
                with self.stats.lock:
                    self.stats.prefix_evictions += evicted
                if self._recorder is not None:
                    self._recorder.record("trie-evict", -1,
                                          {"evicted": evicted})
        return self._allocator.free_count >= n

    def _secure_blocks(self, n: int, requester: Optional[_Request] = None
                       ) -> Optional[List[int]]:
        """Allocate n blocks: retained trie prefixes go first, then the
        YOUNGEST live stream other than the requester is preempted
        (failed, retriable) until they fit. None when even that cannot
        free enough."""
        while True:
            if self._pool_reserve(n):
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
            if self._sled is not None:
                # The prefill and decode work the victim throws away.
                self._sled.note_preempt(
                    victim.rid, len(victim.tokens) + victim.n_generated)
            if self._recorder is not None:
                self._recorder.record(
                    "preempt", victim.rid,
                    {"requester": requester.rid if requester else -1,
                     "need_blocks": n})
            logger.warning("preempting request %d: kv cache pool exhausted",
                           victim.rid)
            self._fail_req(victim, "preempted: kv cache pool exhausted",
                           kind="preempted", retriable=True)

    def _owned_need(self, req: _Request) -> int:
        """Blocks a one-shot admission must ALLOCATE: the prompt's block
        count minus the fully matched blocks it shares (a copy-on-write
        destination counts as owned)."""
        bs = self._kv_block
        return -(-len(req.tokens) // bs) - (req.prefix_len or 0) // bs

    def _paged_admit_blocks(self, req: _Request, cows: List[Tuple[int, int]],
                            cover: int) -> None:
        """Fill req's block-table row for prompt positions [0, cover):
        fully matched kv blocks are SHARED by refcount (zero-copy), a
        match that ends inside a kv block allocates a copy-on-write
        destination (appended to ``cows``; the caller queues the copies
        before the dispatch that writes them), and the rest is freshly
        allocated. Every block id lands in req.block_ids with exactly one
        ref owned by this request. The caller has reserved the capacity."""
        bs = self._kv_block
        slot = req.slot
        total = -(-cover // bs)
        bids: List[int] = []
        if req.prefix_len and self._paged_prefix is not None:
            srcs, partial = self._paged_prefix.plan(req.prefix_handle)
            if self._dp > 1:
                self._fetch_blocks(slot, srcs + [partial] * (
                    partial is not None))
            for i, sbid in enumerate(srcs):
                self._allocator.ref(sbid)
                self._table_host[slot, i] = sbid
                bids.append(sbid)
            if partial is not None:
                dst = self._allocator.alloc()
                if dst is None:
                    raise RuntimeError("kv cache pool exhausted (cow)")
                cows.append((partial, dst))
                self._table_host[slot, len(bids)] = dst
                bids.append(dst)
                with self.stats.lock:
                    self.stats.cow_copies += 1
                if self._recorder is not None:
                    self._recorder.record("cow", req.rid,
                                          {"src": partial, "dst": dst})
            with self.stats.lock:
                self.stats.zero_copy_admissions += 1
        for i in range(len(bids), total):
            bid = self._allocator.alloc()
            if bid is None:
                raise RuntimeError("kv cache pool exhausted (admit)")
            self._table_host[slot, i] = bid
            bids.append(bid)
        req.block_ids = bids

    def _insert_paged_prompt(self, req: _Request, upto: int) -> None:
        """Extend the trie over req's prompt blocks [0, upto): new nodes
        record (and ref) the pool block the slot's table maps their span
        to — host bookkeeping only, no KV moves."""
        if self._paged_prefix is None:
            return
        bs, pb = self._kv_block, self.ecfg.prefix_block
        slot = req.slot

        def block_of(j: int) -> int:
            bid = int(self._table_host[slot, (j * pb) // bs])
            if self._dp > 1:
                # The slot's replica just wrote the new node's span.
                self._holders[bid] = {self._replica(slot)}
            return bid

        self._paged_prefix.insert(req.tokens[:upto], block_of,
                                  handle=req.prefix_handle)

    def _release_blocks(self, req: _Request) -> None:
        """Drop every allocator ref req's table row holds (idempotent); the
        row is zeroed so in-flight strays land in the trash block."""
        if not self._paged or not req.block_ids:
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
        """Extend each decoding slot's table to cover this dispatch's
        worst-case write position (pos <= plen + expected - 1, so n steps
        write at most at plen + expected + n - 2); slots that cannot grow
        are failed."""
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
        """Slot -> request snapshot for this boundary's decode leg;
        mid-prefill requests are masked out."""
        return [None if (r is not None and r.prefilling) else r
                for r in self._slots]

    def _recycle_budget_spent(self, roster: List[Optional[_Request]],
                              chunk_len: int = 1) -> None:
        """Optimistic slot recycling: `expected` bounds the tokens a row
        will have produced once every dispatched decode leg retires, and
        the device's `remaining` counter freezes the row at its budget —
        so a slot whose budget is provably spent takes a new request at
        once (its blocks go back now; strays land in the trash block, and
        a new owner's writes are queued after this dispatch)."""
        for slot, req in enumerate(roster):
            if req is None or req.finished:
                continue
            req.expected += max(1, chunk_len)
            if req.expected >= req.params.max_new_tokens:
                if self._slots[slot] is req:
                    self._slots[slot] = None
                    self._active_host[slot] = False
                    self._free.append(slot)
                    self._release_blocks(req)

    # --- admission ------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self.ecfg.max_seq_len

    def _admit_key(self, req: _Request) -> Tuple[int, int]:
        """(suffix bucket, prefix bucket) grouping admissions; cold
        requests key as (full bucket, 0). The trie lookup runs once per
        request and pins the matched path; the match is capped at
        plen - 1 so at least one prompt token remains to give the first
        token's logits."""
        index = self._prefix if self._prefix is not None \
            else self._paged_prefix
        if index is None:
            return self._bucket(len(req.tokens)), 0
        if req.prefix_len is None:
            handle = index.lookup(req.tokens, max_len=len(req.tokens) - 1)
            req.prefix_handle = handle
            req.prefix_len = handle.match_len
            if handle.match_len:
                with self.stats.lock:
                    self.stats.prefix_hits += 1
                    self.stats.prefix_tokens_saved += handle.match_len
            if self._recorder is not None:
                self._recorder.record(
                    "trie-hit" if handle.match_len else "trie-miss",
                    req.rid,
                    {"matched_tokens": handle.match_len,
                     "prompt_tokens": len(req.tokens)})
        if req.prefix_len:
            return (self._bucket(len(req.tokens) - req.prefix_len),
                    self._bucket(req.prefix_len))
        return self._bucket(len(req.tokens)), 0

    def _dispatch_admits(self) -> List[Tuple[List[_Request], Any, Any, Any]]:
        """Admit FIFO runs of same-key waiting requests as groups; device
        work only, returns the groups' un-read (first, first_done)."""
        self._drain_pending()
        admits: List[Tuple[List[_Request], Any, Any, Any]] = []
        last_key: Optional[Tuple[int, int]] = None
        while self._free and self._waiting:
            if self._pilot is not None and self._shed_expired_head():
                continue  # an expired head must not displace a viable one
            key = self._admit_key(self._waiting[0])
            max_g = min(self._admit_cap(), len(self._free))
            group: List[_Request] = []
            reserved = 0
            shed = False
            while (len(group) < max_g and self._waiting
                   and self._admit_key(self._waiting[0]) == key):
                if self._pilot is not None and self._shed_expired_head():
                    shed = True
                    continue  # the loop condition re-keys on the new head
                if self._paged:
                    # The whole group's owned blocks must fit (after trie
                    # eviction) before the pop; a head request that
                    # cannot fit stays queued — admission does not preempt.
                    need = self._owned_need(self._waiting[0])
                    if not self._pool_reserve(reserved + need):
                        break
                    reserved += need
                group.append(self._waiting.popleft())
            if not group:
                if shed:
                    continue  # the head expired mid-fill: not a stall
                if not self._waiting:
                    break
                with self.stats.lock:
                    self.stats.pool_stalls += 1
                if self._recorder is not None:
                    self._recorder.record(
                        "pool-stall", self._waiting[0].rid,
                        {"waiting": len(self._waiting)})
                if self._sled is not None:
                    self._sled.note_pool_stall(self._waiting[0].rid)
                break
            try:
                admits.append(self._dispatch_admit_group(group, *key))
                last_key = key
            except Exception as e:  # a bad batch must not kill the loop
                logger.exception("admission failed for requests %s",
                                 [r.rid for r in group])
                if not self._heal_requeue_group(group, str(e)):
                    for req in group:
                        slot = req.slot
                        if slot >= 0 and self._slots[slot] is not req \
                                and slot not in self._free:
                            self._free.append(slot)  # popped, unregistered
                        self._fail_req(req, str(e), kind="internal")
        # Bucket-mismatch wait: the engine filled up and the head of the
        # queue buckets differently from the last group admitted.
        if (self._sled is not None and last_key is not None
                and self._waiting and not self._free):
            head = self._waiting[0]
            if self._bucket(len(head.tokens) - (head.prefix_len or 0)) \
                    != last_key[0]:
                self._sled.note_bucket_defer(head.rid)
        return admits

    def _admit_arrays(self, rows: Sequence[Tuple[_Request, int, int]],
                      S: int) -> Dict[str, np.ndarray]:
        """Host arrays of one padded admission group. ``rows`` holds
        (request, token offset, token count) for each of the Gp rows
        (padding rows repeat the last request, so their data and slot are
        identical to it)."""
        Gp = len(rows)
        out = {
            "toks": np.full((Gp, S), self.cfg.pad_token_id, np.int32),
            "plens": np.empty((Gp,), np.int32),
            "offs": np.empty((Gp,), np.int32),
            "seeds": np.empty((Gp,), np.int64),
            "temps": np.empty((Gp,), np.float32),
            "top_ks": np.empty((Gp,), np.int32),
            "top_ps": np.empty((Gp,), np.float32),
            "max_news": np.empty((Gp,), np.int32),
            "slots": np.empty((Gp,), np.int32),
        }
        for i, (req, off, n) in enumerate(rows):
            sp = req.params
            out["toks"][i, :n] = req.tokens[off:off + n]
            out["plens"][i] = len(req.tokens)
            out["offs"][i] = off
            out["seeds"][i] = int(sp.seed) & 0xFFFFFFFF
            out["temps"][i] = sp.temperature
            out["top_ks"][i] = sp.top_k
            out["top_ps"][i] = sp.top_p
            out["max_news"][i] = sp.max_new_tokens
            out["slots"][i] = req.slot
        return out

    def _dispatch_admit_group(self, group: List[_Request], Sb: int,
                              Pb: int = 0
                              ) -> Tuple[List[_Request], Any, Any, Any]:
        """Build the host arrays of `group` and dispatch the fused
        admission. G pads up to a power of two by repeating the last
        request (identical slot and data). Pb > 0 is a prefix-cache WARM
        group: `Sb` buckets the uncached suffix, `Pb` the reused prefix,
        and the tokens are the suffixes."""
        self._chaos_dispatch("admit", [r.rid for r in group])
        G = len(group)
        Gp = 1
        while Gp < G:
            Gp *= 2
        fam = (("admit-paged", Sb, Gp, Pb) if self._paged
               else ("admit-prefix", Pb, Sb, Gp) if Pb
               else ("admit", Sb, Gp))
        if self._sled is not None:
            # Every one of the Gp * Sb offered token-slots is useful
            # suffix, bucket rounding or pow2 group replication.
            useful = sum(len(r.tokens) - (r.prefix_len if Pb else 0)
                         for r in group)
            bpad = G * Sb - useful
            gpad = (Gp - G) * Sb
            self._sled.note_group(fam, Gp * Sb, useful, bpad, gpad)
            with self.stats.lock:
                self.stats.sched_useful_tokens += useful
                self.stats.sched_bucket_pad_tokens += bpad
                self.stats.sched_group_pad_tokens += gpad
        self._record_first_dispatch(group)
        for req in group:
            req.slot = self._free.pop()
            req.expected = 1  # the admission samples the first token
        rows = []
        for i in range(Gp):
            req = group[min(i, G - 1)]
            off = req.prefix_len if Pb else 0
            rows.append((req, off, len(req.tokens) - off))
        a = self._admit_arrays(rows, Sb)
        knobs = (a["seeds"], a["temps"], a["top_ks"], a["top_ps"],
                 a["max_news"], a["slots"])
        with self.stats.lock:
            self.stats.admit_dispatches += 1
            self.stats.cold_admit_dispatches += int(not Pb)
        if self._paged:
            # Zero-copy admission: fill each row's table (shared refs,
            # copy-on-write, fresh blocks — capacity was reserved), queue
            # the copies first, then the admission.
            cows: List[Tuple[int, int]] = []
            for req in group:
                self._paged_admit_blocks(req, cows, cover=len(req.tokens))
            for src, dst in cows:
                self._cow(src, dst, rid=group[0].rid)
            t0 = time.perf_counter() if self._observe else 0.0
            first, first_done = self._dispatch(
                fam, "_paged_admit_impl", [self._table_host[a["slots"]],
                                           a["toks"], a["plens"], a["offs"],
                                           *knobs],
                fresh=2, prefix_width=Pb)
            self._noted(fam, group[0].rid, t0, a["toks"], Gp)
            for req in group:
                self._slots[req.slot] = req
                self._insert_paged_prompt(req, upto=len(req.tokens))
            return group, None, first, first_done
        if Pb:
            # The pinned trie paths, zero-padded to the prefix bucket and
            # stacked on the batch axis.
            prefix_kv = StoreGather(
                rows=tuple(tuple(nd.id for nd in req.prefix_handle.nodes)
                           for req, _, _ in rows), pad_to=Pb, stack=True)
            with self.stats.lock:
                # Dense warm admissions MOVE the prefix KV.
                self.stats.prefix_seed_copies += G
            t0 = time.perf_counter() if self._observe else 0.0
            first, first_done, writes = self._dispatch(
                fam, "_admit_prefix_impl", [a["toks"], a["plens"],
                                            a["offs"], prefix_kv, *knobs],
                fresh=2)
        else:
            t0 = time.perf_counter() if self._observe else 0.0
            out = self._admit(a["toks"], a["plens"], *knobs,
                              return_sub=self._prefix is not None)
            first, first_done = out[:2]
            writes = out[2] if self._prefix is not None else None
        self._noted(fam, group[0].rid, t0, a["toks"], Gp)
        # Register the rows now so an error path fails them cleanly; the
        # active mirror is armed at boundary processing.
        for req in group:
            self._slots[req.slot] = req
        if self._prefix is not None:
            self._insert_prompt_kv(group, writes, warm=bool(Pb))
        return group, None, first, first_done

    def _insert_prompt_kv(self, group: List[_Request],
                          writes: Dict[str, torch.Tensor],
                          warm: bool) -> None:
        """Insert each admitted prompt's KV into the dense trie. `writes`
        holds cache-dtype KV [L, G(padded), Hkv, S, (Dh)] — whole prompts
        for cold groups, uncached suffixes for warm ones (their spans are
        rebased by the prefix length; the prefix blocks are already in
        the trie, pinned by the row's handle). Each span is copied out,
        so a node holds its own block."""
        for i, req in enumerate(group):
            evicted = self._trie_insert(req.tokens, writes, i,
                                        req.prefix_len if warm else 0,
                                        req.prefix_handle)
            if evicted:
                with self.stats.lock:
                    self.stats.prefix_evictions += evicted
                if self._recorder is not None:
                    self._recorder.record("trie-evict", req.rid,
                                          {"evicted": evicted})
        self._store_sync()

    # --- chunked prefill --------------------------------------------------------

    def _chunk_bucket(self, n: int) -> int:
        for b in self._chunk_buckets:
            if n <= b:
                return b
        return self._chunk_buckets[-1]

    def _admit_chunk_slot(self, req: _Request) -> None:
        """Admit a request into a slot for chunked prefill (the bucketed
        chunked engines and the ragged wave): register it at once, look
        up the prefix cache and start its first chunk at the first
        uncached token. Paged: a warm hit is table surgery (ref the
        matched blocks, copy the partial tail's block); later chunks
        take their blocks at dispatch. Dense: the hit's trie KV is
        written into the slot (``_seed_prefix_impl``)."""
        self._record_first_dispatch([req])
        req.slot = self._free.pop()
        req.prefilling = True
        self._slots[req.slot] = req
        if self._paged:
            if self._paged_prefix is not None:
                self._admit_key(req)
                if req.prefix_len:
                    cows: List[Tuple[int, int]] = []
                    self._paged_admit_blocks(req, cows, cover=req.prefix_len)
                    for src, dst in cows:
                        self._cow(src, dst, rid=req.rid)
                    req.prefill_done = req.prefix_len
            return
        if self._prefix is not None:
            self._admit_key(req)
            if req.prefix_len:
                W = self._bucket(req.prefix_len)
                pkv = StoreGather(
                    rows=(tuple(nd.id for nd in req.prefix_handle.nodes),),
                    pad_to=W, stack=False)
                t0 = time.perf_counter() if self._observe else 0.0
                self._dispatch(("seed-prefix", W), "_seed_prefix_impl",
                               [pkv, _scalar(req.slot)])
                if self._observe:
                    self._note_dispatch(("seed-prefix", W), req.rid,
                                        time.perf_counter() - t0)
                req.prefill_done = req.prefix_len
                with self.stats.lock:
                    self.stats.prefix_seed_copies += 1

    def _collect_chunk_work(
        self, left: int
    ) -> List[Tuple[_Request, int, int, bool, int]]:
        """One budget pass: each dispatchable request at most once, with
        its next chunk sized. Continuing prefills go first; new admissions
        need a free slot and are gated on a cold-size estimate BEFORE the
        slot pop. Returns (req, Sc, prefix_width, final, chunk_len)."""
        C = self._prefill_chunk
        work: List[Tuple[_Request, int, int, bool, int]] = []
        while left > 0:
            if self._prefilling:
                req = self._prefilling.popleft()
                if req.finished:
                    continue
            elif self._waiting and self._free:
                if self._pilot is not None and self._shed_expired_head():
                    continue  # an expired head must not claim a slot
                req = self._waiting[0]
                rem = len(req.tokens)
                est = C if rem > C else self._chunk_bucket(rem)
                if est > left:
                    break
                if self._paged and not self._pool_reserve(
                        min(est, rem) // self._kv_block + 2):
                    self._note_pool_stall(req)
                    break
                self._waiting.popleft()
                self._admit_chunk_slot(req)
            else:
                break
            start = req.prefill_done
            rem = len(req.tokens) - start
            final = rem <= C
            Sc = self._chunk_bucket(rem) if final else C
            if Sc > left:
                # Keeps FIFO priority for the next dispatch's budget.
                self._prefilling.appendleft(req)
                break
            clen = rem if final else C
            W = 0 if start == 0 else self._bucket(start)
            work.append((req, Sc, W, final, clen))
            left -= Sc
        return work

    def _note_pool_stall(self, req: _Request) -> None:
        """A new admission's first chunk does not fit the pool: it stays
        queued (counted, recorded, and stamped as a pool-stall wait)."""
        with self.stats.lock:
            self.stats.pool_stalls += 1
        if self._recorder is not None:
            self._recorder.record("pool-stall", req.rid,
                                  {"waiting": len(self._waiting)})
        if self._sled is not None:
            self._sled.note_pool_stall(req.rid)

    def _dispatch_chunk_group(
        self, rows: List[Tuple[_Request, int, int, bool, int]]
    ) -> Tuple[List[_Request], Any, Any, Any]:
        """Build the host arrays of one same-(Sc, W) run of chunk rows and
        dispatch the fused chunk; G pads to a power of two by repeating
        the last row."""
        self._chaos_dispatch("prefill-chunk", [r[0].rid for r in rows])
        group = [r[0] for r in rows]
        Sc, W = rows[0][1], rows[0][2]
        G = len(rows)
        Gp = 1
        while Gp < G:
            Gp *= 2
        if self._sled is not None:
            # The admission group's exact cell split, per chunk row.
            useful = sum(r[4] for r in rows)
            bpad = G * Sc - useful
            gpad = (Gp - G) * Sc
            self._sled.note_group(("chunk", Sc, Gp, W), Gp * Sc, useful,
                                  bpad, gpad)
            with self.stats.lock:
                self.stats.sched_useful_tokens += useful
                self.stats.sched_bucket_pad_tokens += bpad
                self.stats.sched_group_pad_tokens += gpad
        padded = [rows[min(i, G - 1)] for i in range(Gp)]
        a = self._admit_arrays(
            [(req, req.prefill_done, clen) for req, _, _, _, clen in padded],
            Sc)
        finals = np.array([r[3] for r in padded], bool)
        args = [a["toks"], a["plens"], a["offs"], a["seeds"], a["temps"],
                a["top_ks"], a["top_ps"], a["max_news"], a["slots"], finals]
        key = ("chunk", Sc, Gp, W)
        writes = None
        if self._paged:
            # Append this chunk's pool blocks first (trie eviction, then
            # preemption of younger streams): real KV never lands in the
            # trash block.
            bs = self._kv_block
            for req, _, _, _, clen in rows:
                need = min(self._nbs, -(-(req.prefill_done + clen) // bs))
                have = len(req.block_ids)
                if need > have:
                    got = self._secure_blocks(need - have, requester=req)
                    if got is None:
                        raise RuntimeError(
                            "kv cache pool exhausted (prefill chunk)")
                    for j, bid in enumerate(got):
                        self._table_host[req.slot, have + j] = bid
                    req.block_ids.extend(got)
            t0 = time.perf_counter() if self._observe else 0.0
            first, first_done = self._dispatch(
                key, "_paged_admit_chunk_impl",
                [self._table_host[a["slots"]], *args], fresh=2,
                prefix_width=W)
        else:
            t0 = time.perf_counter() if self._observe else 0.0
            out = self._dispatch(key, "_admit_chunk_impl", args, fresh=2,
                                 prefix_width=W,
                                 return_sub=self._prefix is not None)
            first, first_done = out[:2]
            if self._prefix is not None:
                writes = out[2]
        # Dense and paged chunks are twins: one "chunk" family.
        self._noted(key, group[0].rid, t0, a["toks"], Gp)
        finals_l = []
        for req, _, _, final, clen in rows:
            req.prefill_done += clen
            finals_l.append(final)
            if final:
                req.prefilling = False
                req.expected = 1  # the final chunk samples the first token
            else:
                self._prefilling.append(req)
            self._insert_paged_prompt(req, upto=req.prefill_done)
        if writes is not None:
            self._insert_chunk_kv(rows, writes)
        return group, finals_l, first, first_done

    def _insert_chunk_kv(
        self,
        rows: List[Tuple[_Request, int, int, bool, int]],
        writes: Dict[str, torch.Tensor],
    ) -> None:
        """Extend the dense trie with each chunk's fresh KV blocks; blocks
        below the chunk's start are already in it (chunk starts are
        block-aligned), so get_span only covers [start, end)."""
        for i, (req, _, _, _, clen) in enumerate(rows):
            end = req.prefill_done  # already advanced past this chunk
            evicted = self._trie_insert(req.tokens[:end], writes, i,
                                        end - clen, req.prefix_handle)
            if evicted:
                with self.stats.lock:
                    self.stats.prefix_evictions += evicted
        self._store_sync()

    def _dispatch_prefill_chunks(
        self,
    ) -> List[Tuple[List[_Request], Any, Any, Any]]:
        """Chunked-prefill admission: pack at most dispatch_token_budget
        prefill tokens (one chunk by default) into this boundary, then
        hand over to the decode chunk. A request's chunks are sequential
        (chunk k+1 reads chunk k's KV), so each budget pass dispatches one
        chunk per request; repeated passes let a lone long prompt use the
        whole budget."""
        self._drain_pending()
        admits: List[Tuple[List[_Request], Any, Any, Any]] = []
        if self._pilot is not None:
            budget = self._pilot.dispatch_budget()
        else:
            budget = self.ecfg.dispatch_token_budget or self._prefill_chunk
        left = budget
        n_chunks = n_tokens = 0
        while left > 0:
            work = self._collect_chunk_work(left)
            if not work:
                break
            i = 0
            while i < len(work):
                j = i + 1
                while (j < len(work) and j - i < self._admit_cap()
                       and work[j][1:3] == work[i][1:3]):
                    j += 1
                rows = work[i:j]
                try:
                    admits.append(self._dispatch_chunk_group(rows))
                    for _, Sc, _, _, clen in rows:
                        left -= Sc
                        n_chunks += 1
                        n_tokens += clen
                except Exception as e:  # a bad batch must not kill the loop
                    logger.exception("chunk dispatch failed for requests %s",
                                     [r[0].rid for r in rows])
                    if not self._heal_requeue_group([r[0] for r in rows],
                                                    str(e)):
                        for req, *_ in rows:
                            self._fail_req(req, str(e), kind="internal")
                i = j
        if n_chunks:
            with self.stats.lock:
                self.stats.prefill_chunks += n_chunks
                self.stats.prefill_chunk_tokens += n_tokens
                self.stats.budget_dispatches += 1
                self.stats.budget_tokens += budget - left
                self.stats.budget_limit = budget
            self._note_budget(budget, budget - left)
        return admits

    def _note_budget(self, budget: int, used: int) -> None:
        """The sched ledger's budget pass: starved when prefill work is
        still queued at its end; only then is unspent budget
        fragmentation."""
        if self._sled is None:
            return
        starved = bool(self._prefilling or (self._waiting and self._free))
        self._sled.note_budget(budget, used, starved)
        if starved and budget > used:
            with self.stats.lock:
                self.stats.sched_frag_tokens += budget - used

    # --- the bucketed decode chunk --------------------------------------------

    def _pick_chunk(self) -> int:
        """Prefill-priority chunk policy: admissions happen only at chunk
        boundaries, so long chunks are kept for saturation (fewer free
        slots than an admission group would take: a mid-chunk arrival
        would wait for completions anyway); with real free capacity the
        boundaries stay at min_chunk, so TTFT tracks the unloaded floor."""
        sizes = self._chunk_sizes
        if len(sizes) == 1:
            return sizes[0]
        n_slots = len(self._slots)
        free = sum(1 for r in self._slots if r is None)
        # Thresholds scale with the pool, so small engines (max_admit ~
        # max_slots) do not read "half empty" as saturated.
        sat = min(self._max_admit, (n_slots + 7) // 8)
        if free < sat:
            idx = len(sizes) - 1
        elif free < n_slots // 4:
            # Mid rung, capped below the top: with two rungs len // 2
            # would be the top and near-saturation would lose its
            # admission boundaries.
            idx = min(len(sizes) // 2, len(sizes) - 2)
        else:
            idx = 0
        if self._pilot is not None:
            # The pilot's deadline-pressure bias moves the pick at most
            # one rung, inside the ladder.
            idx = max(0, min(idx + self._pilot.chunk_bias(), len(sizes) - 1))
        return sizes[idx]

    def _dispatch_decode_chunk(self, n: int):
        """One n-step decode chunk; paged engines first grow each live
        row's table to the chunk's worst-case position."""
        self._chaos_dispatch("decode", self._live_wave_rids())
        if self._paged:
            self._grow_decode_blocks(n)
            t0 = time.perf_counter() if self._observe else 0.0
            out = self._dispatch(("decode", n), "_paged_chunk_impl",
                                 [self._table_host], n_steps=n)
        else:
            t0 = time.perf_counter() if self._observe else 0.0
            out = self._dispatch(("decode", n), "_chunk_impl", [],
                                 n_steps=n)
        if self._observe:
            self._note_dispatch(("decode", n), -1, time.perf_counter() - t0)
        return out

    def _boundary(self, admits, roster, decode=()) -> _PendingWave:
        """The pending boundary of `admits` (the dispatch tuples) and, when
        it decoded, its decode leg's (toks, valid, active), with their
        host copies started now."""
        arrays: List[torch.Tensor] = []
        for _, _, first, done in admits:
            arrays += [first, done]
        arrays += list(decode)
        return _PendingWave([(g, f) for g, f, _, _ in admits], roster,
                            self._host_copy(arrays), self._wave_epoch,
                            bool(decode))

    def _timed(self, wave: _PendingWave) -> _PendingWave:
        """The boundary with its timing token, taken at dispatch end
        (after the boundary's taps, as in the JAX engine)."""
        if not self._timing_on:
            return wave
        return wave._replace(timing=self._make_timing())

    def _dispatch_admissions(self):
        """This boundary's admission groups (or prefill chunks) and the
        decode roster, registered as the dispatch wreck for the error
        path; None when there is nothing to dispatch."""
        admits = (self._dispatch_prefill_chunks() if self._chunked
                  else self._dispatch_admits())
        self._dispatch_wreck = _PendingWave(
            [(g, f) for g, f, _, _ in admits], None, None, self._wave_epoch)
        if not (admits or self._active_host.any()):
            return None
        roster = self._roster()
        self._dispatch_wreck = self._dispatch_wreck._replace(roster=roster)
        return admits, roster

    def _dispatch_bucketed(self) -> Optional[_PendingWave]:
        """One bucketed boundary: admission groups (or prefill chunks),
        then one decode chunk over every slot; None when idle."""
        work = self._dispatch_admissions()
        if work is None:
            return None
        admits, roster = work
        n = self._pick_chunk()
        toks, valid, active = self._dispatch_decode_chunk(n)
        with self.stats.lock:
            self.stats.decode_dispatches += 1
            self.stats.decode_steps += n
        self._recycle_budget_spent(roster, n)
        wave = self._boundary(admits, roster, (toks, valid, active))
        wf = self._sched_boundary()
        if self._pilot is not None:
            self._pilot_tick()
        if self._recorder is not None:
            detail = {"admits": sum(len(g) for g, _, _, _ in admits),
                      "chunk": n, "active": int(self._active_host.sum())}
            if self._paged:
                detail["pool_free"] = int(self._allocator.free_count)
            self._record_boundary(detail, wf)
        return self._timed(wave)

    # --- speculative decoding ----------------------------------------------------

    def _pick_spec_k(self) -> int:
        """The verify rung: the top of the pow2 ladder, or the pilot's
        spec_k knob when flying (its envelope is the ladder)."""
        k = self._spec_k_live
        if self._pilot is not None:
            k = self._pilot.spec_k(k)
        if k not in self._spec_rungs:
            k = self._spec_rungs[-1]
        self._spec_k_live = k
        return k

    def _collect_drafts(self, k: int):
        """Host-side drafts for every armed decode row: (drafts [B, k]
        int32, wave [B] bool, n_wave). Rows admitted at THIS boundary are
        not armed on the host yet and sit the wave out (they join the
        next one; per-row sequential keys make the stream the same). The
        model drafter runs one call for the whole wave."""
        B = self.ecfg.max_slots
        drafts = np.zeros((B, k), np.int32)
        wave = self._active_host.copy()
        rows: List[Tuple[int, _Request]] = []
        for slot in np.flatnonzero(wave):
            req = self._slots[slot]
            if req is None or req.finished or req.prefilling:
                wave[slot] = False
                continue
            rows.append((int(slot), req))
        if not rows:
            return drafts, wave, 0
        if self._drafter.uses_model:
            # gen_hist[replayed:]: resurrection folds earlier tokens into
            # req.tokens, so the un-replayed tail IS the history.
            hists = [(slot, list(req.tokens) + req.gen_hist[req.replayed:])
                     for slot, req in rows]
            t0 = time.perf_counter() if self._observe else 0.0
            out = self._drafter.draft_batch(hists, k, B, self._draft_programs())
            if self._observe:
                self._note_dispatch(("draft", k), -1,
                                    time.perf_counter() - t0)
            for slot, _ in rows:
                drafts[slot] = out[slot]
        else:
            for slot, req in rows:
                drafts[slot] = self._drafter.draft(
                    req.tokens, req.gen_hist[req.replayed:], k)
        return drafts, wave, len(rows)

    def _dispatch_spec(self) -> Optional[_PendingWave]:
        """One speculative boundary: admissions as the bucketed engine,
        then — in place of the decode chunk — one host draft pass and ONE
        verify wave over every armed row at k + 1 positions. Everything
        that depends on acceptance (expected resync, block rollback,
        counters) runs at process time (:meth:`_spec_post_process`)."""
        work = self._dispatch_admissions()
        if work is None:
            return None
        admits, roster = work
        decode = ()
        if self._active_host.any():
            k = self._pick_spec_k()
            drafts, wave, n_wave = self._collect_drafts(k)
            self._spec_wave = (k, wave, n_wave)
            self._chaos_dispatch("decode", self._live_wave_rids())
            # k + 1 new positions per row at most; expected is EXACT under
            # spec (resynced every boundary), so growth covers pos .. pos+k.
            self._grow_decode_blocks(k + 1)
            # The walk's trip count from the host's own pre-wave
            # positions (exact: every boundary was processed).
            top = max((len(r.tokens) + r.n_generated - 1
                       for r in (self._slots[s] for s in np.flatnonzero(wave))
                       if r is not None), default=0)
            n_live = -(-top // self._kv_block)
            key, branch = self._verify_key(k, n_live)
            t0 = time.perf_counter() if self._observe else 0.0
            toks, valid, active = self._dispatch(
                key, "_verify_impl", [self._table_host, drafts, wave],
                branch=branch, kernel=self._kernel,
                block_budget=self.ecfg.ragged_block_budget, n_live=n_live)
            if self._observe:
                self._note_dispatch(("verify", k), -1,
                                    time.perf_counter() - t0)
            decode = (toks, valid, active)
            with self.stats.lock:
                self.stats.decode_dispatches += 1
                self.stats.decode_steps += 1
        return self._timed(self._boundary(admits, roster, decode))

    def _spec_post_process(self, chunk_data, roster) -> None:
        """The spec boundary's tail, after its tokens were delivered:
        acceptance accounting and per-row rollback.

        A row that emitted e tokens (1 <= e <= k + 1) accepted e - 1
        drafts; a draft that matched but fell after a terminal token
        counts rejected. So accepted + rejected == drafted and emitted +
        rejected == (k + 1) * wave rows hold exactly.

        Rollback is host bookkeeping: the wave committed all k + 1
        positions through the tables, but positions past a row's accepted
        prefix are dead (the next wave's in-layer view rewrites them
        before any mask exposes them), so rejecting is: resync expected
        to n_generated and unref the table tail past the new position."""
        wave_info, self._spec_wave = self._spec_wave, None
        k = n_wave = 0
        if chunk_data is not None and wave_info is not None:
            k, wave, n_wave = wave_info
            if n_wave:
                emitted, accepted, rejected = self._spec_account(
                    chunk_data, k, wave, n_wave)
            self._spec_rollback(roster, wave)
        # The bucketed path's per-boundary taps, run at process time: how
        # many tokens a wave emitted is known only now.
        wf = self._sched_boundary()
        if self._pilot is not None:
            self._pilot_tick()
        if self._recorder is not None:
            detail = {"active": int(self._active_host.sum()),
                      "pool_free": int(self._allocator.free_count)}
            if n_wave:
                detail.update(verify_k=k, wave=n_wave, emitted=emitted,
                              accepted=accepted, rejected=rejected)
            self._record_boundary(detail, wf)

    def _spec_account(self, chunk_data, k: int, wave: np.ndarray,
                      n_wave: int) -> Tuple[int, int, int]:
        """One verify wave's acceptance: counters, stats and the sched
        ledger's group and spec taps. Returns (emitted, accepted,
        rejected)."""
        emitted = int(chunk_data[1].sum(axis=0)[wave].sum())
        cells = (k + 1) * n_wave
        drafted = k * n_wave
        accepted = emitted - n_wave
        rejected = cells - emitted
        self._spec_drafted += drafted
        self._spec_accepted += accepted
        self._spec_waves += 1
        if self._sled is not None:
            self._sled.note_group(("verify", k), cells, emitted, 0, 0,
                                  spec_rejected=rejected)
            self._sled.note_spec(drafted, accepted, rejected)
        with self.stats.lock:
            self.stats.spec_drafted_tokens += drafted
            self.stats.spec_accepted_tokens += accepted
            self.stats.spec_rejected_tokens += rejected
            self.stats.spec_verify_waves += 1
            # Unconditional, as in the JAX engine's spec boundary.
            self.stats.sched_useful_tokens += emitted
        return emitted, accepted, rejected

    def _spec_rollback(self, roster, wave: np.ndarray) -> None:
        """Resync each live wave row's expected count and unref its table
        tail past the new position."""
        bs = self._kv_block
        for slot, req in enumerate(roster or []):
            if req is None or not wave[slot]:
                continue
            if req.finished or self._slots[slot] is not req:
                continue  # completed or failed rows were released whole
            req.expected = req.n_generated
            pos_new = len(req.tokens) + req.n_generated - 1
            keep = min(self._nbs, pos_new // bs + 1)
            if len(req.block_ids) > keep:
                for bid in req.block_ids[keep:]:
                    self._allocator.unref(bid)
                self._table_host[slot, keep:len(req.block_ids)] = 0
                del req.block_ids[keep:]

    # --- the ragged wave ------------------------------------------------------

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
                if self._pilot is not None and self._shed_expired_head():
                    continue  # an expired head must not claim a slot
                req = self._waiting[0]
                est = min(C, len(req.tokens))
                if est > left:
                    break
                if not self._pool_reserve(est // self._kv_block + 2):
                    self._note_pool_stall(req)
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
        if self._pilot is not None:
            budget = self._pilot.dispatch_budget()
        else:
            budget = self.ecfg.dispatch_token_budget or B * C
        work = self._collect_ragged_work(budget)
        if not work and not self._active_host.any():
            return None
        self._chaos_dispatch("ragged", self._live_wave_rids())
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
        if self._roof is not None:
            self._note_ragged_occupancy(work)
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
            if self._paged_prefix is not None:
                self._insert_paged_prompt(req, upto=req.prefill_done)
        roster = self._roster()
        self._dispatch_wreck = _PendingWave([(group, finals_l)], roster,
                                            None, self._wave_epoch)
        self._grow_decode_blocks(1)
        has_prefill = bool(is_prefill.any())
        live_blocks = self._live_blocks(starts, is_prefill, roster)
        t0 = time.perf_counter() if self._observe else 0.0
        first, first_done, toks_d, valid_d = self._ragged_wave(
            (self._table_host, toks.reshape(-1), plens, starts, seeds, temps,
             top_ks, top_ps, max_news, finals, is_prefill),
            kernel=self._kernel, block_budget=self.ecfg.ragged_block_budget,
            has_prefill=has_prefill, live_blocks=live_blocks)
        self._noted(("ragged", C), group[0].rid if group else -1, t0, toks,
                    B)
        host = self._host_copy(
            [first, first_done, toks_d, valid_d, self._state["active"]])
        with self.stats.lock:
            self.stats.decode_dispatches += 1
            self.stats.decode_steps += 1
            self.stats.prefill_waves += int(
                has_prefill or self._kernel == "masked")
            if group:
                self.stats.prefill_chunks += len(group)
                self.stats.prefill_chunk_tokens += packed
                self.stats.budget_dispatches += 1
                self.stats.budget_tokens += packed
                self.stats.budget_limit = budget
        self._recycle_budget_spent(roster)
        if self._sled is not None and packed:
            # A ragged wave's unused token-slots are not padding: the wave
            # walks each request's real token count, so cells == useful.
            self._sled.note_group(("ragged", C), packed, packed, 0, 0)
            with self.stats.lock:
                self.stats.sched_useful_tokens += packed
            self._note_budget(budget, packed)
        wf = self._sched_boundary()
        if self._pilot is not None:
            self._pilot_tick()
        if self._recorder is not None:
            self._record_boundary(
                {"admits": len(group), "chunk": 1,
                 "active": int(self._active_host.sum()),
                 "packed_tokens": packed,
                 "pool_free": int(self._allocator.free_count)}, wf)
        return self._timed(_PendingWave([(group, finals_l)], roster, host,
                                        self._wave_epoch, True))

    def _note_ragged_occupancy(self, work) -> None:
        """The roof ledger's live pricing of this wave, before
        prefill_done advances: query tokens packed (prefill segments, a
        final segment's first-token row, every decoding row), the q x kv
        pairs they score and the pool positions the walk reads."""
        Smax = self.ecfg.max_seq_len
        q_toks = attn_qk = kv_read = 0
        in_work = set()
        for req, clen, final in work:
            if req.finished:
                continue
            in_work.add(req.slot)
            start = req.prefill_done
            q_toks += clen
            attn_qk += clen * start + clen * (clen + 1) // 2
            kv_read += start
            if final:
                plen = len(req.tokens)
                q_toks += 1
                attn_qk += plen
                kv_read += plen
        for slot, req in enumerate(self._slots):
            if (req is None or slot in in_work or req.finished
                    or req.prefilling or not self._active_host[slot]):
                continue
            pos = min(len(req.tokens) + max(req.n_generated, 1) - 1,
                      Smax - 1)
            q_toks += 1
            attn_qk += pos
            kv_read += pos
        self._roof.note_ragged_occupancy(q_toks, kv_read, attn_qk)

    # --- boundary processing ----------------------------------------------------

    def _process_admits(self, admits, admit_data) -> None:
        """Deliver each admission group's first tokens and arm its rows.
        finals None: a one-shot admission, every row armed; a chunked
        group's non-final rows only deposited KV and are skipped. Ragged
        arrays are slot-indexed, bucketed ones group-indexed."""
        now = time.perf_counter()
        ttft_total, n_first, n_armed = 0.0, 0, 0
        for (group, finals), (first_h, done_h) in zip(admits, admit_data):
            for i, req in enumerate(group):
                if (finals is not None and not finals[i]) or req.finished:
                    continue
                slot = req.slot
                idx = slot if self._ragged else i
                first_tok = int(first_h[idx])
                req.last_burst_at = now
                req.n_generated = 1
                n_armed += 1
                if self._spec or self._heal is not None:
                    req.gen_hist.append(first_tok)
                if req.first_token_at is None:
                    req.first_token_at = now
                    ttft_ms = 1000.0 * (now - req.submitted_at)
                    ttft_total += ttft_ms
                    n_first += 1
                    req.out.put({"tokens": [first_tok], "ttft_ms": ttft_ms})
                else:
                    # A resurrected re-admission: the client saw its
                    # first token before the fault.
                    req.out.put({"tokens": [first_tok]})
                if self._heal is not None:
                    self._heal.note_progress(req.rid)
                if bool(done_h[idx]):
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
        request snapshot taken when THIS decode leg was dispatched. Valid
        columns are True-prefixes, so the first n_valid rows are the
        emitted tokens."""
        n_valid = valid_h.sum(axis=0)
        total = 0
        now = time.perf_counter()
        gaps_ms: List[float] = []
        for slot, req in enumerate(roster):
            if req is None or req.finished:
                continue
            n = int(n_valid[slot])
            if n:
                burst = toks_h[:n, slot].tolist()
                if self._spec or self._heal is not None:
                    req.gen_hist.extend(burst)
                req.out.put({"tokens": burst})
                req.n_generated += n
                total += n
                if self._heal is not None:
                    self._heal.note_progress(req.rid)
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

    def _fetch_boundary(self, wave: _PendingWave) -> List[np.ndarray]:
        """One boundary's wait for its host copies, inside the heal
        guards: the chaos hang runs INSIDE the watchdog bound (an injected
        hang is seen exactly as a stalled fetch), the watchdog raises
        WatchdogError into the wreck path after heal_watchdog_ms, chaos
        poisoning corrupts the fetched host buffers, and the sentinel
        screens every token id before any reaches a client queue. Touches
        no engine bookkeeping: runs under _book on the sync loops and
        without it on the fetcher thread."""
        def fetch():
            if self._chaos is not None:
                self._chaos.maybe_hang()
            return wave.host.wait()

        if self._heal is not None and self._heal.watchdog_ms > 0:
            arrays = self._heal.bounded_fetch(fetch)
        else:
            arrays = fetch()
        n = 2 * len(wave.admits)
        if self._chaos is not None and self._chaos.cfg.nan_inject:
            self._chaos.poison_fetch(
                arrays[0:n:2] + (arrays[n:n + 1] if wave.decoded else []))
        if self._heal is not None:
            self._heal.check_tokens(
                list(zip(arrays[0:n:2], arrays[1:n:2])),
                tuple(arrays[n:n + 3]) if wave.decoded else None,
                self.cfg.vocab_size)
        return arrays

    def _process_boundary(self, wave: _PendingWave,
                          fetched: Optional[Tuple[List[np.ndarray],
                                                  float, float]] = None
                          ) -> None:
        """Read one boundary's results and run the host bookkeeping. A
        boundary from before a device-state rebuild is dropped. `fetched`
        is the (host arrays, start, end) of the fetch the fetcher thread
        already made (:meth:`_fetch_boundary`); without it the fetch
        happens here (the sync loops), stamped when the roof ledger is
        armed."""
        if wave.epoch != self._wave_epoch:
            return
        roofing = self._roof is not None and wave.timing is not None
        if fetched is None:
            if self._chaos is not None:
                # A slow boundary under _book: exactly the race window
                # the fault widens.
                self._chaos.maybe_slow_boundary()
            f0 = time.perf_counter() if roofing else 0.0
            arrays = self._fetch_boundary(wave)
            f1 = time.perf_counter() if roofing else 0.0
        else:
            arrays, f0, f1 = fetched
        n = 2 * len(wave.admits)
        self._process_admits(wave.admits, list(zip(arrays[0:n:2],
                                                    arrays[1:n:2])))
        chunk_data = tuple(arrays[n:n + 3]) if wave.decoded else None
        if chunk_data is not None:
            self._process_chunk(*chunk_data, wave.roster)
        if self._spec:
            self._spec_post_process(chunk_data, wave.roster)
        self._record_wave_timing(wave.timing)
        if roofing:
            self._roof_note_boundary(wave.timing, f0, f1)
        if self._san is not None:
            self._san.audit(self)
        if self._sled is not None:
            self._sled.audit()
        if self._heal is not None:
            self._heal.note_boundary_ok()

    # --- failure --------------------------------------------------------------

    def _gather_wrecked(self, waves=()) -> Dict[int, _Request]:
        """Every request a wrecked dispatch may have owned: the live slot
        table plus the given waves and every in-flight one, whose groups
        and rosters hold requests already recycled out of ``_slots``."""
        live: Dict[int, _Request] = {}
        for req in self._slots:
            if req is not None:
                live[req.rid] = req
        for wave in (*waves, *self._inflight):
            if wave is None:
                continue
            for group, _ in wave.admits:
                for req in group:
                    live[req.rid] = req
            for req in wave.roster or ():
                if req is not None:
                    live[req.rid] = req
        return live

    def _fail_all(self, err: str, waves=()) -> None:
        """The raw failure path (heal off, or the engine going down): fail
        every live request and rebuild the device state."""
        if self._san is not None:
            self._san.assert_holds("_book")
        if self._recorder is not None:
            self._recorder.record("fail-all", -1, {"error": err[:200]})
        for req in self._gather_wrecked(waves).values():
            self._fail_req(req, err, kind="internal", retriable=True)
        self._rebuild_device_state()

    def _fail_or_heal(self, err: str, waves=()) -> None:
        """Route a wrecked wave: supervised recovery when the heal
        supervisor is armed and the engine is staying up, else the raw
        :meth:`_fail_all` sweep."""
        if (self._heal is None or self._stop.is_set()
                or self._draining.is_set()):
            self._fail_all(err, waves)
            return
        logger.warning("wave faulted (%s); recovering", err)
        self._heal_recover(err, waves)

    def _heal_record(self, err: str, verdicts: Dict[int, str],
                     **extra) -> None:
        """The flight recorder's "heal" record of one recovery."""
        if self._recorder is None:
            return
        counts: Dict[str, int] = {}
        for v in verdicts.values():
            counts[v] = counts.get(v, 0) + 1
        self._recorder.record(
            "heal", -1, {"error": err[:200], "state": self._heal.state,
                         "mode": self._heal.mode, **extra, **counts})

    def _heal_verdict(self, req: _Request, verdict: str, err: str) -> bool:
        """Apply one supervisor verdict: fail a convicted or exhausted
        request, else rewrite it for replay. True when it replays."""
        if verdict == "poison":
            self._fail_req(
                req, f"quarantined: request deterministically faults its "
                f"wave ({err[:160]})", kind="poison", retriable=False)
            return False
        if verdict == "exhausted":
            self._fail_req(
                req, f"resurrection budget exhausted (heal_max_retries="
                f"{self._heal.max_retries}): {err[:160]}",
                kind="internal", retriable=False)
            return False
        return self._prepare_resurrect(req)

    def _heal_recover(self, err: str, waves=()) -> None:
        """Supervised wave-fault recovery. The wrecked cohort goes through
        the supervisor — resurrect / pen (bisection hold or retry backoff)
        / poison / exhausted — the convicted fail, the innocents are
        rewritten for replay, the device state is rebuilt, and the
        replays re-enter the FRONT of the admission queue in ascending rid
        order, ahead of fresh traffic. A request already parked by an
        earlier recovery (in _waiting or the pen) that a stale in-flight
        wave still references is not wrecked again."""
        heal = self._heal
        if self._san is not None:
            self._san.assert_holds("_book")
        now = time.perf_counter()
        live = self._gather_wrecked(waves)
        parked = {r.rid for r in self._waiting}
        parked.update(r.rid for r in heal.pen_scan())
        verdicts = heal.plan_recovery(
            [rid for rid, r in live.items()
             if not r.finished and rid not in parked], now)
        self._heal_record(err, verdicts)
        # Terminal verdicts and replay rewrites run BEFORE the rebuild:
        # _fail_req unrefs blocks and trie pins into the old pool, which
        # the rebuild then discards wholesale.
        queue_front: List[_Request] = []
        pen: List[_Request] = []
        for rid in sorted(verdicts):
            req = live[rid]
            if req.finished:
                continue
            if self._heal_verdict(req, verdicts[rid], err):
                (pen if verdicts[rid] == "pen" else queue_front).append(req)
        self._rebuild_device_state()
        for req in reversed(queue_front):
            self._waiting.appendleft(req)
            heal.note_resurrected()
        for req in pen:
            heal.pen_put(req, now)

    def _prepare_resurrect(self, req: _Request) -> bool:
        """Detach a wrecked-but-innocent request from the device state and
        rewrite it for replay: the tokens the client already holds fold
        into the prompt (positions stay absolute, so the sampling keys are
        the unfaulted run's), the budget shrinks by them, and the request
        re-enters the normal admission path as if freshly submitted.
        False when it reached a terminal state here instead (fully
        delivered, or the folded prompt can no longer be admitted)."""
        fold = req.gen_hist[req.replayed:]
        if fold:
            req.tokens = list(req.tokens) + fold
            req.replayed += len(fold)
            remaining = req.params.max_new_tokens - len(fold)
            if remaining <= 0:
                # The client already holds every token the budget buys.
                self._complete(req)
                return False
            req.params = dataclasses.replace(req.params,
                                             max_new_tokens=remaining)
        if len(req.tokens) > max(self._buckets):
            self._fail_req(
                req, f"resurrection impossible: folded prompt "
                f"{len(req.tokens)} exceeds max bucket {max(self._buckets)}",
                kind="internal", retriable=True)
            return False
        if self._paged:
            need = -(-len(req.tokens) // self._kv_block)
            if need > self._num_blocks - 1:
                self._fail_req(
                    req, f"resurrection impossible: folded prompt needs "
                    f"{need} kv blocks but the pool holds "
                    f"{self._num_blocks - 1}",
                    kind="internal", retriable=True)
                return False
        # Detach from the device state. Paged block refs and trie handles
        # just drop (the pool is rebuilt, or the group path released
        # them); a dense prefix pin is released into the index.
        if req.prefix_handle is not None and self._prefix is not None:
            self._prefix.release(req.prefix_handle)
        req.prefix_handle = None
        req.prefix_len = None
        req.block_ids = []
        req.slot = -1
        req.expected = 0
        req.n_generated = 0
        req.prefilling = False
        req.prefill_done = 0
        return True

    def _heal_tick(self) -> None:
        """Boundary-time heal bookkeeping: reap cancelled / expired
        requests parked in the pen (the regular reap cannot see them),
        then release due pen entries to the front of the queue. Draining
        or stopping flushes the pen so shutdown strands nothing."""
        heal = self._heal
        now = time.perf_counter()
        for req in heal.pen_scan():
            if req.finished:
                continue
            if req.cancelled:
                with self.stats.lock:
                    self.stats.cancelled_total += 1
                self._fail_req(req, f"cancelled after {req.replayed} tokens",
                               kind="cancelled")
                heal.pen_drop(req.rid)
            elif req.deadline is not None and now >= req.deadline:
                with self.stats.lock:
                    self.stats.deadline_expired_total += 1
                self._fail_req(
                    req, f"deadline exceeded after {req.replayed} tokens",
                    kind="deadline")
                heal.pen_drop(req.rid)
        flush = self._draining.is_set() or self._stop.is_set()
        for req in heal.pen_take(now, flush=flush):
            self._waiting.appendleft(req)
            heal.note_resurrected()

    def _heal_requeue_group(self, reqs: List[_Request], err: str) -> bool:
        """The admission-group fault path with the supervisor armed. A
        failed group never ran its kernels, so nothing is rebuilt: the
        group's slots, blocks and pins go back to the LIVE pool and each
        request takes the supervisor's verdict. False (the caller fails
        the group) when heal is off or the engine is going down."""
        if (self._heal is None or self._stop.is_set()
                or self._draining.is_set()):
            return False
        heal = self._heal
        now = time.perf_counter()
        by_rid = {r.rid: r for r in reqs}
        verdicts = heal.plan_recovery(
            [r.rid for r in reqs if not r.finished], now)
        self._heal_record(err, verdicts, site="admit")
        queue_front: List[_Request] = []
        for rid in sorted(verdicts):
            req = by_rid[rid]
            if req.finished:
                continue
            slot = req.slot
            if slot >= 0:
                if self._slots[slot] is req:
                    self._slots[slot] = None
                    self._active_host[slot] = False
                    self._free.append(slot)
                elif slot not in self._free:
                    self._free.append(slot)  # popped, never registered
            try:
                self._prefilling.remove(req)
            except ValueError:
                pass
            if self._paged:
                self._release_blocks(req)
            if req.prefix_handle is not None:
                (self._paged_prefix or self._prefix).release(
                    req.prefix_handle)
                req.prefix_handle = None
            if self._heal_verdict(req, verdicts[rid], err):
                if verdicts[rid] == "pen":
                    heal.pen_put(req, now)
                else:
                    queue_front.append(req)
        for req in reversed(queue_front):
            self._waiting.appendleft(req)
            heal.note_resurrected()
        return True

    def _live_wave_rids(self) -> List[int]:
        """The rids riding a whole-batch (decode / ragged / verify) wave:
        the sticky chaos fault's membership test."""
        return [r.rid for r in self._slots
                if r is not None and not r.finished]

    def _chaos_dispatch(self, site: str, rids: Sequence[int] = ()) -> None:
        """Dispatch-fault injection point, live ONLY on the scheduler
        thread: warmup and direct calls share the dispatch helpers and
        must neither fault nor consume draws. `rids` is the wave's
        membership, for the sticky fault."""
        if self._san is not None and (
                threading.current_thread() is self._thread):
            self._san.perturb("dispatch")
        if self._chaos is None or (
                threading.current_thread() is not self._thread):
            return
        try:
            self._chaos.on_dispatch(site, rids)
        except Exception:
            # Pin the injected fault to the timeline before it unwinds
            # the scheduler iteration.
            if self._recorder is not None:
                self._recorder.record("chaos", -1, {"site": site})
            raise

    def _rebuild_device_state(self) -> None:
        self._wave_epoch += 1
        B = self.ecfg.max_slots
        self._slots = [None] * B
        self._free = list(range(B))
        self._active_host[:] = False
        self._prefilling.clear()
        if self._spec:
            self._spec_wave = None
        if self._paged:
            self._allocator = self._new_allocator()
            with self.stats.lock:
                self.stats.pool_gauges = self._allocator.snapshot
            self._table_host[:] = 0
            if self._paged_prefix is not None:
                # A fresh trie over the fresh allocator.
                self._paged_prefix = self._new_prefix_index()
        elif self._prefix is not None:
            # The workers drop their spans with their fresh state.
            self._prefix = self._new_dense_index()
        # Waiting requests drop their handles into the old trie and look
        # up again.
        for req in self._waiting:
            req.prefix_handle = None
            req.prefix_len = None
            req.block_ids = []
        if self._san is not None:
            # The fresh allocator and tries carry fresh raw locks.
            graftsan.rewrap_pool(self, self._san)
        if self._programs is not None and self._programs.home is not None:
            # The captured programs hold the state's addresses: reset it
            # in place (stream-ordered behind any wave in flight), so they
            # stay valid and a recovery captures nothing anew.
            reset_state(self._programs.home)
            self._state = self._programs.state()
            return
        self._state = None  # free the old cache before the new one lands
        self._state = self._fresh_state()

    # --- the scheduler loop -----------------------------------------------------

    def _dispatch_once(self) -> Optional[_PendingWave]:
        self._dispatch_wreck = None
        if self._roof is not None:
            self._step_t0 = time.perf_counter()
        self._reap_lifecycle()
        if self._ragged:
            work = self._dispatch_ragged()
        elif self._spec:
            work = self._dispatch_spec()
        else:
            work = self._dispatch_bucketed()
        self._dispatch_wreck = None
        return work

    def _loop_async(self) -> None:
        """Scheduler loop under ``async_fetch``: each iteration dispatches
        ONE boundary and hands it to :meth:`_fetch_loop`, so the scheduler
        never waits for the device. A boundary stays in ``_inflight`` from
        its dispatch until the fetcher retires it, so the error path fails
        the requests that live only in its groups and roster."""
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
                    self._fail_or_heal(str(e), [wreck])
                continue
            if work is not None:
                if self._profile_n:
                    self._profile_tick()
                # Blocks outside the lock while the queue is full; the
                # fetcher keeps draining it.
                self._fetch_q.put(work)
            elif self._pending.empty():
                self._note_idle()
                time.sleep(self.ecfg.idle_sleep_s)

    def _fetch_loop(self) -> None:
        """Fetcher thread: waits for each boundary's results OUTSIDE the
        bookkeeping lock (the scheduler dispatches meanwhile), then runs
        its bookkeeping under it. A boundary from before a device-state
        rebuild is dropped unread."""
        while True:
            wave = self._fetch_q.get()
            if wave is None:
                return
            try:
                if wave.epoch == self._wave_epoch:
                    if self._san is not None:
                        self._san.perturb("boundary")
                    if self._chaos is not None:
                        self._chaos.maybe_slow_boundary()
                    f0 = time.perf_counter()
                    arrays = self._fetch_boundary(wave)
                    f1 = time.perf_counter()
                    with self._book:
                        # A rebuild that raced the fetch makes the wave
                        # stale: _process_boundary drops it.
                        self._process_boundary(wave, (arrays, f0, f1))
            except Exception as e:
                logger.exception("boundary fetch failed")
                with self._book:
                    # A wave a rebuild made stale while it was fetched was
                    # gathered by that rebuild's recovery already.
                    if wave.epoch == self._wave_epoch:
                        self._fail_or_heal(str(e))
            finally:
                with self._book:
                    self._inflight = [w for w in self._inflight
                                      if w is not wave]

    def _loop_sync(self) -> None:
        """Without ``async_fetch``: each iteration dispatches ONE boundary
        (a ragged wave, or admissions plus a decode chunk), then reads the
        previous one — the pipeline is one boundary deep. Requests
        recycled out of _slots live in `pending`'s roster and the dispatch
        wreck, so the error path fails both. The spec engine runs
        :meth:`_loop_sync_spec` instead."""
        if self._spec:
            self._loop_sync_spec()
            return
        pending: Optional[_PendingWave] = None
        while not self._stop.is_set():
            try:
                with self._book:
                    work = self._dispatch_once()
                    if pending is not None:
                        self._process_boundary(pending)
                    pending = work
                    idle = pending is None and not self._active_host.any()
                if self._profile_n and pending is not None:
                    self._profile_tick()
                if idle and self._pending.empty():
                    self._note_idle()
                    time.sleep(self.ecfg.idle_sleep_s)
            except Exception as e:  # fail requests, reset, keep serving
                logger.exception("engine iteration failed")
                with self._book:
                    wreck, self._dispatch_wreck = self._dispatch_wreck, None
                    self._fail_or_heal(str(e), [pending, wreck])
                pending = None
        if pending is not None:
            try:
                with self._book:
                    self._process_boundary(pending)
            except Exception as e:
                logger.exception("final boundary failed")
                with self._book:
                    self._fail_all(str(e), [pending])

    def _loop_sync_spec(self) -> None:
        """The spec loop, UNPIPELINED: every boundary is processed before
        the next dispatch, because the next wave depends on this one's
        acceptance three ways — the drafter reads the emitted history,
        block growth sizes k + 1 positions from the resynced expected,
        and rollback trims the tables the next dispatch uploads."""
        while not self._stop.is_set():
            work = None
            try:
                with self._book:
                    work = self._dispatch_once()
                    if work is not None:
                        self._process_boundary(work)
                    idle = work is None and not self._active_host.any()
                if self._profile_n and work is not None:
                    self._profile_tick()
                if idle and self._pending.empty():
                    self._note_idle()
                    time.sleep(self.ecfg.idle_sleep_s)
            except Exception as e:  # fail requests, reset, keep serving
                logger.exception("engine iteration failed")
                with self._book:
                    wreck, self._dispatch_wreck = self._dispatch_wreck, None
                    self._fail_or_heal(str(e), [wreck, work])
