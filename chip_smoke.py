#!/usr/bin/env python3
"""Chip smoke of seldon_tpu_torch, the PyTorch/CUDA port, on one NVIDIA
card: serves Llama-3-8B generation through the ragged wave on the
hand-written CUDA ragged-paged-attention kernel (B1) with bf16 weights,
int8 weights and W8A8, with and without the prefix cache, and from an HF
checkpoint and orbax checkpoint directories on disk; through the
bucketed and dense engines, whose cold admissions run the hand-written
CUDA flash-attention kernel (B2); with
speculative decoding, whose verify waves run B1; at tp = 2 (two ranks
on the one card, B1 on each); from SeldonDeployments reconciled by the
port's control plane into unit and engine processes (B1 in the pods);
and scores and generates with the whole-batch path on B2; and serves
and scores a float32 Llama-3-8B on B1's and B2's f32 routes.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and
prints no result):
 1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
 2. build: nvcc compiles ``seldon_tpu_torch/csrc/ragged_paged_attention.cu``
    (B1's bf16 route), ``ragged_paged_attention_f32.cu`` (B1's f32 route:
    CUDA cores below 64 rows, 3xTF32 tensor cores from 64 up),
    ``flash_attention.cu`` (B2's bf16 route, tensor cores) and
    ``flash_attention_f32.cu`` (B2's f32 route, 3xTF32 tensor cores) for
    sm_90a from the checkout, all in parallel (nvcc seconds and ptxas'
    registers and spills printed; for each 3xTF32 instance its registers,
    spills and dynamic shared memory, and any spill fails the phase);
 3. B1 versus its plain version: ``partials_kernel`` against the plain
    ``partials_sparse`` on the card at the two llama3-8b shapes of the
    serving path (decode R = 4 rows on the split-KV decode route, prefill
    R = 512 rows on the tensor-core route; 32 slots, Dh 128, block 16,
    128-block tables), bf16 queries against bf16 and int8 pools and f32
    queries (B1's f32 route, held to 1e-5: ``TOL_*_F32``) against f32 and
    int8 pools, ragged bounds with a bound = 0 slot and table tails at the
    trash block 0. The kernel is timed by
    CUDA-graph replay (20 calls captured, so the host's time between
    launches is not in it), and eagerly through its wrapper
    (``wrapper_ms``, host time included); the plain version with CUDA
    events; the byte and operation bounds are computed from the same
    inputs;
 3b. B2 versus its plain version: ``flash_kernel`` against the plain
    ``flash_blockwise`` on the card at llama3-8b heads (H 32, Hkv 8, Dh
    128): the score shape (B 2, S 4096), B 1 S 8192, the generate-prefill
    shape (B 8, S 512; bf16 and f32), a ragged tail (Sq 200, Skv 1000,
    q_offset 800), full attention (Sq = Skv = 1000) and two tile edges
    (Sq 129 Skv 1000 q_offset 127; Sq 1 Skv 129 q_offset 128). Timed with
    CUDA events beside ``F.scaled_dot_product_attention`` (the library
    yardstick, used nowhere in the port), with achieved TFLOP/s and the
    share of the bound computed from the shapes; bf16 outputs are also
    compared, for the record and ungated, with the plain version whose
    scores are summed by an f32 GEMM (see ``phase_flash_kernel``);
 3c. B2's f32 route through its entry point: the dispatch
    ``flash_attention`` on f32 tensors at the generate-prefill shape
    launches the f32 kernel once and agrees with the plain version
    (the f32 model's own path runs it in phase f32 (b));
 9n. train (run after 3b, before phase 4 loads a model): the port's
    training step (``models/train.py``). (a) llama3-8b at full width and
    depth, bf16, one rank, remat on, in a fresh process (``--train-8b``):
    ``make_optimizer(total_steps=10)`` and 3 steps on one repeated B 1 x
    S 512 batch; step 1 (lr 0) leaves every weight's bits, step 2's
    update moves no element by more than its learning rate allows (the
    share of elements moved and the first-order loss change it predicts
    reported), losses finite and descending (again with warmup=1 if the
    warm-up-sized steps do not move bf16 weights); peak memory, step
    seconds and tokens/s reported. (b) tiny and tiny-moe on the card
    against the CPU from one carried state, first-step gradients
    included. (c) two ranks sharing the card: dp, tp, sp (ring and
    "xla"), ep (tiny-moe) and pp (M = 2) at 2, each within (b)'s
    tolerances of the one-rank step, each rank's first-step gradients
    against the one-rank gradients cut to it, every replicated leaf
    bit-equal on both ranks. (d) the training route under
    ``attn_impl="flash"`` raises (B2 has no backward). (e) float32
    training: (e1) llama3-8b at full width and TRAIN_F32_LAYERS layers
    in f32 in (a)'s process once (a)'s tensors are freed, TF32 off, step
    1 leaving every weight's bits, losses descending, the peak gated;
    (e2) tiny and tiny-moe in f32 on the card against the CPU; (e3) the
    two-rank layouts of (c) in f32 against (e2), in (c)'s group;
 f32 (run after 9n, before phase 4): a float32 llama3-8b (ROADMAP.md
    A30) in a fresh process (``--f32-8b``), after A16's layer-by-layer
    int8 init (``quantize.init_params_int8``: its peak memory at most 1.05
    x the int8 tree plus its largest f32 draw). (a) the seeded f32 model
    at full depth through ``InferenceEngine(ragged, paged, chunked,
    ragged_kernel="pallas")`` answers phase 4's 8 requests: B1's f32 route
    launched exactly layers x wave legs, then every launch of a second
    burst held to its plain version; tokens/s, TTFT, weight bytes, peak
    memory reported. (b) one ``forward`` at B 1 x S 2048 under
    ``attn_impl="flash"``: 32 launches of B2's f32 route, each held to its
    plain version. (c) the legs on the weights cut to 2 layers: the kernel
    leg within 2x the f32 nudge floor of the masked leg; greedy streams of
    the kernel and masked legs at 2 and 32 layers reported (see
    ``f32_8b``);
 4. serve: ``TorchServer(preset="llama3-8b", ragged=1,
    ragged_kernel="pallas")`` at full width (32 layers, random weights
    from a seeded generator) answers 8 concurrent ``generate`` requests
    (prompts of 16-400 tokens, 32 new tokens, 6 greedy, 2 sampled); the
    kernel's launch counter must rise by exactly one launch per layer per
    wave leg that ran;
 5. where the time goes, and 5b. B1 on the burst's own inputs: the
    burst of phase 4 once more under ``torch.profiler`` (device busy time
    and idle share, the kernels and host operations that take the most
    time, see ``profile_summary``); B1's device time by wave leg from the
    profiler's
    kernel records (the decode route's merge included), its host time per
    wrapper call, and its bound computed from its inputs (see
    ``phase_burst_kernel``); then the burst under a block budget
    (``budget_burst``): legs over it on the masked head, the others on
    B1, both counted from the legs' own descriptors;
 6. legs on the same weights: the 6 greedy requests again through the
    masked leg, the masked leg with a one-ulp nudge, the kernel leg, the
    reference leg (the kernel leg's one-pass math through the plain
    full-width oracle) and the sparse leg (the masked-matched walk), with
    the weights cut to 2 and to CUT_LAYERS layers. Streams
    and logits of every pair are reported; at every depth the kernel leg
    must stay closer to the reference leg, and the sparse leg to the
    masked leg, than the one-ulp nudge moves the masked leg; then the
    kernel leg alone at full depth reproduces phase 4's streams, the
    kernel held to its plain version on its own inputs (see
    ``phase_legs``);
 7. score: ``score_nll`` (the scorer behind ``TorchServer.predict``) on
    the served weights at full depth with ``attn_impl="flash"``, B 2 x
    S 4096 token ids: B2 launches exactly once per layer, all on the
    tensor-core route; its outputs at the first, middle and last layer
    agree with the plain version; the logits stay as close to the
    ``"xla"`` path's as twice what a one-ulp nudge moves them; one more
    call under ``torch.profiler`` names the device kernels that take the
    call's time (see ``phase_score``);
 8. generate: the whole-batch ``generate`` (cold prefill + dense decode)
    on the same weights, 8 prompts of 64-512 tokens, 32 greedy tokens:
    B2 launches exactly once per layer (the prefill; decode steps have
    S = 1); streams against the ``"xla"`` config are reported;
 9. predict: ``TorchServer.predict`` on B 2 x S 512 (the preset's
    ``"xla"`` attention, as in JAX) returns finite NLLs;
 9a. cut: phases 9b to 9g run on phase 4's weights cut to their first
    CUT_LAYERS layers at full width (``cut_server``: phase 4's server
    on the cut answers phase 4's 8 requests once, B1 launched layers x
    wave legs; its streams and tokens/s are what 9b-9g compare with, and
    phase 6's floor at CUT_LAYERS layers is theirs); 9l (b) runs on the
    same cut; 10, 9l (c) and (e) and 9m serve the full depth;
 5d. captured_families (run after 9a's cut and 5c (b)): every other
    family of a single-rank engine as captured programs
    (``servers/wave_program.py``) at CUT_LAYERS on phase 4's requests:
    the bucketed (a) paged, (b) dense and (c) chunked engines under
    ``attn_impl="flash"`` (B2 inside the cold admission programs) and
    the spec engine on B1's kernel leg with the n-gram drafter and the
    target as its own draft model (B1 inside the verify programs), each
    eagerly (``wave_program.disabled()``) and captured with heal armed:
    first-token logits and streams bit-equal, B1 and B2 launched as
    often on both routes (layers x cold admissions, layers x verify
    waves), the dispatched keys (KeySpy) equal and in the lattice, no
    program dropped; then, for (a) and the n-gram engine, one profiled
    burst per route on warmed engines (idle share, tokens/s, host launch
    calls per dispatch, capture ms, the graph pool against the largest
    eager peak; report only; they replace 9e's and 9f's profiled bursts;
    see ``phase_captured_families``). Every single-rank engine
    of the later phases runs its families as captured programs: 9e's
    and 9f's gates hold on that route;
 9b. wire: the serving runtime (``seldon_tpu_torch/runtime``) in front of
    a llama3-8b ``TorchServer`` on B1's kernel leg with phase 4's weights,
    over real sockets: the transport libraries found here and the
    transports driven on their own lines; three greedy prompts one at a
    time give equal tokens in-process and over REST ``/generate``, NDJSON
    ``/generate_stream``, gRPC ``Generate`` and ``GenerateStream``, with
    B1 launched layers x wave legs; the fast lane's ``predict`` equals the
    in-process one; phase 4's burst over NDJSON (tokens/s and the client's
    time to the first line, reported); a hung-up stream is cancelled
    within 5 s with a clean audit; ``/metrics`` and ``/ready`` before and
    after ``drain()`` (see ``phase_wire``);
 9c. graph: the orchestrator (``seldon_tpu_torch/orchestrator``) in front
    of phase 4's llama3-8b server as a unit (REST, gRPC, the fast lane):
    five graph shapes (a solo MODEL on the sync lane over the fast lane, a
    solo MODEL over REST proto and JSON, an A/B test and an average
    combiner over the unit reached over gRPC and REST, and the solo graph
    behind the micro-batcher); every answer bit-equal to ``srv.predict``
    on the same rows (a fused one to its rows of the fused call), the
    walked units in ``requestPath``, feedback and readiness; p50 / p95
    per graph and transport beside direct unit calls (see
    ``phase_graph``);
 9h. load (run after 9c): the port's ``SeldonClient`` (REST, rest-proto,
    gRPC; ``generate``, ``generate_stream``, ``microservice``) and
    contract tester against a server of phase 4's configuration, answers
    equal to the in-process ones; the port's loadtester, 8 streaming
    clients for 10 s with cancels and deadlines, its outcomes reconciled
    with the engine's counters, a clean audit; the orchestrator under 8
    predict clients against g1 and the bare unit (reported); an
    epsilon-greedy ROUTER unit learning to route to the rewarded branch
    (see ``phase_load``);
 9i. heal: the JAX heal audit's seeded storm healed by the supervisor,
    on ``tiny`` (streams equal to a clean engine's, near-ties reported)
    and on llama3-8b through a ``HEAL=1 CHAOS=1`` server with the
    loadtester beside it (tokens before each first fault equal to a
    clean run's, every error a supervisor verdict, no request stalled,
    health back to healthy, B1 held to its plain version on replay
    waves; see ``phase_heal``);
 9j. sanitize (run after 9i): the runtime sanitizer (``GRAFTSAN=1``)
    armed on phase 4's engine and weights, phase 4's 8 requests queued at
    once: every stream equal to the unarmed engine's on the same
    schedule, zero violations, an audit per wave, perturb sleeps taken,
    B1 launches = layers x wave legs, a clean audit (9i's storm runs
    armed too, with zero violations; see ``phase_sanitize``);
 9k. prepackaged: the XGBoost server on a HIGGS-width ``model.json``
    (cursors bit-equal to a numpy walk, rows/s), the SKLearn server on an
    MNIST-shape ``model.npz``, the isolation forest, VAE and Seq2Seq-LSTM
    detectors at KDD Cup 99's width (card vs CPU), integrated gradients
    over the sklearn head, and a detector-in-front-of-model graph behind
    the port's orchestrator (see ``phase_prepackaged``);
 9d. prefix: the prefix cache on B1's kernel leg (``prefix_cache=True``)
    with phase 4's weights and engine configuration: a shared prompt of
    1024 token ids, one priming request, then 8 requests (shared prompt
    + suffixes of 16-400 tokens, 32 greedy tokens) at once, against the
    same requests served cold: prefix counters exact (8 hits, 8 x 1024
    tokens saved, 8 zero-copy admissions, no copy), B1 launched layers x
    wave legs, clean leak audits, every stream equal and every logits row
    bit-equal to the cold run's; TTFT, prefill waves and tokens/s cold
    against warm reported. A copy-on-write round (kv_block 32,
    prefix_block 16, a shared prompt of 1040 tokens): 8 copies, a direct
    copy bit-equal to its source, B1 held to its plain version over block
    ids that two rows share, warm logits within phase 6's nudge floor. A
    load round: the weights cut to 2 layers written as an HF Llama
    checkpoint under ``build/`` and served by
    ``TorchServer(model_uri=...)`` on the card: parameters bit-equal,
    three greedy requests with equal streams and bit-equal logits against
    the same cut served from memory; the load seconds and GB/s reported
    (see ``phase_prefix``). An orbax round (see ``orbax_round``): the
    committed JAX-written ``tiny`` orbax fixtures (bf16, int8) served by
    ``TorchServer(model_uri=...)`` on B1 with every leaf's SHA-256 and the
    greedy streams held to the fixture's record (near-ties reported); the
    weights cut to 1 layer written by the port's ``save_checkpoint`` and
    served from it bit-equal to memory; each tp = 2 rank's shard read from it
    bit-equal to the cut's slice; the zstd decoder's MB/s reported;
 9e. bucketed: the bucketed engine families (``ragged=False``) on phase
    4's weights (9a's cut) with ``attn_impl="flash"``, phase 4's 8
    requests: (a) ``paged_kv=True``, (b) the JAX engine's default, the
    dense slab (32 slots x 2048 positions), (c) paged with chunked
    prefill. B2 launches = layers x cold admissions; B2 held to its
    plain version on the admissions' own inputs; first-token logits of
    (a) and (b) within twice phase 6's nudge floor of the ragged kernel
    leg's; clean leak audits; tokens/s, TTFT, admission and decode
    dispatches reported (the engines' profiles: 5d; see
    ``phase_bucketed``);
 9f. spec: speculative decoding (``spec_decode=True, spec_k=4,
    ragged_kernel="pallas"``) with the n-gram drafter and with the
    target's weights cut to 2 layers as the draft model: B1 launches =
    layers x verify waves, B1 held to its plain version on the verify
    waves' own inputs (rows outside the wave included), the acceptance
    identities exact, the pool audited after every rollback, spec-on
    logits within twice the nudge floor of spec-off's; drafted /
    accepted / emitted per wave and tokens/s beside spec-off reported
    (see ``phase_spec``);
 9g. observatory: the engine's ledgers (flight recorder, compile
    ledger over the warmed shape lattice, dispatch timing, HBM, sched and
    roof ledgers, the pilot held) armed through the environment on a
    ``TorchServer`` with phase 4's weights, against the same server with
    none: the ragged burst on B1 and the bucketed burst (paged, flash)
    on B2, phase 4's 8 requests queued at once; dispatched keys and
    greedy streams equal on and off, every ``/debug/*`` payload fetched
    over REST with its frozen key sets, zero live retraces, clean
    conservation audits, the card's peak table, the HBM weights equal
    to the parameters' bytes, B1 and B2 launched layers x legs / cold
    admissions and held to their plain versions, host syncs not raised;
    tokens/s on and off, the roof totals and the profiler's idle share
    beside the ledger's device_frac reported (see
    ``phase_observatory``);
 10. int8: the same seeded weights quantized on the card by
    ``TorchServer(weight_dtype="int8")``, the 8 requests of phase 4
    served weight-only and then W8A8 (``torch._int_mm``) on B1's kernel
    leg: launches counted, layer 0's codes held to the CPU's and its W8A8
    products to an int64 product bit for bit, and B1 held to its plain
    version on the path's own inputs (see
    ``phase_int8``);
 9l. tp (run after 10, once phase 4's server is gone; its weights
    kept): exact tensor parallelism with two ranks sharing the card
    (``build_tp_mesh(2, ["cuda:0", "cuda:0"])``, one spawned worker,
    gloo staged through host memory, weights as CUDA IPC handles):
    (a) tiny on every engine family plus int8 KV and W8A8, tp = 2
    streams equal to tp = 1; (b) llama3-8b at full width (9a's cut),
    phase 9j's fixed-schedule burst on B1's kernel leg at tp = 2 against
    tp = 1: every wave's logits bit-equal (per wave: bit-equal share and
    max |logit diff| reported), every worker's slot state equal to rank
    0's, B1 held to its plain version on each rank's own inputs and
    launched layers x wave legs on each; (c) the group laid out as two
    'sp' ranks (``MeshPlan(sp=2)``): a B 1 x S 4096 score
    with ring attention against "xla", within the nudge floor
    (``RING_DRIFT_MAX``; see ``phase_tp``); (d) the dense prefix cache;
    (f) the sparse ragged leg and the spec engine's masked and kernel
    verify legs at 4 layers, every wave bit-equal to tp = 1
    (``phase_tp_sparse_verify``); (e) ``TorchServer(tp=2)`` at full
    depth, its weights per device from the shard shapes; (g) four ranks
    sharing the card on JAX's other serving plans, on (b)'s cut and
    burst: the auto plan (tp 4, through ``TorchServer._serving_mesh``)
    bit-equal to tp = 1, dp 2 x tp 2 with tp = 1's streams and logits
    bit-equal (on B1's leg and on the dense engine), sp 2 x tp 2 with the
    ring
    (score within ``RING_DRIFT_MAX``, a context-parallel admission's
    first token one device's), B1 on every rank (``phase_tp_plans``);
 9m. operator (run after 9l; phase 4's weights kept): the control plane
    (``seldon_tpu_torch/operator``): SeldonDeployments rendered by the
    port's ``render_template``, defaulted and validated by its webhook
    and reconciled by its ``Reconciler`` into its ``LocalProcessStore``,
    whose spawned unit and engine processes serve llama3-8b at full width
    on the card (phase 4's seed, a 512 MiB KV pool per pod): (a) the
    template's JAX_SERVER unit without a modelUri refused as in JAX, the
    unit named by image as the port's TorchServer reconciled to
    Available; (b) [1, 512] and [2, 512] predicts through the engine pod
    over REST and gRPC bit-equal to in-process, ``requestPath`` naming
    the unit; (c) three greedy prompts to the unit pod's gRPC
    ``Generate`` equal to in-process; (d) a rolling update to a
    ``chip_smoke_unit.B1ProbeServer`` pod: both generations alive and
    the old engine bit-equal during it, the stale pods gone and their
    memory back after it, (b) and (c) equal again and B1 launched layers
    x wave legs inside the pod and held to its plain version there
    (reported through ``meta.metrics``); (e) the prepackaged JAX_SERVER
    route with a ``file://`` modelUri at 9d's 2-layer checkpoint through
    the model initializer, streams equal to the cut in process; (f) no
    pod left after ``delete_all``, the memory back. Spawn-to-ready
    seconds and free card memory at each step reported (see
    ``phase_operator``);
 11. noise: the engine's threefry bits on the card equal the CPU's over
    a 64 x 64 (seed, position) grid at the full vocabulary; Gumbel values
    within two ulps at their scale (see ``phase_noise``);
 12. MoE: ``tiny-moe`` served on the card on the kernel leg, B1 launches
    counted, logits held to the port on the CPU (see ``phase_moe``);
 13. the kernels line, then the last line
    ``{"ok": true, "device": {"platform": "gpu", ...}}``. Every phase
    prints its seconds.

Details of every phase go to ``chiprun_out/chip_smoke.json`` at the end,
and every line of the log to ``chiprun_out/chip_smoke.log`` as it runs.
"""

import contextlib
import dataclasses
import functools
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
TF32_OPS_PER_S = 495e12  # H100 SXM dense TF32 tensor-core rate
# Kernel vs plain version: both sum in f32, in another order, which moves
# results by a few f32 ulps (|acc / l| is ~0.05-0.3 here). 1e-4 is far
# above that and below what a kernel rounding p or acc to bf16 would give.
TOL_M = 1e-4  # absolute, on the running max m
TOL_L = 1e-4  # relative, on the exp-sum l
TOL_ACC = 1e-4  # absolute, on the normalised output acc / l
# B1's f32 route (float32 models) against its plain version, the plain
# version in f32 with TF32 off, the kernel in f32 FMA (decode) or 3xTF32
# (from 64 rows up: single-pass TF32 is never used): acc / l within 1e-5
# and l within 1e-5 relative. m, the max of dots of Dh f32 products that
# the kernel and the plain version's GEMM sum in other orders, within 1e-5
# relative to max(|m|, 1): a few ulps of m differ (measured on one H100,
# CUDA-core route: up to 1.43e-06 at |m| ~ 3.5, ~6 ulps), so one ulp, the
# first aim, does not hold.
TOL_M_F32 = 1e-5  # relative to max(|m|, 1)
TOL_L_F32 = 1e-5  # relative
TOL_ACC_F32 = 1e-5  # absolute, on acc / l
OUT_DIR = "chiprun_out"


# main() tees every line into OUT_DIR/chip_smoke.log, which outlives a
# run that a time limit cuts (its captured output may keep only the end).
_log_file = None


def log(msg: str) -> None:
    print(msg, flush=True)
    if _log_file is not None:
        _log_file.write(msg + "\n")
        _log_file.flush()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def graph_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device ms per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between two events, so that the
    host's time between launches is not in the number."""
    import torch

    fn()  # builds and warms up outside the capture
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def cuda_time_ms(fn, reps: int, warmup: int) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# ---------------------------------------------------------------------------
# Phase 3: the kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_inputs(cfg, kind, kv_dtype, B, nbs, block, dev, seed):
    """One pool layer and a wave's (q, table, bound) at the serving
    path's shapes. Pool blocks are scattered over the whole pool; table
    tails past each slot's live blocks point at the trash block 0."""
    import torch

    from seldon_tpu_torch.models import transformer

    gen = torch.Generator(device=dev).manual_seed(seed)
    Hkv, Dh, G = cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv
    NB = B * nbs + 1
    shape = (NB, Hkv, block, Dh)
    raw_k = torch.randn(shape, generator=gen, device=dev).bfloat16()
    raw_v = torch.randn(shape, generator=gen, device=dev).bfloat16()
    if kv_dtype == "int8":
        kq, ks = transformer._quantize_kv(raw_k)
        vq, vs = transformer._quantize_kv(raw_v)
        layer = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        layer = {"k": raw_k, "v": raw_v}
    del raw_k, raw_v
    Smax = nbs * block
    if kind == "decode":
        Sq = 1
        bounds = torch.randint(1, Smax, (B,), generator=gen, device=dev)
    else:  # a prefill wave: bound = chunk start, chunk-aligned
        Sq = 128
        bounds = torch.randint(0, Smax // Sq, (B,), generator=gen,
                               device=dev) * Sq
    bounds[0] = 0  # an idle / empty slot: exactly (NEG_INF, 0, 0)
    bounds[1] = Smax - (1 if kind == "decode" else Sq)
    perm = torch.randperm(NB - 1, generator=gen, device=dev) + 1
    table = torch.zeros((B, nbs), dtype=torch.int32, device=dev)
    live = (bounds + block - 1) // block
    cols = torch.arange(nbs, device=dev)[None, :]
    table = torch.where(cols < live[:, None],
                        perm[:B * nbs].view(B, nbs).int(), table)
    bound = bounds[:, None].expand(B, Sq).int().contiguous()
    q = torch.randn((B, Sq, Hkv, G, Dh), generator=gen,
                    device=dev).bfloat16()
    return q, layer, table, bound


def kernel_bounds(q, layer, table, bound):
    """(bytes, operations) the partials need at these inputs: every input
    read once (live K/V blocks and scales only), every output written
    once; QK and PV products over the live positions of every row."""
    import torch

    block = layer["k"].shape[2]
    return bounds_from(q.shape, q.element_size(), bound.numel(),
                       block, layer["k"].element_size(), "k_scale" in layer,
                       int(((bound.amax(dim=1) + block - 1) // block).sum()),
                       int(bound.to(torch.int64).sum()))


def bounds_from(q_shape, q_elem, n_bound, block, kv_elem, scaled,
                live_blocks, bound_sum):
    """kernel_bounds from the inputs' shapes and two data-dependent
    counts: the live pool blocks and the sum of the bounds."""
    B, Sq, Hkv, G, Dh = q_shape
    nbytes = B * Sq * Hkv * G * Dh * q_elem + n_bound * 4
    nbytes += live_blocks * 4  # table entries read
    nbytes += 2 * live_blocks * Hkv * block * Dh * kv_elem
    if scaled:
        nbytes += 2 * live_blocks * Hkv * block * 2
    rows = B * Hkv * G * Sq
    nbytes += rows * 4 * 2 + rows * Dh * 4  # m, l, acc
    return nbytes, 4 * Dh * Hkv * G * bound_sum


def compare_partials(got, want, bound, m_rel=False):
    """Max errors (m abs, or with ``m_rel`` relative to max(|m|, 1); l
    rel; acc/l abs) on live rows; dead rows (bound = 0) must be exactly
    (NEG_INF, 0, 0)."""
    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    gm, gl, ga = got
    wm, wl, wa = want
    for t in got:
        if not torch.isfinite(t).all():
            raise AssertionError("kernel output is not finite")
    live = (bound > 0)[:, None, None, :, None].expand_as(gm)  # [B,1,1,Sq,1]
    dead = ~live
    if not (torch.all(gm[dead] == rpa.NEG_INF) and torch.all(gl[dead] == 0)
            and torch.all(ga[dead.expand_as(ga)] == 0)):
        raise AssertionError("a bound = 0 row is not (NEG_INF, 0, 0)")
    def worst(diff):
        return torch.where(live.expand_as(diff), diff.abs(), 0).max().item()

    err_m = worst((gm - wm) / (wm.abs().clamp(min=1.0) if m_rel else 1.0))
    err_l = worst((gl - wl) / wl.clamp(min=1e-30))
    err_acc = worst(ga / gl.clamp(min=1e-30) - wa / wl.clamp(min=1e-30))
    return err_m, err_l, err_acc


def f32_partials_ok(err):
    """B1's f32 route within its tolerances (``compare_partials`` with
    ``m_rel``)."""
    return (err[0] <= TOL_M_F32 and err[1] <= TOL_L_F32
            and err[2] <= TOL_ACC_F32)


def f32_bounds(t_bytes, ops, kv_dtype):
    """The two bounds of an f32 route's work: the f32 CUDA-core one (ops
    at 67 TFLOP/s; the route before the tensor cores, kept for
    continuity) and the 3xTF32 tensor-core one (3 passes at 495 TFLOP/s,
    2 against an int8 pool, whose codes need no lo term), each the larger
    of its operations' time and the bytes' time."""
    passes = 2 if kv_dtype == "int8" else 3
    f32_ops = ops / F32_OPS_PER_S * 1e3
    tf32_ops = passes * ops / TF32_OPS_PER_S * 1e3
    return {"bound_f32_ms": max(t_bytes, f32_ops),
            "bound_f32_by": "bytes" if t_bytes >= f32_ops else "operations",
            "bound_3xtf32_ms": max(t_bytes, tf32_ops),
            "bound_3xtf32_ops_ms": tf32_ops, "tf32_passes": passes,
            "bound_3xtf32_by": ("bytes" if t_bytes >= tf32_ops
                                else "operations")}


def f32_bounds_text(row, ms):
    """One log line's worth: an f32 route's time beside both bounds and
    its share of the 3xTF32 one, with the card."""
    return (f"ms={ms:.4f} bound_f32_cuda_cores_ms={row['bound_f32_ms']:.4f} "
            f"({row['bound_f32_by']}) bound_3xtf32_ms="
            f"{row['bound_3xtf32_ms']:.4f} ({row['bound_3xtf32_by']}, "
            f"{row['tf32_passes']} passes) share_of_3xtf32="
            f"{row['bound_3xtf32_ms'] / ms:.3f}; {card_line()}")


# Phase 3's rows: per query dtype, its pools at each shape; the bf16 rows
# first, in their order and with their seeds from before the f32 route.
KERNEL_ROWS = (("bf16", ("bf16", "int8")), ("f32", ("f32", "int8")))


def phase_kernel(cfg, dev):
    """B1 against its plain version at the serving path's two shapes
    (decode R 4, prefill R 512; 32 slots, 2048-position tables): bf16
    queries against a bf16 or int8 pool, and, for float32 models, f32
    queries against an f32 or int8 pool (B1's f32 route, held to the f32
    tolerances)."""
    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    B, block, nbs = 32, 16, 2048 // 16
    rows = []
    cases = [(qd, kind, kv) for qd, kvs in KERNEL_ROWS
             for kind in ("decode", "prefill") for kv in kvs]
    for q_dtype, kind, kv_dtype in cases:
        f32 = q_dtype == "f32"
        q, layer, table, bound = kernel_inputs(
            cfg, kind, "int8" if kv_dtype == "int8" else "bf16", B, nbs,
            block, dev, seed=len(rows) + 1)
        if f32:
            q = q.float()
            if kv_dtype == "f32":
                layer = {k: v.float() for k, v in layer.items()}
        got = rpa.partials_kernel(q, layer, table, bound)
        torch.cuda.synchronize()
        want = rpa.partials_sparse(q, layer, table, bound)
        err = compare_partials(got, want, bound, m_rel=f32)
        ok = (f32_partials_ok(err) if f32 else err[0] <= TOL_M
              and err[1] <= TOL_L and err[2] <= TOL_ACC)
        tol = ((TOL_M_F32, TOL_L_F32, TOL_ACC_F32) if f32
               else (TOL_M, TOL_L, TOL_ACC))
        ms = graph_time_ms(
            lambda: rpa.partials_kernel(q, layer, table, bound))
        wrapper_ms = cuda_time_ms(
            lambda: rpa.partials_kernel(q, layer, table, bound),
            reps=20, warmup=3)
        plain_ms = cuda_time_ms(
            lambda: rpa.partials_sparse(q, layer, table, bound),
            reps=3, warmup=1)
        nbytes, ops = kernel_bounds(q, layer, table, bound)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        R = q.shape[1] * q.shape[3]
        route = "decode" if R < rpa.PREFILL_ROWS else "prefill"
        bounds = f32_bounds(t_bytes, ops, kv_dtype) if f32 else {}
        # bf16's prefill math runs on the tensor cores; the f32 route's
        # least time is its 3xTF32 bound (below the CUDA cores' f32 one).
        t_ops = (ops / BF16_OPS_PER_S * 1e3 if not f32
                 else bounds["bound_3xtf32_ops_ms"])
        row = {
            "shape": kind, "dtype": q_dtype, "kv": kv_dtype,
            "q": list(q.shape), "rows_per_kv_head": R,
            "route": route if not f32 else f"f32 {route}",
            "n_split": (rpa.decode_split(nbs, block)[0]
                        if R < rpa.PREFILL_ROWS else 1),
            "live_positions": int(bound[:, 0].sum()),
            "err_m": err[0], "err_m_rel": f32, "err_l_rel": err[1],
            "err_acc": err[2], "ok": ok, "ms": ms,
            "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            **bounds,
        }
        if f32:
            row["share_3xtf32"] = row["bound_3xtf32_ms"] / ms
        rows.append(row)
        log(f"kernel {kind:7s} q={q_dtype} {kv_dtype:4s} R={R} "
            f"route={row['route']} n_split={row['n_split']} err "
            f"m{'_rel' if f32 else ''}={err[0]:.3g} (tol {tol[0]}) "
            f"l_rel={err[1]:.3g} (tol {tol[1]}) acc/l={err[2]:.3g} (tol "
            f"{tol[2]}) kernel_ms={ms:.4f} (graph replay) wrapper_ms="
            f"{wrapper_ms:.4f} plain_ms={plain_ms:.3f} "
            f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
            f"{'ok' if ok else 'FAIL'}")
        if f32:
            log(f"kernel {kind:7s} q=f32 {kv_dtype:4s} R={R}: "
                + f32_bounds_text(row, ms))
        del q, layer, table, bound, got, want
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    return rows


# ---------------------------------------------------------------------------
# Phase 3b: B2, the flash kernel, against its plain version
# ---------------------------------------------------------------------------

# The kernel keeps the plain version's rounding points; the two differ by
# f32 summation order only. f32 outputs: 1e-4 absolute (|out| <~ 1).
# bf16 outputs: each element within one bf16 ulp of the plain one.
TOL_FLASH_F32 = 1e-4
BF16_ULP = 2.0 ** -7
# (name, B, Sq, Skv, q_offset, causal, dtype); heads are llama3-8b's.
# Every shape is timed beside SDPA on the same inputs (a causal one with
# a q_offset on the keys its mask reaches, aligned bottom-right).
FLASH_SHAPES = (
    ("a_score", 2, 4096, 4096, 0, True, "bf16"),
    ("b_long", 1, 8192, 8192, 0, True, "bf16"),
    ("c_prefill", 8, 512, 512, 0, True, "bf16"),
    ("c_prefill", 8, 512, 512, 0, True, "f32"),
    ("d_tail", 1, 200, 1000, 800, True, "bf16"),
    ("d_full", 1, 1000, 1000, 0, False, "bf16"),
    ("e_edge", 1, 129, 1000, 127, True, "bf16"),
    ("e_edge", 1, 1, 129, 128, True, "bf16"),
)


def compare_flash(got, want):
    """B2's output against the plain version's: the worst absolute error,
    the share of elements that differ at all, and the gate (f32: 1e-4;
    bf16: |d| <= 2**-7 |plain| + 1e-5 everywhere)."""
    import torch

    g, w = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(g).all():
        raise AssertionError("B2 output is not finite or has the wrong "
                             "shape")
    d = (g - w).abs()
    out = {"max_abs_err": d.max().item(),
           "differ_share": (d > 0).float().mean().item()}
    if got.dtype == torch.float32:
        out["ok"] = out["max_abs_err"] <= TOL_FLASH_F32
    else:
        out["beyond_ulp"] = int((d > BF16_ULP * w.abs() + 1e-5).sum())
        out["ok"] = out["beyond_ulp"] == 0
    return out


def flash_work(q, k, causal, q_offset):
    """(bytes, operations) of one flash call: q read once and the output
    written once, k and v read once over the keys the mask reaches (under
    causal the first min(Skv, q_offset + Sq)); QK and PV products (4 Dh
    operations) over every (query, key) pair the mask lets through
    (exact causal count)."""
    import torch

    BH, Sq, Dh = q.shape
    BHkv, Skv, _ = k.shape
    if causal:
        i = torch.arange(Sq, dtype=torch.int64)
        pairs = int(torch.clamp(q_offset + i + 1, max=Skv).sum())
        keys = min(Skv, q_offset + Sq)
    else:
        pairs, keys = Sq * Skv, Skv
    return (2 * q.numel() + 2 * BHkv * keys * Dh) * q.element_size(), \
        4 * Dh * pairs * BH


def phase_flash_kernel(cfg, dev):
    import torch
    import torch.nn.functional as F
    from torch.nn.attention.bias import causal_lower_right

    from seldon_tpu_torch.ops import flash_attention as fa

    H, Hkv, Dh, G = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv
    rows = []
    for i, (name, B, Sq, Skv, off, causal, dt) in enumerate(FLASH_SHAPES):
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        gen = torch.Generator(device=dev).manual_seed(100 + i)
        q, k, v = (torch.randn((B * n, S, Dh), generator=gen,
                               device=dev).to(dtype)
                   for n, S in ((H, Sq), (Hkv, Skv), (Hkv, Skv)))
        got = fa.flash_kernel(q, k, v, causal, off, q_per_kv=G)
        torch.cuda.synchronize()
        want = fa.flash_blockwise(q, k, v, causal, off, q_per_kv=G)
        row = {"shape": name, "dtype": dt, "B": B, "H": H, "Hkv": Hkv,
               "Dh": Dh, "Sq": Sq, "Skv": Skv, "q_offset": off,
               "causal": causal}
        row.update(compare_flash(got, want))
        if dt == "bf16":  # for the record: scores summed by an f32 GEMM
            f32sum = compare_flash(got, fa.flash_blockwise(
                q, k, v, causal, off, q_per_kv=G, scores_f32=True))
            row["f32sum_beyond_ulp"] = f32sum["beyond_ulp"]
            row["f32sum_differ_share"] = f32sum["differ_share"]
        nbytes, ops = flash_work(q, k, causal, off)
        big = ops > 1e11
        row["ms"] = cuda_time_ms(
            lambda: fa.flash_kernel(q, k, v, causal, off, q_per_kv=G),
            reps=5 if big else 20, warmup=1 if big else 3)
        row["plain_ms"] = cuda_time_ms(
            lambda: fa.flash_blockwise(q, k, v, causal, off, q_per_kv=G),
            reps=2, warmup=1)
        # SDPA on [B, H, S, Dh] views: the library yardstick. Its causal
        # flag aligns the mask top-left, so a causal call with a q_offset
        # (or Sq != Skv) takes the keys the mask reaches, the first
        # q_offset + Sq, under a mask aligned bottom-right: the same
        # function, with no dense mask to keep SDPA off its flash route.
        q4, k4, v4 = (t.view(B, -1, t.shape[1], Dh) for t in (q, k, v))
        mask = None
        if causal and (off or Sq != Skv):
            if off + Sq > Skv:
                raise ValueError(f"B2 shape {name}: q_offset {off} + Sq {Sq}"
                                 f" past Skv {Skv}")
            k4, v4 = k4[:, :, :off + Sq], v4[:, :, :off + Sq]
            mask = causal_lower_right(Sq, off + Sq)

        def sdpa():
            return F.scaled_dot_product_attention(
                q4, k4, v4, attn_mask=mask,
                is_causal=causal and mask is None, enable_gqa=True)

        row["library_ms"] = cuda_time_ms(sdpa, reps=20, warmup=3)
        lib = sdpa().reshape(q.shape).float()
        row["library_max_abs_vs_plain"] = (
            lib - want.float()).abs().max().item()
        del lib
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        if dt == "bf16":
            t_ops = ops / BF16_OPS_PER_S * 1e3
        else:  # the least time: 3xTF32 on the tensor cores
            row.update(f32_bounds(t_bytes, ops, "f32"))
            t_ops = row["bound_3xtf32_ops_ms"]
        row.update(bytes=nbytes, ops=ops, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   tflops=ops / row["ms"] / 1e9)
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows.append(row)
        gate = (f"beyond one ulp {row['beyond_ulp']}; f32-sum oracle "
                f"{row['f32sum_beyond_ulp']}, differ_share "
                f"{row['f32sum_differ_share']:.2e}" if dt == "bf16"
                else f"tol {TOL_FLASH_F32}")
        lib_ms = ("-" if row["library_ms"] is None
                  else f"{row['library_ms']:.4f}")
        log(f"flash {name:9s} {dt:4s} B={B} Sq={Sq} Skv={Skv} "
            f"q_offset={off} causal={causal} max_abs={row['max_abs_err']:.3g}"
            f" differ_share={row['differ_share']:.2e} ({gate}) "
            f"kernel_ms={row['ms']:.4f} plain_ms={row['plain_ms']:.3f} "
            f"sdpa_ms={lib_ms} bound_ms={row['bound_ms']:.4f} "
            f"({row['bound_by']}) TFLOP/s={row['tflops']:.1f} "
            f"bound_share={row['bound_share']:.3f} "
            f"{'ok' if row['ok'] else 'FAIL'}")
        if dt == "f32":
            log(f"flash {name:9s} f32: " + f32_bounds_text(row, row["ms"]))
        del q, k, v, got, want
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B2 disagrees with its plain version: {bad}")
    return rows


def phase_flash_f32(cfg, dev):
    """B2's f32 route through its entry point: the dispatch
    ``flash_attention`` on f32 tensors at the generate-prefill shape (B 8,
    S 512, llama3-8b heads) launches the f32 kernel once, the bf16 one
    never, and agrees with the plain version."""
    import torch

    from seldon_tpu_torch.ops import flash_attention as fa

    H, Hkv, Dh, G = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv
    B, S = 8, 512
    gen = torch.Generator(device=dev).manual_seed(200)
    q, k, v = (torch.randn((B * n, S, Dh), generator=gen, device=dev)
               for n in (H, Hkv, Hkv))
    fa.reset_launches()  # count only this call's launches
    got = fa.flash_attention(q, k, v, causal=True, q_per_kv=G)
    torch.cuda.synchronize()
    by_entry = dict(fa.entry_launches)
    want = fa.flash_blockwise(q, k, v, True, 0, q_per_kv=G)
    out = dict(compare_flash(got, want), B=B, S=S,
               launches=by_entry["flash_attention_f32_fwd"],
               launches_bf16=by_entry["flash_attention_bf16_fwd"])
    log(f"flash f32 dispatch B={B} S={S} launches f32={out['launches']} "
        f"bf16={out['launches_bf16']} max_abs={out['max_abs_err']:.3g} "
        f"(tol {TOL_FLASH_F32}) {'ok' if out['ok'] else 'FAIL'}")
    if (out["launches"], out["launches_bf16"]) != (1, 0) or not out["ok"]:
        raise AssertionError(f"B2's f32 route through the dispatch: {out}")
    return out


# ---------------------------------------------------------------------------
# Phases 4 and 5: serve, then the masked leg on the same weights
# ---------------------------------------------------------------------------

PROMPT_LENS = (16, 48, 100, 150, 210, 270, 333, 400)
N_GREEDY = 6
MAX_NEW = 32


def requests(vocab):
    import numpy as np

    rng = np.random.default_rng(0)
    out = []
    for i, n in enumerate(PROMPT_LENS):
        req = {"prompt_token_ids": rng.integers(0, 256, n).tolist(),
               "max_new_tokens": MAX_NEW, "seed": 100 + i}
        if i < N_GREEDY:
            req["temperature"] = 0.0
        else:
            req.update(temperature=0.8, top_k=50, top_p=0.95)
        out.append(req)
    return out


def run_concurrent(fn, reqs, timeout_s):
    results = [None] * len(reqs)
    errors = []

    def go(i):
        try:
            results[i] = fn(reqs[i])
        except BaseException as e:  # reported below, never swallowed
            errors.append((i, repr(e)))

    threads = [threading.Thread(target=go, args=(i,)) for i in
               range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
    wall = time.perf_counter() - t0
    if any(t.is_alive() for t in threads):
        raise AssertionError("requests did not finish in time")
    if errors:
        raise AssertionError(f"requests failed: {errors}")
    return results, wall


def serve_server(dev):
    """Phase 4's server: llama3-8b seeded 0, 32 slots x 2048 positions,
    the ragged wave on B1's kernel leg."""
    from seldon_tpu_torch.servers.torchserver import TorchServer

    return TorchServer(preset="llama3-8b", max_slots=32, max_seq_len=2048,
                       ragged=1, ragged_kernel="pallas", init_seed=0,
                       device=dev)


def phase_serve(dev):
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    srv = serve_server(dev)
    t0 = time.perf_counter()
    srv.load()
    load_s = time.perf_counter() - t0
    cfg = srv.cfg
    reqs = requests(cfg.vocab_size)
    rpa.launches = 0  # count only the serving path's launches
    results, wall = run_concurrent(srv.generate, reqs, timeout_s=600)
    if not srv.engine.drain(timeout=60):
        raise AssertionError("engine did not go idle after the requests")
    launches = rpa.launches
    snap = srv.engine.stats.snapshot()
    srv.stop()
    waves, prefill_waves = snap["decode_dispatches"], snap["prefill_waves"]
    expected = cfg.n_layers * (waves + prefill_waves)
    toks = [r["token_ids"] for r in results]
    if any(not t for t in toks):
        raise AssertionError("a request returned no tokens")
    if any(not 0 <= x < cfg.vocab_size for t in toks for x in t):
        raise AssertionError("a token id lies outside the vocabulary")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != layers x legs "
                             f"{expected} (waves {waves}, prefill waves "
                             f"{prefill_waves})")
    n_tok = sum(len(t) for t in toks)
    log(f"serve {srv.preset} layers={cfg.n_layers} load_s={load_s:.1f} "
        f"requests={len(reqs)} waves={waves} prefill_waves={prefill_waves} "
        f"kernel_launches={launches} (expected {expected}) tokens={n_tok} "
        f"wall_s={wall:.3f} tokens_per_s={n_tok / wall:.1f} "
        f"mean_ttft_ms={snap['mean_ttft_ms']:.1f}")
    return srv, reqs, toks, {
        "load_s": load_s, "waves": waves, "prefill_waves": prefill_waves,
        "launches": launches, "tokens": n_tok, "wall_s": wall,
        "tokens_per_s": n_tok / wall, "mean_ttft_ms": snap["mean_ttft_ms"],
    }


def engine_bursts(params, cfg, ecfg, dev, reqs, to_sampling, n):
    """tokens/s of ``n`` bursts of ``reqs`` (at once, each after the last
    drained) through one engine on ``params``, after one untimed burst."""
    from seldon_tpu_torch.servers.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, ecfg, dev)
    eng.start()
    try:
        return more_bursts(eng, reqs, to_sampling, n + 1)[1:]
    finally:
        eng.stop()


def more_bursts(eng, reqs, to_sampling, n):
    out = []
    for _ in range(n):
        results, wall = run_concurrent(
            lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                            to_sampling(r)),
            reqs, timeout_s=600)
        out.append(sum(len(r["token_ids"]) for r in results) / wall)
    return out


def recapture():
    """Every engine's captured programs are captured anew at their next
    run (``wave_program.clear_caches``): a tap that swaps a function the
    captured wave calls does so on entry and exit, so the programs
    replayed inside it hold the tap and those after it do not."""
    from seldon_tpu_torch.servers import wave_program

    wave_program.clear_caches()


def on_host(fn):
    """Run a tap's record of one call on the host: at once on the eager
    route, after every replay of a captured wave that holds the call
    (``ops/host_hooks.host_callback``; it then reads what the replay left
    in the tensors it holds)."""
    from seldon_tpu_torch.ops import host_hooks

    host_hooks.host_callback(fn)


class LogitTap:
    """Instrumentation of this script: while active, records the f32
    logits row that the engine's samplers (the ragged wave's, the
    bucketed families', the verify wave's) see for every row whose seed
    is in `seeds`, keyed by (seed, position). A request's token j
    (0-based) is sampled at position len(prompt) + j, so the key names
    one token of one request; a later call at the same key replaces the
    row (a verify wave samples past a rejected draft at the position the
    next wave samples again). Waits for the device at every sampling
    call (in a captured wave after every replay, ``on_host``); used only
    on the comparison runs, never on the timed one."""

    def __init__(self, seeds):
        self.seeds = set(seeds)
        self.rows = {}

    def __enter__(self):
        from seldon_tpu_torch.models import ragged_attention, spec_decode
        from seldon_tpu_torch.servers import engine

        self._mods = (ragged_attention, spec_decode, engine)
        self._orig = ragged_attention.sample_per_row

        def tapped(logits, seeds, positions, *rest):
            def record():
                for i, (sd, ps) in enumerate(zip(seeds.tolist(),
                                                 positions.tolist())):
                    if sd in self.seeds:
                        self.rows[(sd, ps)] = logits[i].float().cpu()
            on_host(record)
            return self._orig(logits, seeds, positions, *rest)

        for mod in self._mods:
            mod.sample_per_row = tapped
        recapture()
        return self

    def __exit__(self, *exc):
        for mod in self._mods:
            mod.sample_per_row = self._orig
        recapture()


class EmbedNudge:
    """Instrumentation of this script: while active, the first element
    of every embedded row moves by one ulp of its dtype (its bit pattern
    plus one: bf16, or f32 for a float32 model), one value in 4096 per
    token and smaller than any rounding in which the legs differ. Run on
    the masked leg it shows how far the model's depth grows a one-ulp
    difference."""

    def __enter__(self):
        import torch

        from seldon_tpu_torch.models import transformer

        self._mod, self._orig = transformer, transformer._embed_rows

        def nudged(params, tokens):
            x = self._orig(params, tokens).clone()
            as_int = torch.int32 if x.dtype == torch.float32 else torch.int16
            bits = x[..., 0].contiguous().view(as_int) + 1
            x[..., 0] = bits.view(x.dtype)
            return x

        transformer._embed_rows = nudged
        recapture()
        return self

    def __exit__(self, *exc):
        self._mod._embed_rows = self._orig
        recapture()


def shallow(params, cfg, n_layers):
    """The same weights cut to their first ``n_layers`` layers (shared,
    not copied), and the config to match."""
    from torch import nn

    from seldon_tpu_torch.models import transformer

    cut = transformer.Transformer.__new__(transformer.Transformer)
    nn.Module.__init__(cut)
    cut.cfg = dataclasses.replace(cfg, n_layers=n_layers)
    cut.embed = params.embed
    cut.blocks = params.blocks[:n_layers]
    cut.final_norm = params.final_norm
    cut.lm_head = params.lm_head
    cut.embed_scale = params.embed_scale
    cut.lm_head_scale = params.lm_head_scale
    return cut, cut.cfg


def run_engine(params, cfg, ecfg, dev, reqs, to_sampling, leg=None,
               stats=None):
    """The requests through a fresh engine, with a LogitTap.
    ``leg`` overrides the wave leg the engine runs (the comparison-only
    ``"reference"`` leg, which EngineConfig does not offer); ``stats``, a
    dict, receives the engine's stats. Returns (streams without a
    trailing EOS, tap rows, wall seconds)."""
    from seldon_tpu_torch.servers.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, ecfg, dev)
    if leg is not None:
        eng._kernel = leg
    eng.start()
    try:
        with LogitTap([r["seed"] for r in reqs]) as tap:
            out, wall = run_concurrent(
                lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                                to_sampling(r)),
                reqs, timeout_s=900)
    finally:
        eng.stop()
    if stats is not None:
        stats.update(eng.stats.snapshot())
    streams = []
    for res in out:
        t = res["token_ids"]
        streams.append(t[:-1] if t and t[-1] == cfg.eos_token_id else t)
    return streams, tap.rows, wall


def top2_gap(row) -> float:
    import torch

    v = torch.topk(row, 2).values
    return float(v[0] - v[1])


class KernelTap:
    """Instrumentation of this script: while active, each kernel launch on
    a checked layer (first, middle, last; every layer under ``every``) is
    followed by the plain version on the same inputs, on the card, and
    the errors are kept by wave leg (decode: one query row per slot;
    prefill: a chunk). The wave calls the kernel once per layer in layer
    order (a captured wave's warm run and capture too), so the call
    count modulo the depth is the layer. In a captured wave the check
    runs after every replay (``on_host``), on the tensors the launch
    read and wrote: the wave writes no pool position below a launch's
    bounds. Waits for the device at every checked launch; used only on a
    comparison run, never on the timed one."""

    def __init__(self, n_layers, leg=None, every=False):
        self.n_layers = n_layers
        self.layers = (set(range(n_layers)) if every
                       else {0, n_layers // 2, n_layers - 1})
        self.calls = 0
        # Launches the card ran while active (a captured wave's at every
        # replay; its warm run and capture launch nothing).
        self.launched = 0
        # `leg` names every launch's leg (a verify wave's, say); by
        # default a launch of one query row per slot is a decode leg.
        self.leg = leg
        self.checked = ({leg: 0} if leg else {"decode": 0, "prefill": 0})
        self.errs = {}  # leg -> (m abs or f32 rel, l rel, acc/l abs)

    def __enter__(self):
        import torch

        from seldon_tpu_torch.ops import ragged_paged_attention as rpa

        self._rpa, self._orig = rpa, rpa.partials_kernel

        def check(q, layer, table, bound, got):
            self.launched += 1
            if got is None or not self.live():
                return
            want = rpa.partials_sparse(q, layer, table, bound)
            leg = self.leg or ("decode" if q.shape[1] == 1 else "prefill")
            err = compare_partials(got, want, bound,
                                   m_rel=q.dtype == torch.float32)
            prev = self.errs.get(leg, (0.0, 0.0, 0.0))
            self.errs[leg] = tuple(map(max, prev, err))
            self.checked[leg] += 1

        def tapped(q, layer, table, bound):
            got = self._orig(q, layer, table, bound)
            if self.calls % self.n_layers in self.layers:
                on_host(functools.partial(check, q, layer, table, bound,
                                          got))
            else:
                on_host(functools.partial(check, None, None, None, None,
                                          None))
            self.calls += 1
            return got

        rpa.partials_kernel = tapped
        recapture()
        return self

    def live(self):
        """Whether a checked layer's launch is checked now."""
        return True

    def __exit__(self, *exc):
        self._rpa.partials_kernel = self._orig
        recapture()


def compare_legs(reqs, name, a, b):
    """Greedy streams and logits of leg `a` against leg `b` (each a
    (streams, tap rows) pair). Logits are compared wherever both legs
    still share their context: every token up to and including the first
    divergence. A divergence is a near-tie when `b`'s top-2 logit gap at
    that token is below RAGGED_LOGITS_ATOL."""
    from seldon_tpu_torch.ops.ragged_paged_attention import (
        RAGGED_LOGITS_ATOL)

    (a_st, a_rows), (b_st, b_rows) = a, b
    equal, ties, wide, diffs = 0, [], [], []
    for i, req in enumerate(reqs):
        got, want = a_st[i], b_st[i]
        k = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
        plen, seed = len(req["prompt_token_ids"]), req["seed"]
        for j in range(min(k + 1, len(got), len(want))):
            key = (seed, plen + j)
            diffs.append(float((a_rows[key] - b_rows[key]).abs().max()))
        if got == want:
            equal += 1
            continue
        key = (seed, plen + k)
        div = {"request": i, "token": k, "gap_a": top2_gap(a_rows[key]),
               "gap_b": top2_gap(b_rows[key]),
               "logit_diff": float((a_rows[key] - b_rows[key]).abs().max())}
        (ties if div["gap_b"] < RAGGED_LOGITS_ATOL else wide).append(div)
    diffs.sort()
    stats = {"equal": equal, "of": len(reqs), "near_ties": ties,
             "other_divergences": wide, "positions": len(diffs),
             "max_logit_diff": diffs[-1],
             "median_logit_diff": diffs[len(diffs) // 2]}
    log(f"{name}: {equal}/{len(reqs)} greedy streams equal, {len(ties)} "
        f"diverge at a near-tie (top-2 gap < {RAGGED_LOGITS_ATOL}), "
        f"{len(wide)} elsewhere (at tokens "
        f"{[d['token'] for d in wide]}); max |logit diff| over "
        f"{len(diffs)} shared positions {diffs[-1]:.4g}, median "
        f"{stats['median_logit_diff']:.4g}")
    return stats


# At every depth the kernel leg's logits may differ from the masked leg's
# by at most this factor times the reference leg's difference (medians
# over shared positions). Both legs differ from the masked leg by the same
# one-pass design; a kernel fault adds error on top of it.
DRIFT_RATIO_MAX = 1.5
# The depth of phase 4's weights in phases 9b-9g (``cut_server``) and 9l
# (b): llama3-8b's full width, its first CUT_LAYERS layers.
# Those phases check function (launch counts, streams, bit-equality,
# drift against the nudge floor measured at the same depth), which does
# not need 32 layers, and at full depth the run does not fit its limit.
CUT_LAYERS = 4
# Depths of the legs' sweep, the same weights cut to their first layers.
DEPTHS = (2, CUT_LAYERS)
PAIRS = (("kernel", "masked"), ("reference", "masked"),
         ("kernel", "reference"), ("nudged", "masked"),
         ("sparse", "masked"))


def run_legs(params, cfg, ecfg_k, dev, reqs, to_sampling, tap=None):
    """The greedy requests through five fresh engines on the same
    weights: the masked leg (the JAX package's default, the port's
    in-package oracle), the masked leg under EmbedNudge, the kernel leg
    (under ``tap`` when given), the reference leg and the sparse leg (the
    masked-matched walk). Returns the pair comparisons, each leg's
    (streams, tap rows) and the legs' wall seconds."""
    import torch

    ecfg_m = dataclasses.replace(ecfg_k, ragged_kernel="masked")
    ecfg_s = dataclasses.replace(ecfg_k, ragged_kernel="sparse")
    legs, walls = {}, {}
    for name, ecfg, leg, ctx in (
            ("masked", ecfg_m, None, None),
            ("nudged", ecfg_m, None, EmbedNudge()),
            ("kernel", ecfg_k, None, tap),
            ("reference", ecfg_k, "reference", None),
            ("sparse", ecfg_s, None, None)):
        with ctx or contextlib.nullcontext():
            st, rows, walls[name] = run_engine(
                params, cfg, ecfg, dev, reqs, to_sampling, leg)
        legs[name] = (st, rows)
        gc.collect()
        torch.cuda.empty_cache()
    out = {f"{a}_vs_{b}": compare_legs(reqs, f"layers={cfg.n_layers} "
                                       f"{a} vs {b}", legs[a], legs[b])
           for a, b in PAIRS}
    out["drift_ratio"] = (
        out["kernel_vs_masked"]["median_logit_diff"]
        / max(out["reference_vs_masked"]["median_logit_diff"], 1e-30))
    out["wall_s"] = walls
    out["sparse_streams_equal_masked"] = legs["sparse"][0] == \
        legs["masked"][0]
    log(f"layers={cfg.n_layers} drift ratio {out['drift_ratio']:.3f} "
        f"(max {DRIFT_RATIO_MAX}); sparse streams equal masked: "
        f"{out['sparse_streams_equal_masked']}; wall_s "
        + " ".join(f"{k}={v:.3f}" for k, v in walls.items()))
    return out, legs


def phase_legs(srv, reqs, toks, dev):
    """The 6 greedy requests again, on the same weights cut to each depth
    of DEPTHS, through the five legs of ``run_legs``; then on the kernel
    leg alone at full depth.

    Greedy streams are reported, not gated: at these widths every pair
    of legs, even the masked leg against itself with one embedding value
    nudged by one bf16 ulp, parts at logit differences over
    RAGGED_LOGITS_ATOL (the JAX package's bound, set on its tiny model)
    from 2 layers on, and the difference grows with depth; the nudged
    pair measures that floor in the same run. The gates:
     * at every depth, the sparse leg's median logit difference to the
       masked leg is at most the nudged leg's (the masked-matched walk
       differs from the masked leg only in f32 summation order); whether
       their greedy streams are equal is reported;
     * at every depth, the kernel leg's median logit difference to the
       reference leg (the same one-pass math without the kernel) is below
       the nudged leg's to the masked leg: the kernel moves the output
       less than a one-ulp perturbation of the input does;
     * at every depth, the kernel leg moves logits away from the masked
       leg no more than DRIFT_RATIO_MAX times what the reference leg does;
     * at full depth, the kernel leg reproduces phase 4's streams, and on
       its own inputs (first, middle and last layer of every wave) the
       kernel agrees with its plain version within the phase-3
       tolerances.
    Returns the report, the kernel leg at CUT_LAYERS (streams, tap rows:
    what the later phases at that depth compare with) and the kernel leg
    at full depth (phase 10's yardstick)."""
    import torch

    params, cfg = srv.params, srv.cfg
    greedy = reqs[:N_GREEDY]
    ecfg = srv.engine.ecfg
    srv.engine = None  # free the serving engine's pool first
    gc.collect()
    torch.cuda.empty_cache()
    out, kernel_at = {}, {}
    for n in DEPTHS:
        p_n, cfg_n = shallow(params, cfg, n)
        out[n], legs = run_legs(p_n, cfg_n, ecfg, dev, greedy,
                                srv._to_sampling)
        kernel_at[n] = legs["kernel"]
        del legs
    tap = KernelTap(cfg.n_layers)
    with tap:
        streams, rows, wall = run_engine(params, cfg, ecfg, dev, greedy,
                                         srv._to_sampling)
    gc.collect()
    torch.cuda.empty_cache()
    log(f"layers={cfg.n_layers} kernel leg: wall_s={wall:.3f}; greedy "
        f"streams equal phase 4's: {streams == toks[:N_GREEDY]}")
    for leg, (em, el, ea) in sorted(tap.errs.items()):
        log(f"kernel on the main path's own inputs, {leg} leg: "
            f"{tap.checked[leg]} launches checked, err m={em:.3g} "
            f"l_rel={el:.3g} acc/l={ea:.3g}")
    log("depth sweep, median |logit diff| over shared positions: "
        + "; ".join(f"{a} vs {b} " + " ".join(
            f"{n}:{out[n][f'{a}_vs_{b}']['median_logit_diff']:.3g}"
            for n in out) for a, b in PAIRS))
    over_floor = {
        n: (o["kernel_vs_reference"]["median_logit_diff"],
            o["nudged_vs_masked"]["median_logit_diff"])
        for n, o in out.items()
        if o["kernel_vs_reference"]["median_logit_diff"]
        > o["nudged_vs_masked"]["median_logit_diff"]}
    if over_floor:
        raise AssertionError(f"the kernel leg differs from the reference leg "
                             f"by more than a one-ulp nudge moves the masked "
                             f"leg (layers: kernel vs reference, nudged vs "
                             f"masked): {over_floor}")
    sparse_over = {
        n: (o["sparse_vs_masked"]["median_logit_diff"],
            o["nudged_vs_masked"]["median_logit_diff"])
        for n, o in out.items()
        if o["sparse_vs_masked"]["median_logit_diff"]
        > o["nudged_vs_masked"]["median_logit_diff"]}
    if sparse_over:
        raise AssertionError(f"the sparse leg differs from the masked leg by "
                             f"more than a one-ulp nudge moves it (layers: "
                             f"sparse vs masked, nudged vs masked): "
                             f"{sparse_over}")
    log("sparse leg, greedy streams equal to the masked leg's by depth: "
        + " ".join(f"{n}:{o['sparse_streams_equal_masked']}"
                   for n, o in out.items()))
    drift = {n: o["drift_ratio"] for n, o in out.items()}
    if max(drift.values()) > DRIFT_RATIO_MAX:
        raise AssertionError(f"the kernel leg drifts further from the "
                             f"masked leg than the reference leg: {drift}")
    if streams != toks[:N_GREEDY]:
        raise AssertionError("the kernel leg did not reproduce its own "
                             "greedy streams")
    if min(tap.checked.values()) == 0:
        raise AssertionError(f"a wave leg had no checked launch: "
                             f"{tap.checked}")
    bad = {leg: e for leg, e in tap.errs.items()
           if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version on "
                             f"the main path's inputs: {bad}")
    return ({"depths": out, "full_depth_kernel_wall_s": wall,
             "tap": {"checked": tap.checked, "errors": tap.errs}},
            kernel_at[CUT_LAYERS], (streams, rows))


def device_breakdown(prof):
    """Device busy ms (the union of the kernels' and copies' intervals) and
    device ms and calls by kernel name, most time first, of a
    ``torch.profiler`` window."""
    from torch.autograd import DeviceType

    spans, by_name = [], {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + (t1 - t0) / 1e3, n + 1)
    if not spans:
        raise AssertionError("the profiler recorded no device activity")
    spans.sort()
    busy_us, end = 0.0, float("-inf")
    for t0, t1 in spans:  # union of the device intervals
        if t1 > end:
            busy_us += t1 - max(t0, end)
            end = t1
    return (busy_us / 1e3, (spans[-1][1] - spans[0][0]) / 1e3,
            sorted(by_name.items(), key=lambda kv: -kv[1][0]))


def profile_summary(prof, wall):
    """Phase 5's report from a profiled burst of ``wall`` seconds: the
    device's busy time (the union of its kernels' and copies'
    intervals), its idle share of the burst's wall time, and the kernels
    and host operations that take the most time. The profiler's own cost
    is inside the wall time, so tokens/s here is not phase 4's."""
    busy_ms, span_ms, by_name = device_breakdown(prof)
    top_dev = by_name[:12]
    host = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    top_host = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                for e in host[:12]]
    syncs = sum(e.count for e in host if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    b1_ms = sum(v[0] for k, v in by_name if b1_leg(k))
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
           "host_stream_syncs": syncs, "b1_device_ms": b1_ms,
           "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
           "device_span_ms": span_ms,
           "top_device": [{"name": k, "ms": v[0], "count": v[1]}
                          for k, v in top_dev],
           "top_host_self": [{"name": k, "ms": t, "count": n}
                             for k, t, n in top_host]}
    log(f"profile: wall_ms={out['wall_ms']:.1f} device_busy_ms={busy_ms:.1f}"
        f" device_idle_share={out['device_idle_share']:.3f}"
        f" host_stream_syncs={syncs} b1_device_ms={b1_ms:.1f}")
    for k, (ms, n) in top_dev[:8]:
        log(f"profile device {ms:9.2f} ms {n:6d}x {k[:90]}")
    for k, ms, n in top_host[:8]:
        log(f"profile host   {ms:9.2f} ms {n:6d}x {k[:90]}")
    return out


class BurstTap:
    """Instrumentation of this script: while active, records each B1
    launch's shape and the data-dependent terms of its bound (live pool
    blocks, sum of the bounds), summed on the device, so nothing waits
    for the device until ``bounds_by_leg`` reads them once; in a captured
    wave the record is made after every replay (``on_host``), from the
    terms the replay left. The host clock brackets each wrapper call made
    eagerly (its host time: the wrapper does not wait for the device); a
    captured wave's replays make no wrapper call. (The profiler does not
    record ranges opened on the engine's thread.)"""

    def __init__(self, leg=None):
        # `leg` names every call's leg (a verify wave's, say); by default
        # a call of one query row per slot is a decode leg.
        self.leg = leg

    def __enter__(self):
        import torch

        from seldon_tpu_torch.ops import ragged_paged_attention as rpa

        self._rpa, self._orig = rpa, rpa.partials_kernel
        self.calls = []
        # Host seconds over the `timed` wrapper calls made eagerly.
        self.host_s = 0.0
        self.timed = 0

        def record(leg, shape, counts, host_s):
            self.calls.append((leg, shape, counts.clone()))
            if host_s is not None:
                self.host_s += host_s
                self.timed += 1

        def tapped(q, layer, table, bound):
            block = layer["k"].shape[2]
            t0 = time.perf_counter()
            out = self._orig(q, layer, table, bound)
            host_s = time.perf_counter() - t0
            counts = torch.stack([
                ((bound.amax(dim=1) + block - 1) // block).sum(),
                bound.to(torch.int64).sum()])
            eager = not torch.cuda.is_current_stream_capturing()
            on_host(functools.partial(
                record, self.leg or ("decode" if q.shape[1] == 1
                                     else "prefill"),
                (tuple(q.shape), q.element_size(), bound.numel(), block,
                 layer["k"].element_size(), "k_scale" in layer), counts,
                host_s if eager else None))
            return out

        rpa.partials_kernel = tapped
        recapture()
        return self

    def reset(self):
        self.calls = []
        self.host_s = 0.0
        self.timed = 0

    def __exit__(self, *exc):
        self._rpa.partials_kernel = self._orig
        recapture()

    def bounds_by_leg(self):
        """Per wave leg: wrapper calls and bound ms summed over the
        burst."""
        import torch

        torch.cuda.synchronize()
        counts = torch.stack([c[2] for c in self.calls]).tolist()
        out = {}
        for (leg, shape, _), (lb, bs) in zip(self.calls, counts):
            nbytes, ops = bounds_from(*shape, lb, bs)
            bound = max(nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3
            d = out.setdefault(leg, {"launches": 0, "bound_ms": 0.0})
            d["launches"] += 1
            d["bound_ms"] += bound
        return out


def b1_leg(name):
    """The wave leg of a device kernel of B1, by its name (None for any
    other kernel): the decode route's split and merge kernels, the
    prefill route's tensor-core kernel."""
    if "rpa_decode_kernel" in name or "rpa_merge_kernel" in name:
        return "decode"
    if "rpa_prefill_kernel" in name:
        return "prefill"
    return None


def phase_burst_kernel(srv, reqs, dev):
    """The 8-request burst once more through a fresh kernel-leg engine,
    on the main path's captured route (its programs captured by
    ``warmup`` with BurstTap inside, so the profiled burst only replays),
    under BurstTap and ``torch.profiler``: where the burst's time goes
    (phase 5, ``profile_summary``); B1's launches and device time by wave
    leg, from the profiler's kernel records inside the replays (grouped
    by ``b1_leg`` on the kernel's name), and its bound on the serving
    path's own inputs (the order of queue B in ROADMAP.md rests on it).
    Also the profiler's count and host time of ``cudaFuncSetAttribute``
    calls in the burst. Then the burst once more on the eager route
    (``wave_program.disabled()``), not profiled, for B1's host time per
    wrapper call (BurstTap's host clock): a replay makes no wrapper
    call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seldon_tpu_torch.servers import wave_program
    from seldon_tpu_torch.servers.engine import InferenceEngine

    def burst():
        return run_concurrent(
            lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                            srv._to_sampling(r)),
            reqs, timeout_s=600)[1]

    eng = InferenceEngine(srv.params, srv.cfg, srv.engine.ecfg, dev)
    with BurstTap() as tap:
        eng.warmup()
        torch.cuda.synchronize()
        captures = eng._programs.captures
        eng.start()
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                wall = burst()
                torch.cuda.synchronize()
            if not captures or eng._programs.captures != captures:
                raise AssertionError(
                    f"burst_kernel: {captures} programs captured by warmup, "
                    f"{eng._programs.captures} after the profiled burst")
            out = tap.bounds_by_leg()
            records = len(tap.calls)
            with wave_program.disabled():
                eager_wall = burst()
                torch.cuda.synchronize()
        finally:
            eng.stop()
    summary = profile_summary(prof, wall)
    kernels = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        leg = b1_leg(e.name)
        if leg is None:
            continue
        d = out.setdefault(leg, {"launches": 0, "bound_ms": 0.0})
        d["device_ms"] = d.get("device_ms", 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
        kernels[e.name] = kernels.get(e.name, 0) + 1
    attr = [e for e in prof.key_averages() if e.key == "cudaFuncSetAttribute"]
    for leg, d in out.items():
        if not d.get("device_ms") or not d["launches"]:
            raise AssertionError(f"no B1 kernel record for the {leg} leg: "
                                 f"{kernels}")
        # The profiler saw the launches the tap recorded: one split-KV
        # kernel (and its merge) a decode launch, one prefill kernel.
        seen = sum(n for k, n in kernels.items()
                   if f"rpa_{leg}_kernel" in k)
        if seen != d["launches"]:
            raise AssertionError(f"burst_kernel: {seen} {leg} kernel records"
                                 f" against {d['launches']} launches")
        d["ms_per_launch"] = d["device_ms"] / d["launches"]
        d["bound_ms_per_launch"] = d["bound_ms"] / d["launches"]
        d["over_bound_ms"] = d["device_ms"] - d["bound_ms"]
    if not tap.timed:
        raise AssertionError("burst_kernel: the eager burst timed no B1 "
                             "wrapper call")
    res = {"legs": out, "kernel_records": kernels, "profile": summary,
           "route": "captured", "programs": captures, "launches": records,
           "host_us_per_call": tap.host_s / tap.timed * 1e6,
           "host_us_route": "eager (wave_program.disabled())",
           "eager_wall_s": eager_wall,
           "cudaFuncSetAttribute": {
               "calls": sum(e.count for e in attr),
               "host_ms": sum(e.cpu_time_total for e in attr) / 1e3},
           "wrapper_calls": tap.timed}
    for leg, d in sorted(out.items()):
        log(f"burst B1 {leg:7s} launches={d['launches']} device_ms="
            f"{d['device_ms']:.3f} ({d['ms_per_launch']:.4f} per launch) "
            f"bound_ms={d['bound_ms']:.3f} ({d['bound_ms_per_launch']:.4f} "
            f"per launch) over_bound_ms={d['over_bound_ms']:.3f}")
    log(f"burst B1 on the captured route ({captures} programs, replayed): "
        f"{records} launches recorded; cudaFuncSetAttribute "
        f"{res['cudaFuncSetAttribute']['calls']} calls in the burst; kernels "
        + "; ".join(f"{n}x {k[:70]}" for k, n in sorted(kernels.items())))
    log(f"burst B1 host time per wrapper call, eager route "
        f"(wave_program.disabled()): {res['host_us_per_call']:.1f} us over "
        f"{tap.timed} calls")
    res["budget"] = budget_burst(srv, reqs, dev)
    return res


# The budgeted burst: legs needing more than this many pool blocks (of
# kv_block 16: 256 positions) run the masked head, the others B1.
BURST_BLOCK_BUDGET = 16


class LegCount:
    """Instrumentation of this script: while active, counts the ragged
    wave's legs by the route they take, judged on the host from each
    leg's own descriptor count of live block columns (the ``n_live`` the
    engine passes, clipped to the table as the wave clips it) against the
    budget, and counts the masked head's runs (dense prefill with the
    prefix, paged decode step) as the wave makes them (in a captured wave
    at every replay, ``on_host``)."""

    def __init__(self, budget):
        self.budget = budget
        self.within = self.over = self.masked = 0

    def __enter__(self):
        from seldon_tpu_torch.models import ragged_attention, transformer

        self._ra, self._tf = ragged_attention, transformer
        self._orig = {}

        def wrap(mod, name, fn):
            self._orig[(mod, name)] = getattr(mod, name)
            setattr(mod, name, fn)

        def leg(name):
            real = getattr(ragged_attention, name)

            def counted(params, state, table, *a, **kw):
                n_live = kw["n_live"]
                if n_live is None:
                    raise AssertionError("a wave leg without the host's "
                                         "count of its live blocks")
                over = min(n_live, table.shape[1]) > self.budget
                on_host(functools.partial(self._count, over))
                return real(params, state, table, *a, **kw)
            wrap(ragged_attention, name, counted)

        def masked(name):
            real = getattr(transformer, name)

            def counted(*a, **kw):
                on_host(self._count_masked)
                return real(*a, **kw)
            wrap(transformer, name, counted)

        leg("ragged_prefill_phase")
        leg("ragged_decode_phase")
        masked("prefill_with_prefix")
        masked("paged_decode_step")
        recapture()
        return self

    def _count(self, over):
        if over:
            self.over += 1
        else:
            self.within += 1

    def _count_masked(self):
        self.masked += 1

    def __exit__(self, *exc):
        for (mod, name), fn in self._orig.items():
            setattr(mod, name, fn)
        recapture()


def budget_burst(srv, reqs, dev):
    """The budgeted burst (a sub-phase of burst_kernel): phase 4's burst
    through a fresh kernel-leg engine with ``ragged_block_budget =
    BURST_BLOCK_BUDGET``, so legs whose longest live row needs more
    blocks run the masked head (the JAX wave's ``lax.cond``) and the
    others B1. Gates: B1 launches = layers x the legs within the budget
    and the masked head's runs = the legs over it, both counted on the
    host from the legs' descriptors (``LegCount``); both kinds of leg
    occur; every tapped B1 launch (first, middle and last layer) within
    phase 3's tolerances of its plain version."""
    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.engine import InferenceEngine

    ecfg = dataclasses.replace(srv.engine.ecfg,
                               ragged_block_budget=BURST_BLOCK_BUDGET)
    eng = InferenceEngine(srv.params, srv.cfg, ecfg, dev)
    n_layers = srv.cfg.n_layers
    t0 = time.perf_counter()
    eng.start()
    try:
        with LegCount(BURST_BLOCK_BUDGET) as legs, \
                KernelTap(n_layers) as tap:
            n0 = rpa.launches
            _, wall = run_concurrent(
                lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                                srv._to_sampling(r)),
                reqs, timeout_s=600)
            torch.cuda.synchronize()
            launches = rpa.launches - n0
    finally:
        eng.stop()
    out = {"budget_blocks": BURST_BLOCK_BUDGET, "kv_block": ecfg.kv_block,
           "legs_within": legs.within, "legs_over": legs.over,
           "masked_runs": legs.masked, "launches": launches,
           "launches_expected": n_layers * legs.within,
           "tap": {"checked": tap.checked, "errors": tap.errs},
           "wall_s": wall, "seconds": time.perf_counter() - t0}
    log(f"burst budget {BURST_BLOCK_BUDGET} blocks of {ecfg.kv_block}: "
        f"{legs.within} legs within (B1 launches {launches}, expected "
        f"{out['launches_expected']}), {legs.over} over (masked head runs "
        f"{legs.masked}); tapped B1 {tap.checked} errors {tap.errs}; "
        f"burst {wall:.2f} s; {card_line()}")
    problems = []
    if launches != out["launches_expected"]:
        problems.append(f"B1 launches {launches} != layers x legs within "
                        f"the budget {out['launches_expected']}")
    if legs.masked != legs.over:
        problems.append(f"masked head runs {legs.masked} != legs over the "
                        f"budget {legs.over}")
    if not legs.within or not legs.over:
        problems.append(f"the burst did not take both routes "
                        f"({legs.within} within, {legs.over} over)")
    if not sum(tap.checked.values()):
        problems.append("no B1 launch was checked")
    bad = {leg: e for leg, e in tap.errs.items()
           if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
    if bad:
        problems.append(f"B1 disagrees with its plain version {bad}")
    if problems:
        raise AssertionError("burst budget: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# Phase 5c: the converged engine's captured programs against the eager wave
# ---------------------------------------------------------------------------

# (c)'s profiled bursts: eager and captured, in turns, this many pairs.
CAPTURE_PAIRS = 2


def pool_trace(eng):
    """The captured programs' shared graph pool against one family's
    peak: the pool's bytes and those of its blocks that live tensors
    hold; for each program the peak bytes its body allocates when run
    eagerly on its static inputs (the last run's), as
    ``Programs._capture``'s warm run runs it (the eager route's
    transients for that dispatch; its cache writes are the last run's
    again, on an idle engine), and the largest allocations live at that
    peak, by the port's source line that made them (the allocator's
    history, Python frames)."""
    import torch

    progs = eng._programs
    out = {"pool_bytes": progs.pool_bytes(),
           "pool_active_bytes": progs.pool_bytes(active=True),
           "programs": {}}
    for key in progs.keys():
        prog = progs.get(key)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(
            context="alloc", stacks="python", max_entries=1_000_000)
        try:
            res = prog.warm()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated() - base
            trace = torch.cuda.memory._snapshot()["device_traces"][
                torch.cuda.current_device()]
        finally:
            torch.cuda.memory._record_memory_history(enabled=None)
        del res
        out["programs"][str(key)] = {"eager_peak_bytes": peak,
                                     "at_peak": peak_sites(trace)}
    out["max_eager_peak_bytes"] = max(
        p["eager_peak_bytes"] for p in out["programs"].values())
    out["pool_over_peak"] = out["pool_bytes"] / out["max_eager_peak_bytes"]
    return out


def peak_sites(trace, top=6):
    """The allocations live at the highest point of an allocator trace,
    summed by the innermost frame in the port (file:line function), the
    ``top`` largest."""
    def replay(stop):
        live, cur, best, at = {}, 0, -1, 0
        for i, ev in enumerate(trace[:stop]):
            if ev["action"] == "alloc":
                live[ev["addr"]] = ev
                cur += ev["size"]
            elif ev["action"] == "free_requested" and ev["addr"] in live:
                cur -= live.pop(ev["addr"])["size"]
            if cur > best:
                best, at = cur, i + 1
        return live, at

    _, at = replay(len(trace))
    live, _ = replay(at)
    sites = {}
    for ev in live.values():
        frame = next((f for f in ev.get("frames", ())
                      if "seldon_tpu_torch" in f["filename"]), None)
        site = ("outside the port" if frame is None else
                f"{frame['filename'].split('seldon_tpu_torch/')[-1]}:"
                f"{frame['line']} {frame['name']}")
        sites[site] = sites.get(site, 0) + ev["size"]
    return sorted(sites.items(), key=lambda kv: -kv[1])[:top]


def route_burst(params, cfg, ecfg, dev, reqs, to_sampling, eager,
                tapped=True, draft=None, heal=False):
    """The requests through a fresh engine (its sync loop; every request
    queued before start, so both routes schedule the same waves; with
    ``heal`` the supervisor armed, ``draft`` its model drafter), under a
    KeySpy and, unless not ``tapped``, a LogitTap; ``eager`` inside
    ``wave_program.disabled()``, else as captured programs; under a block
    budget (and ``tapped``) LegCount counts the legs within it. Returns
    the streams, each request's first-token logits row (tapped), the B1,
    B2 and ``torch._int_mm`` launches, the wave legs (and those that
    launch B1), the dispatched keys and the engine's lattice, the program
    keys and captures, the heal recoveries, the stats, and on the tapped
    captured route ``pool_trace``."""
    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.ops import flash_attention as fa
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers import shape_lattice, wave_program
    from seldon_tpu_torch.servers.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, dataclasses.replace(
        ecfg, async_fetch=False, heal=heal), dev, draft=draft)
    qs = [eng.submit(r["prompt_token_ids"], to_sampling(r)) for r in reqs]
    rpa.launches = 0
    fa.reset_launches()
    transformer.int_mm_launches = 0
    ctx = wave_program.disabled() if eager else contextlib.nullcontext()
    budget = ecfg.ragged_block_budget if tapped else 0
    t0 = time.perf_counter()
    with ctx, (LogitTap([r["seed"] for r in reqs]) if tapped
               else contextlib.nullcontext()) as tap, (
            LegCount(budget) if budget else contextlib.nullcontext()) as lc, \
            KeySpy(eng) as spy:
        eng.start()
        try:
            streams = []
            for q in qs:
                toks = []
                while (item := q.get(timeout=600)) is not None:
                    if "error" in item:
                        raise AssertionError(f"a request failed: {item}")
                    toks.extend(item["tokens"])
                streams.append(toks)
            wait_idle(eng)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            keys, captures = eng._programs.keys(), eng._programs.captures
            capture_ms = list(eng._programs.capture_ms)
            capture_bytes = list(eng._programs.capture_bytes)
            pool = eng._programs.pool_bytes()
            trace = pool_trace(eng) if tapped and keys else None
        finally:
            eng.stop()
    snap = eng.stats.snapshot()
    first = [tap.rows.get((r["seed"], len(r["prompt_token_ids"])))
             for r in reqs] if tapped else None
    if tapped and any(row is None for row in first):
        raise AssertionError("a request's first-token logits were not seen")
    legs = snap["decode_dispatches"] + snap["prefill_waves"]
    return {"streams": streams, "first": first, "launches": rpa.launches,
            "launches_b2": fa.launches,
            "int_mm": transformer.int_mm_launches, "legs": legs,
            # The legs that launch B1: under a budget those within it.
            "b1_legs": lc.within if budget else legs,
            "dispatched": spy.keys,
            "lattice": shape_lattice.dispatch_keys(eng.lattice_spec()),
            "keys": keys, "captures": captures, "capture_ms": capture_ms,
            "capture_bytes": capture_bytes, "pool_bytes": pool,
            "pool_trace": trace, "seconds": seconds, "stats": snap,
            "recoveries": eng._heal.recoveries if heal else 0}


def captured_pair(name, params, cfg, ecfg, dev, reqs, to_sampling):
    """Gate: the same burst eagerly and as captured programs, bit for
    bit: every request's first-token logits, every stream, B1 launches
    (layers x the wave legs that launch it, on both) and W8A8's products
    counted; then the captured route once more with no tap (the graphs a
    server replays: a tap's host callbacks keep tensors alive in the
    pool), its streams and launches equal to the eager route's. Reports
    the tapped captured engine's ``pool_trace``."""
    import torch

    eager = route_burst(params, cfg, ecfg, dev, reqs, to_sampling, True)
    capt = route_burst(params, cfg, ecfg, dev, reqs, to_sampling, False)
    bare = route_burst(params, cfg, ecfg, dev, reqs, to_sampling, False,
                       tapped=False)
    problems = []
    differ = [i for i, (a, b) in enumerate(zip(eager["first"],
                                               capt["first"]))
              if not torch.equal(a, b)]
    if differ:
        problems.append(f"first-token logits differ for requests {differ}")
    same = sum(a == b for a, b in zip(eager["streams"], capt["streams"]))
    if same != len(reqs):
        problems.append(f"{same} / {len(reqs)} streams equal")
    bare_same = sum(a == b for a, b in zip(eager["streams"],
                                           bare["streams"]))
    if bare_same != len(reqs):
        problems.append(f"untapped: {bare_same} / {len(reqs)} streams equal")
    for tag, r in (("eager", eager), ("captured", capt)):
        if r["launches"] != cfg.n_layers * r["b1_legs"]:
            problems.append(f"{tag}: B1 launches {r['launches']} != layers "
                            f"x legs that launch it "
                            f"{cfg.n_layers * r['b1_legs']}")
    for tag, r in (("captured", capt), ("untapped", bare)):
        if (r["launches"], r["int_mm"]) != (eager["launches"],
                                            eager["int_mm"]):
            problems.append(f"launches (B1, _int_mm) {tag} "
                            f"{r['launches'], r['int_mm']} != eager "
                            f"{eager['launches'], eager['int_mm']}")
    if eager["keys"] or not capt["keys"] or bare["keys"] != capt["keys"]:
        problems.append(f"programs: eager {eager['keys']}, captured "
                        f"{capt['keys']}, untapped {bare['keys']}")
    pt = capt["pool_trace"]
    out = {"requests": len(reqs), "streams_equal": same,
           "first_logits_equal": len(reqs) - len(differ),
           "untapped_streams_equal": bare_same,
           "launches": {"eager": eager["launches"],
                        "captured": capt["launches"],
                        "untapped": bare["launches"]},
           "int_mm_launches": {"eager": eager["int_mm"],
                               "captured": capt["int_mm"],
                               "untapped": bare["int_mm"]},
           "legs": capt["legs"], "b1_legs": capt["b1_legs"],
           "programs": [str(k) for k in capt["keys"]],
           "branches": sorted({k[1] for k in capt["keys"]
                               if k[0][0] == "ragged"}),
           "captures": capt["captures"], "capture_ms": capt["capture_ms"],
           "capture_bytes": capt["capture_bytes"],
           "pool_bytes": capt["pool_bytes"],
           "pool_bytes_untapped": bare["pool_bytes"], "pool_trace": pt,
           "seconds": {"eager": eager["seconds"],
                       "captured": capt["seconds"],
                       "untapped": bare["seconds"]}}
    log(f"captured {name}: first-token logits bit-equal "
        f"{out['first_logits_equal']} / {len(reqs)}, streams equal {same} / "
        f"{len(reqs)} (untapped {bare_same} / {len(reqs)}), B1 launches "
        f"eager {eager['launches']} captured {capt['launches']} untapped "
        f"{bare['launches']} (layers x legs {cfg.n_layers * capt['b1_legs']}"
        f"), _int_mm {eager['int_mm']} / {capt['int_mm']} / {bare['int_mm']};"
        f" {len(capt['keys'])} programs, capture ms "
        + ", ".join(f"{m:.1f}" for m in capt["capture_ms"])
        + f"; pool {capt['pool_bytes']} B (untapped {bare['pool_bytes']} B;"
        f" after each capture {capt['capture_bytes']}); {card_line()}")
    log_pool_trace(name, pt)
    if problems:
        raise AssertionError(f"captured {name}: " + "; ".join(problems))
    return out


def log_pool_trace(name, pt):
    log(f"pool {name}: {pt['pool_bytes']} B, {pt['pool_active_bytes']} B "
        f"held by live tensors; largest eager wave peak "
        f"{pt['max_eager_peak_bytes']} B (pool / peak "
        f"{pt['pool_over_peak']:.3f})")
    for key, p in pt["programs"].items():
        log(f"pool {name} {key}: eager peak {p['eager_peak_bytes']} B; at "
            f"the peak " + "; ".join(f"{s} {b} B" for s, b in p["at_peak"]))


def launch_calls(prof):
    """Launches the host made in a profiled window: kernel launches
    (``cudaLaunch*``, ``cuLaunch*``) and graph launches, by the
    profiler's CPU-side records."""
    counts = {}
    for e in prof.key_averages():
        if "Launch" in e.key and e.key.startswith(("cuda", "cu")):
            counts[e.key] = counts.get(e.key, 0) + e.count
    return counts


def profiled_route(eng, reqs, to_sampling, eager):
    """One profiled burst through a warmed engine, eager (inside
    ``wave_program.disabled()``) or captured: the device's idle share,
    tokens/s, the host's launches per wave and B1's device ms (0 when
    the profiler does not name B1 inside replays)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_tpu_torch.servers import wave_program

    waves0 = eng.stats.snapshot()["decode_dispatches"]
    ctx = wave_program.disabled() if eager else contextlib.nullcontext()
    with ctx, profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = submit_all(eng, reqs, to_sampling)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    wait_idle(eng)
    waves = eng.stats.snapshot()["decode_dispatches"] - waves0
    busy_ms, _, by_name = device_breakdown(prof)
    calls = launch_calls(prof)
    n_tok = sum(len(t) for t, _ in res)
    return {"route": "eager" if eager else "captured", "wall_ms": wall * 1e3,
            "tokens": n_tok, "tokens_per_s": n_tok / wall, "waves": waves,
            "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / (wall * 1e3),
            "launch_calls": calls,
            "launches_per_wave": sum(calls.values()) / max(waves, 1),
            "b1_device_ms": sum(v[0] for k, v in by_name if b1_leg(k))}


def phase_captured(srv, reqs, dev):
    """Phase 5c, the converged engine's lattice as captured programs
    (``servers/wave_program.py``) at full depth on phase 4's weights and
    requests.
     (a) Gate: the burst once eagerly (``wave_program.disabled()``) and
         once captured, bit-equal (``captured_pair``).
     (c) Report only: programs per engine, capture ms per program, the
         graph pool's bytes against the largest eager wave's peak
         (``pool_trace``); CAPTURE_PAIRS pairs of profiled bursts,
         eager and captured in turns through two warmed engines: the
         device's idle share, tokens/s, the host's launches per wave and
         whether the profiler names B1 inside replays."""
    import torch

    from seldon_tpu_torch.servers import wave_program
    from seldon_tpu_torch.servers.engine import InferenceEngine

    ecfg = srv.engine.ecfg if srv.engine is not None else \
        srv._engine_config(srv.cfg)
    out = {"a": captured_pair("phase 4 burst (32 layers)", srv.params,
                              srv.cfg, ecfg, dev, reqs, srv._to_sampling)}
    gc.collect()
    torch.cuda.empty_cache()
    engines = {}
    try:
        for route in ("eager", "captured"):
            eng = InferenceEngine(srv.params, srv.cfg, ecfg, dev)
            t0 = time.perf_counter()
            with (wave_program.disabled() if route == "eager"
                  else contextlib.nullcontext()):
                eng.warmup()
            torch.cuda.synchronize()
            eng.start()
            engines[route] = (eng, time.perf_counter() - t0)
        turns = []
        for _ in range(CAPTURE_PAIRS):
            for route in ("eager", "captured"):
                turns.append(profiled_route(engines[route][0], reqs,
                                            srv._to_sampling,
                                            route == "eager"))
        progs = engines["captured"][0]._programs
        c = {"programs": len(progs), "captures": progs.captures,
             "capture_ms": list(progs.capture_ms),
             "capture_bytes": list(progs.capture_bytes),
             "pool_bytes": progs.pool_bytes(),
             "warmup_s": {r: e[1] for r, e in engines.items()},
             "turns": turns, "card": card_line(),
             "pool_trace": pool_trace(engines["captured"][0])}
    finally:
        for eng, _ in engines.values():
            eng.stop()
        engines.clear()
        gc.collect()
        torch.cuda.empty_cache()
    for t in turns:
        log(f"captured (c) {t['route']:8s} tokens/s={t['tokens_per_s']:.1f}"
            f" idle_share={t['device_idle_share']:.3f} busy_ms="
            f"{t['device_busy_ms']:.1f} waves={t['waves']} host launches "
            f"per wave={t['launches_per_wave']:.1f} b1_device_ms="
            f"{t['b1_device_ms']:.1f} {t['launch_calls']}")
    log(f"captured (c): {c['programs']} programs, capture ms "
        + ", ".join(f"{m:.1f}" for m in c["capture_ms"])
        + f"; graph pool {c['pool_bytes']} B (after each capture "
        f"{c['capture_bytes']}); warmup s "
        f"{c['warmup_s']}; {c['card']}")
    log_pool_trace("(c) warmed engine, no tap", c["pool_trace"])
    out["c"] = c
    return out


def captured_cut(csrv, reqs, dev):
    """(b) at CUT_LAYERS: ``captured_pair`` on burst_kernel's budgeted
    burst (``ragged_block_budget = BURST_BLOCK_BUDGET``): its legs take
    the masked-head branches and the kernel ones."""
    ecfg = dataclasses.replace(csrv._engine_config(csrv.cfg),
                               ragged_block_budget=BURST_BLOCK_BUDGET)
    out = captured_pair(f"budgeted burst ({CUT_LAYERS} layers, budget "
                        f"{BURST_BLOCK_BUDGET})", csrv.params, csrv.cfg, ecfg,
                        dev, reqs, csrv._to_sampling)
    heads = {h for b in out["branches"] for h in b} - {"skip"}
    if heads != {"masked", "pallas"}:
        raise AssertionError(f"captured budgeted burst: its programs "
                             f"{out['programs']} do not take both heads")
    return out


# ---------------------------------------------------------------------------
# Phase 5d: every other family of a single-rank engine as captured programs
# ---------------------------------------------------------------------------

SPEC_K = 4  # the verify rung of phases 5d and 9f

# Phase 5d's engines at CUT_LAYERS on phase 4's configuration: the
# bucketed families of 9e under attn_impl="flash" (B2 in every cold
# admission) and the spec engine of 9f on B1's kernel leg with the
# n-gram drafter and with the target's own weights as the draft model.
# Each: (name, engine knobs, flash, drafter, how the engines of its
# profiled turns are warmed, None for no turns). A spec engine's whole
# lattice under the preset's "xla" attention captures dense f32 scores
# at G 8 x Sb 2048 (a graph pool of 25,713,180,672 B on the H100,
# PERF.md): its turns capture the keys of one untimed burst instead. The
# turns of (b), (c) and the self-draft (12-51 s each, most of it the
# profiler's records) are left out for the script's time (PERF.md).
FAMILY_ENGINES = (
    ("a_paged", dict(paged_kv=True), True, None, "lattice"),
    ("b_dense", dict(paged_kv=False), True, None, None),
    ("c_chunked", dict(paged_kv=True, chunked_prefill=True), True, None,
     None),
    ("spec_ngram", dict(paged_kv=True, spec_decode=True, spec_k=SPEC_K,
                        ragged_kernel="pallas"), False, None, "burst"),
    ("spec_self", dict(paged_kv=True, spec_decode=True, spec_k=SPEC_K,
                       ragged_kernel="pallas"), False, "self", None),
)


def family_pair(name, params, cfg, ecfg, dev, reqs, to_sampling, draft):
    """Gate: one family engine's burst eagerly and as captured programs,
    bit for bit (streams, every request's first-token logits), B1 and B2
    launched as often on both routes (B2 layers x cold admissions, B1
    layers x verify waves), the same dispatched keys on both, every one
    in the engine's lattice and held by a program on the captured route,
    and no program dropped or captured anew (heal armed)."""
    import torch

    eager = route_burst(params, cfg, ecfg, dev, reqs, to_sampling, True,
                        draft=draft, heal=True)
    capt = route_burst(params, cfg, ecfg, dev, reqs, to_sampling, False,
                       draft=draft, heal=True)
    problems = []
    differ = [i for i, (a, b) in enumerate(zip(eager["first"],
                                               capt["first"]))
              if not torch.equal(a, b)]
    if differ:
        problems.append(f"first-token logits differ for requests {differ}")
    same = sum(a == b for a, b in zip(eager["streams"], capt["streams"]))
    if same != len(reqs):
        problems.append(f"{same} / {len(reqs)} streams equal")
    launches = {k: (eager[k], capt[k]) for k in ("launches",
                                                 "launches_b2")}
    for k, (e, c) in launches.items():
        if e != c:
            problems.append(f"{k} eager {e} captured {c}")
    st = capt["stats"]
    # Every verify wave on B1's kernel leg; B2 in the cold admissions
    # under flash.
    want = ({"launches": cfg.n_layers * st["decode_dispatches"],
             "launches_b2": 0} if ecfg.spec_decode else
            {"launches_b2": cfg.n_layers * st["cold_admit_dispatches"],
             "launches": 0})
    for k, n in want.items():
        if capt[k] != n:
            problems.append(f"{k} {capt[k]} != {n}")
    if eager["dispatched"] != capt["dispatched"] or not capt["dispatched"]:
        problems.append(f"dispatched keys: eager {len(eager['dispatched'])}"
                        f", captured {len(capt['dispatched'])}")
    outside = set(capt["dispatched"]) - capt["lattice"]
    held = {k for k, _ in capt["keys"]}
    if outside or set(capt["dispatched"]) - held:
        problems.append(f"keys outside the lattice {sorted(outside)} or "
                        f"without a program "
                        f"{sorted(set(capt['dispatched']) - held)}")
    if eager["keys"] or capt["captures"] != len(capt["keys"]) \
            or capt["recoveries"]:
        problems.append(f"programs: eager {len(eager['keys'])}, captured "
                        f"{len(capt['keys'])} held after {capt['captures']} "
                        f"captures, heal recoveries {capt['recoveries']}")
    pt = capt["pool_trace"]
    out = {"requests": len(reqs), "streams_equal": same,
           "first_logits_equal": len(reqs) - len(differ),
           "launches": {k: {"eager": e, "captured": c}
                        for k, (e, c) in launches.items()},
           "dispatches": len(capt["dispatched"]),
           "distinct_keys": len(set(capt["dispatched"])),
           "programs": [str(k) for k in capt["keys"]],
           "captures": capt["captures"], "capture_ms": capt["capture_ms"],
           "pool_bytes": capt["pool_bytes"], "pool_trace": pt,
           "seconds": {"eager": eager["seconds"],
                       "captured": capt["seconds"]}}
    log(f"families {name}: first-token logits bit-equal "
        f"{out['first_logits_equal']} / {len(reqs)}, streams equal {same} / "
        f"{len(reqs)}, launches B1 {launches['launches']} B2 "
        f"{launches['launches_b2']} (eager, captured); {out['dispatches']} "
        f"dispatches over {out['distinct_keys']} keys, equal on both routes"
        f", all in the lattice; {capt['captures']} programs, capture ms "
        + ", ".join(f"{m:.1f}" for m in capt["capture_ms"])
        + f"; pool {capt['pool_bytes']} B"
        + (f", largest eager peak {pt['max_eager_peak_bytes']} B (pool / "
           f"peak {pt['pool_over_peak']:.3f})" if pt else "")
        + f"; {card_line()}")
    if pt:
        log_pool_trace(f"families {name}", pt)
    if problems:
        raise AssertionError(f"families {name}: " + "; ".join(problems))
    return out


def phase_captured_families(csrv, reqs, dev):
    """Phase 5d, every other family of a single-rank engine as captured
    programs (``servers/wave_program.py``), on phase 4's weights cut to
    CUT_LAYERS layers and its requests: the bucketed (a) paged, (b) dense
    and (c) chunked engines under ``attn_impl="flash"`` (B2 in the cold
    admissions) and the spec engine on B1's kernel leg with the n-gram
    drafter and the target as its own draft model.
     (a) Gate, per engine: ``family_pair``.
     (b) Report only, for (a) and the n-gram engine: one profiled burst
         per route on warmed engines (every program captured before
         it), eager then captured: the device's idle share, tokens/s,
         the host's launch calls per dispatch, programs, capture ms and
         the graph pool."""
    import torch

    out = {"gates": {}, "turns": {}, "seconds": {}}
    for name, kw, flash, draft, warm in FAMILY_ENGINES:
        cfg = (dataclasses.replace(csrv.cfg, attn_impl="flash") if flash
               else csrv.cfg)
        ecfg = bucketed_ecfg(csrv, **kw)
        dr = (csrv.params, csrv.cfg) if draft == "self" else None
        t0 = time.perf_counter()
        out["gates"][name] = family_pair(name, csrv.params, cfg, ecfg, dev,
                                         reqs, csrv._to_sampling, dr)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out["seconds"][name] = {"gate": t1 - t0}
        if warm is None:
            continue
        turns = []
        for eager in (True, False):
            p = profiled_burst(csrv.params, cfg, ecfg, dev, reqs,
                               csrv._to_sampling, draft=dr, eager=eager,
                               warm=warm)
            p["top_device"] = p["top_device"][:6]
            turns.append(p)
            log_profile(f"families {name}", p)
            gc.collect()
            torch.cuda.empty_cache()
        capt = turns[1]["programs"]
        out["seconds"][name]["turns"] = time.perf_counter() - t1
        log(f"families {name} (b): engine warmed by {warm}, "
            f"{len(capt['keys'])} programs, {capt['captures_in_burst']} "
            f"captured in the burst; capture ms "
            + ", ".join(f"{m:.1f}" for m in capt["capture_ms"])
            + f"; graph pool {capt['pool_bytes']} B; seconds gate "
            f"{out['seconds'][name]['gate']:.1f} turns "
            f"{out['seconds'][name]['turns']:.1f}; {card_line()}")
        out["turns"][name] = turns
    out["launches_b1"] = sum(g["launches"]["launches"]["captured"]
                             for g in out["gates"].values())
    out["launches_b2"] = sum(g["launches"]["launches_b2"]["captured"]
                             for g in out["gates"].values())
    return out


# ---------------------------------------------------------------------------
# Phases 7-9: score, generate and predict on the served weights
# ---------------------------------------------------------------------------

SCORE_B, SCORE_S = 2, 4096
# Flash vs xla logits may differ at most this many times what a one-ulp
# embedding nudge moves the xla path (medians over positions).
SCORE_DRIFT_MAX = 2.0
GEN_PROMPT_LENS = (64, 128, 192, 256, 320, 384, 448, 512)
GEN_BUCKET, GEN_NEW = 512, 32


class FlashTap:
    """Instrumentation of this script: while active, each B2 launch on a
    checked layer (first, middle, last; every layer under ``every``) is
    followed by the plain version on the same inputs, on the card, and
    the comparison is kept. A forward calls the kernel once per layer in
    layer order (a captured admission's warm run and capture too), so
    the call count modulo the depth is the layer. In a captured program
    the check runs after every replay (``on_host``), on the tensors the
    launch read and wrote. Waits for the device at every checked launch;
    never active on a timed run."""

    def __init__(self, n_layers, every=False):
        self.n_layers = n_layers
        self.layers = (set(range(n_layers)) if every
                       else {0, n_layers // 2, n_layers - 1})
        self.calls = 0
        self.checks = []

    def __enter__(self):
        from seldon_tpu_torch.ops import flash_attention as fa

        self._fa, self._orig = fa, fa.flash_kernel

        def check(q, k, v, causal, q_offset, block_k, q_per_kv, out,
                  layer):
            want = fa.flash_blockwise(q, k, v, causal, q_offset, block_k,
                                      q_per_kv)
            self.checks.append(dict(compare_flash(out, want), layer=layer))

        def tapped(q, k, v, causal, q_offset, block_q, block_k, q_per_kv):
            out = self._orig(q, k, v, causal, q_offset, block_q, block_k,
                             q_per_kv)
            layer = self.calls % self.n_layers
            if layer in self.layers:
                on_host(functools.partial(check, q, k, v, causal, q_offset,
                                          block_k, q_per_kv, out, layer))
            self.calls += 1
            return out

        fa.flash_kernel = tapped
        recapture()
        return self

    def __exit__(self, *exc):
        self._fa.flash_kernel = self._orig
        recapture()


class LaunchTimer:
    """Instrumentation of this script: while active, a CUDA event pair
    brackets each B2 launch; ``ms()`` sums their device times."""

    def __enter__(self):
        import torch

        from seldon_tpu_torch.ops import flash_attention as fa

        self._fa, self._orig = fa, fa.flash_kernel
        self.events = []

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(*args)
            end.record()
            self.events.append((start, end))
            return out

        fa.flash_kernel = timed
        return self

    def __exit__(self, *exc):
        self._fa.flash_kernel = self._orig

    def ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def per_position_max_diff(a, b):
    """max over the vocabulary of |a - b| at each position, [B, S] (one
    batch row at a time, to bound the temporaries)."""
    import torch

    return torch.stack([(a[i] - b[i]).abs().amax(dim=-1)
                        for i in range(a.shape[0])])


def phase_score(srv, dev):
    """score_nll at full depth with attn_impl="flash" on the served
    weights (the main path of B2). Gates: B2 launches exactly once per
    layer; on the path's own inputs (first, middle and last layer) B2
    agrees with its plain version under the phase-3b gate; the median
    over positions of max |flash logits - xla logits| is at most
    SCORE_DRIFT_MAX times the same median for the xla path with one
    embedding value per token nudged by one bf16 ulp (the model's noise
    floor at this width, ROADMAP.md C1)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.ops import flash_attention as fa
    from seldon_tpu_torch.servers.torchserver import mean_nll, score_nll

    params, cfg = srv.params, srv.cfg
    flash = dataclasses.replace(cfg, attn_impl="flash")
    xla = dataclasses.replace(cfg, attn_impl="xla")
    gen = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (SCORE_B, SCORE_S),
                         generator=gen, device=dev)
    tap = FlashTap(cfg.n_layers)
    fa.reset_launches()  # count only the scoring path's launches
    with tap:
        nll_flash = score_nll(params, toks, flash)
    torch.cuda.synchronize()
    launches = fa.launches
    launches_tc = fa.entry_launches["flash_attention_bf16_fwd"]
    if launches != cfg.n_layers or launches_tc != launches:
        raise AssertionError(f"B2 launches {launches} per score call "
                             f"({launches_tc} on the tensor-core route) != "
                             f"layers {cfg.n_layers}")
    if len(tap.checks) != len(tap.layers) or not all(c["ok"] for c in
                                                     tap.checks):
        raise AssertionError(f"B2 disagrees with its plain version on the "
                             f"scoring path's inputs: {tap.checks}")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    with LaunchTimer() as timer:
        start.record()
        score_nll(params, toks, flash)
        end.record()
        end.synchronize()
        kernel_ms = timer.ms()
    call_ms = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        score_nll(params, toks, flash)
        torch.cuda.synchronize()
    busy_ms, span_ms, by_name = device_breakdown(prof)
    top_dev = [{"name": k, "ms": v[0], "count": v[1]}
               for k, v in by_name[:12]]
    lx = transformer.forward(params, toks, xla)
    nll_xla = mean_nll(lx, toks)
    lf = transformer.forward(params, toks, flash)
    d_flash = per_position_max_diff(lf, lx)
    del lf
    with EmbedNudge():
        ln = transformer.forward(params, toks, xla)
    nll_nudged = mean_nll(ln, toks)
    d_nudge = per_position_max_diff(ln, lx)
    del ln, lx
    gc.collect()
    torch.cuda.empty_cache()
    med_f, med_n = d_flash.median().item(), d_nudge.median().item()
    out = {
        "B": SCORE_B, "S": SCORE_S, "launches": launches,
        "tap": tap.checks,
        "nll_flash": nll_flash.tolist(), "nll_xla": nll_xla.tolist(),
        "nll_nudged": nll_nudged.tolist(),
        "median_logit_diff_flash_vs_xla": med_f,
        "median_logit_diff_nudged_vs_xla": med_n,
        "max_logit_diff_flash_vs_xla": d_flash.max().item(),
        "max_logit_diff_nudged_vs_xla": d_nudge.max().item(),
        "drift_ratio": med_f / max(med_n, 1e-30),
        "call_ms": call_ms, "kernel_ms": kernel_ms,
        "kernel_share": kernel_ms / call_ms,
        "profile": {"device_busy_ms": busy_ms, "device_span_ms": span_ms,
                    "top_device": top_dev},
    }
    log(f"score {srv.preset} layers={cfg.n_layers} B={SCORE_B} S={SCORE_S} "
        f"flash launches={launches} (expected {cfg.n_layers}); tap layers "
        f"{[c['layer'] for c in tap.checks]} max_abs "
        f"{max(c['max_abs_err'] for c in tap.checks):.3g} beyond one ulp "
        f"{sum(c['beyond_ulp'] for c in tap.checks)}")
    log(f"score nll flash={[round(x, 5) for x in out['nll_flash']]} "
        f"xla={[round(x, 5) for x in out['nll_xla']]} "
        f"nudged={[round(x, 5) for x in out['nll_nudged']]}; median "
        f"|dlogit| flash vs xla {med_f:.4g}, nudged vs xla {med_n:.4g} "
        f"(ratio {out['drift_ratio']:.3f}, max {SCORE_DRIFT_MAX})")
    log(f"score call_ms={call_ms:.1f} B2 kernel_ms={kernel_ms:.1f} over "
        f"{len(timer.events)} launches: kernel share {out['kernel_share']:.3f}")
    log(f"score profile: device_busy_ms={busy_ms:.1f} "
        f"device_span_ms={span_ms:.1f}")
    for d in top_dev[:8]:
        log(f"score profile device {d['ms']:9.2f} ms {d['count']:6d}x "
            f"{d['name'][:90]}")
    if out["drift_ratio"] > SCORE_DRIFT_MAX:
        raise AssertionError(f"flash logits drift from xla by more than "
                             f"{SCORE_DRIFT_MAX}x the one-ulp floor: {out}")
    return out


def phase_generate(srv, dev):
    """The whole-batch generate on the served weights: 8 right-padded
    prompts in the 512 bucket, 32 greedy tokens, flash config (run twice:
    the first run's B2 launches are gated at one per layer, the second is
    timed) and xla config (no B2 launch). Streams are reported, not
    gated (ROADMAP.md C1)."""
    import numpy as np
    import torch

    from seldon_tpu_torch.models.generate import generate
    from seldon_tpu_torch.ops import flash_attention as fa

    params, cfg = srv.params, srv.cfg
    B = len(GEN_PROMPT_LENS)
    rng = np.random.default_rng(1)
    toks = np.full((B, GEN_BUCKET), cfg.pad_token_id, np.int32)
    for b, n in enumerate(GEN_PROMPT_LENS):
        toks[b, :n] = rng.integers(0, 256, n)
    tokens = torch.from_numpy(toks).to(dev)
    plens = torch.tensor(GEN_PROMPT_LENS, dtype=torch.int32, device=dev)
    knobs = (torch.zeros(B, device=dev),
             torch.zeros(B, dtype=torch.int32, device=dev),
             torch.ones(B, device=dev))

    def run(impl):
        c = dataclasses.replace(cfg, attn_impl=impl)
        fa.reset_launches()  # count only this generate call's launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # Key 0: jax.random.key(0)'s twin (greedy rows ignore the noise).
        out, lens = generate(params, tokens, plens, 0, *knobs, c, GEN_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return {"launches": fa.launches,
                "launches_tc": fa.entry_launches["flash_attention_bf16_fwd"],
                "wall_s": wall,
                "tokens_per_s": B * GEN_NEW / wall,
                "streams": out.tolist(), "lens": lens.tolist()}

    first = run("flash")
    res = {"flash": run("flash"), "xla": run("xla"),
           "flash_first": {k: first[k] for k in ("launches", "launches_tc",
                                                 "wall_s")}}
    if first["launches"] != cfg.n_layers or \
            first["launches_tc"] != first["launches"]:
        raise AssertionError(f"B2 launches {first['launches']} per generate "
                             f"call ({first['launches_tc']} on the "
                             f"tensor-core route) != layers {cfg.n_layers}")
    if res["xla"]["launches"] != 0:
        raise AssertionError("the xla config launched B2")
    if res["flash"]["streams"] != first["streams"]:
        raise AssertionError("greedy generate is not repeatable")
    parts = [next((j for j, (a, b) in enumerate(zip(f, x)) if a != b), None)
             for f, x in zip(res["flash"]["streams"], res["xla"]["streams"])]
    res["equal_streams"] = sum(p is None for p in parts)
    res["first_parting"] = parts
    log(f"generate B={B} prompts {GEN_PROMPT_LENS[0]}-{GEN_PROMPT_LENS[-1]} "
        f"new={GEN_NEW} flash launches={first['launches']} (expected "
        f"{cfg.n_layers}); tokens_per_s flash="
        f"{res['flash']['tokens_per_s']:.1f} xla="
        f"{res['xla']['tokens_per_s']:.1f} (first flash call "
        f"{first['wall_s']:.2f} s); greedy streams flash vs xla equal "
        f"{res['equal_streams']}/{B}, first parting at {parts}")
    return res


def phase_predict(srv):
    import numpy as np

    X = np.random.default_rng(2).integers(0, 256, (2, 512))
    t0 = time.perf_counter()
    nll = srv.predict(X, names=[])
    wall = time.perf_counter() - t0
    if nll.shape != (2,) or not np.isfinite(nll).all():
        raise AssertionError(f"predict returned {nll!r}")
    log(f"predict B=2 S=512 nll={nll.tolist()} wall_s={wall:.3f}")
    return {"nll": nll.tolist(), "wall_s": wall}


# ---------------------------------------------------------------------------
# Phase 9b: the serving runtime on real sockets
# ---------------------------------------------------------------------------

# Libraries each transport needs on this host (the wrapper module imports
# aiohttp, grpc and protobuf together).
WIRE_NEEDS = {
    "rest": ("aiohttp", "grpc", "google.protobuf"),
    "ndjson": ("aiohttp", "grpc", "google.protobuf"),
    "grpc": ("aiohttp", "grpc", "google.protobuf"),
    "fast": ("google.protobuf",),
}
WIRE_PROMPTS = 3  # greedy prompts sent one at a time through every route
CANCEL_NEW = 512  # the cancelled stream's budget: it must not end first
CANCEL_WAIT_S = 5.0


def host_libraries():
    """{library: version or None} of the transport libraries here, and of
    the libraries the prepackaged servers' library routes use."""
    import importlib
    import importlib.util

    out = {}
    for name in ("aiohttp", "grpc", "google.protobuf", "prometheus_client",
                 "sklearn", "yaml", "joblib", "requests"):
        try:
            found = importlib.util.find_spec(name) is not None
        except ModuleNotFoundError:  # a parent package is missing
            found = False
        out[name] = (getattr(importlib.import_module(name), "__version__",
                             "present") if found else None)
    return out


class RestThread:
    """The REST app of one unit served from an event loop on a background
    thread, on 127.0.0.1 port 0 (a loop that hosts it must not be blocked
    by the caller's requests)."""

    def __init__(self, app):
        import asyncio

        from aiohttp import web

        self._stop = threading.Event()
        started = threading.Event()
        self.errors = []

        async def amain():
            runner = web.AppRunner(app)
            await runner.setup()
            site = web.TCPSite(runner, "127.0.0.1", 0)
            await site.start()
            self.port = site._server.sockets[0].getsockname()[1]
            started.set()
            while not self._stop.is_set():
                await asyncio.sleep(0.02)
            await runner.cleanup()

        def run():
            try:
                asyncio.run(amain())
            except BaseException as e:  # re-raised by close(), never lost
                self.errors.append(e)
                started.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not started.wait(60) or self.errors:
            raise RuntimeError(f"REST server did not start: {self.errors}")

    def close(self):
        self._stop.set()
        self._thread.join(60)
        if self._thread.is_alive() or self.errors:
            raise RuntimeError(f"REST server did not stop: {self.errors}")


def http_post(port, path, body, timeout=600):
    """(status, body bytes) of one JSON POST."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def http_get(port, path, timeout=60):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def ndjson_stream(port, body, timeout=600):
    """POST /generate_stream and read the chunked NDJSON lines with the
    stdlib client. Returns (tokens, seconds to the first line, seconds to
    the end), both from the request's send."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/generate_stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"/generate_stream answered {resp.status}:"
                                 f" {resp.read()[:500]!r}")
        toks, first = [], None
        while True:
            line = resp.readline()
            if not line:
                break
            if first is None:
                first = time.perf_counter() - t0
            item = json.loads(line)
            if "error" in item:
                raise AssertionError(f"stream failed mid-way: {item}")
            toks.extend(item["token_ids"])
        return toks, first, time.perf_counter() - t0
    finally:
        conn.close()


def wait_idle(eng, timeout_s=60.0):
    """Wait until the engine holds no request (its audit takes the lock
    every dispatch runs under, so no wave is half dispatched then)."""
    deadline = time.perf_counter() + timeout_s
    while eng.debug_lifecycle_check():
        if time.perf_counter() > deadline:
            raise AssertionError(f"engine not idle: "
                                 f"{eng.debug_lifecycle_check()}")
        time.sleep(0.005)


def phase_wire(srv, reqs, toks, serve, dev):
    """The serving runtime (``seldon_tpu_torch/runtime``) in front of a
    ``TorchServer(preset="llama3-8b", ragged=1, ragged_kernel="pallas")``
    on the card, with phase 4's weights (assigned before ``load()``), over
    real sockets: the REST app (``/generate``, NDJSON
    ``/generate_stream``, ``/ready``, ``/metrics``) on an event loop on a
    background thread, the gRPC server (``TextGen``), and the framed fast
    lane (``predict``). Clients are the stdlib's ``http.client``, the
    port's ``TextGenStub`` and ``FastClient``.

    Gates, in order: (1) three greedy prompts, one at a time, give equal
    tokens in-process (``generate`` and the joined ``generate_stream``)
    and over REST ``/generate``, NDJSON, gRPC ``Generate`` and gRPC
    ``GenerateStream``; (2) B1 launched layers x wave legs over those
    requests; the fast lane's ``predict`` equals the in-process one;
    (3) reported only: phase 4's 8 requests at once over NDJSON: tokens/s,
    the client's time to the first line (p50/p95) and the engine's mean
    TTFT over the burst, beside phase 4's in-process tokens/s; (4) a
    stream closed after its first line raises ``cancelled_total`` by one
    within 5 s, and the engine audits clean; (5) ``/metrics`` shows the
    ITL, goodput and deadline-margin series; ``/ready`` is 200, then 503
    after ``drain()``. A transport is left out only where its library is
    absent on this host; any failure of one that ran fails the phase."""
    import http.client
    import socket

    import numpy as np

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.torchserver import TorchServer

    libs = host_libraries()
    log("wire host libraries " + " ".join(
        f"{k}={v}" for k, v in libs.items()))
    transports = [t for t, needs in WIRE_NEEDS.items()
                  if all(libs[n] for n in needs)]
    log(f"wire transports={','.join(transports)}")
    out = {"libraries": libs, "transports": transports}

    wsrv = TorchServer(preset="llama3-8b", max_slots=32, max_seq_len=2048,
                       ragged=1, ragged_kernel="pallas", init_seed=0,
                       device=dev)
    wsrv.params, wsrv.cfg = srv.params, srv.cfg
    t0 = time.perf_counter()
    wsrv.load()
    out["load_s"] = time.perf_counter() - t0
    cfg, eng = wsrv.cfg, wsrv.engine
    rest = gsrv = fast = None
    try:
        if "rest" in transports or "grpc" in transports:
            from seldon_tpu_torch.runtime import wrapper
        if "rest" in transports:
            rest = RestThread(wrapper.build_rest_app(wsrv))
        if "grpc" in transports:
            import grpc

            from seldon_tpu_torch.proto import prediction_grpc
            from seldon_tpu_torch.proto import prediction_pb2 as pb

            gsrv = wrapper.build_grpc_server(wsrv)
            gport = gsrv.add_insecure_port("127.0.0.1:0")
            gsrv.start()
            channel = grpc.insecure_channel(f"127.0.0.1:{gport}")
            stub = prediction_grpc.TextGenStub(channel)

            def grpc_req(r):
                return pb.GenerateRequest(
                    prompt_token_ids=r["prompt_token_ids"],
                    max_new_tokens=r["max_new_tokens"],
                    temperature=r["temperature"], seed=r["seed"])

        def inproc_stream(r):
            return [t for c in wsrv.generate_stream(r) if c is not None
                    for t in c["token_ids"]]

        routes = {"inproc": lambda r: wsrv.generate(r)["token_ids"],
                  "inproc_stream": inproc_stream}
        if rest is not None:
            def rest_generate(r):
                status, raw = http_post(rest.port, "/generate", r)
                if status != 200:
                    raise AssertionError(f"/generate answered {status}: "
                                         f"{raw[:500]!r}")
                return json.loads(raw)["token_ids"]

            routes["rest"] = rest_generate
            routes["ndjson"] = lambda r: ndjson_stream(rest.port, r)[0]
        if gsrv is not None:
            routes["grpc"] = lambda r: list(
                stub.Generate(grpc_req(r), timeout=600).token_ids)
            routes["grpc_stream"] = lambda r: [
                t for c in stub.GenerateStream(grpc_req(r), timeout=600)
                for t in c.token_ids]

        # (1)-(2): one request at a time keeps every wave's composition
        # the same on every route (ROADMAP.md C1).
        greedy = reqs[:WIRE_PROMPTS]
        rpa.launches = 0
        streams = {name: [fn(r) for r in greedy]
                   for name, fn in routes.items()}
        wait_idle(eng)
        launches = rpa.launches
        snap = eng.stats.snapshot()
        expected = cfg.n_layers * (snap["decode_dispatches"]
                                   + snap["prefill_waves"])
        want = streams["inproc"]
        if any(not s for s in want):
            raise AssertionError("a request returned no tokens")
        differ = [name for name, s in streams.items() if s != want]
        if differ:
            raise AssertionError(f"routes {differ} differ from the "
                                 f"in-process tokens: {streams}")
        if launches != expected:
            raise AssertionError(
                f"wire: kernel launches {launches} != layers x legs "
                f"{expected} ({snap['decode_dispatches']} waves, "
                f"{snap['prefill_waves']} prefill waves)")
        log(f"wire routes={','.join(routes)} prompts={len(greedy)} "
            f"tokens_equal=True kernel_launches={launches} (expected "
            f"{expected}) waves={snap['decode_dispatches']} "
            f"prefill_waves={snap['prefill_waves']}")
        out.update(routes=list(routes), tokens=want, launches=launches,
                   expected_launches=expected,
                   waves=snap["decode_dispatches"],
                   prefill_waves=snap["prefill_waves"])

        if "fast" in transports:
            from seldon_tpu_torch.core import payloads
            from seldon_tpu_torch.runtime import fastpath

            X = np.random.default_rng(2).integers(0, 256, (2, 512))
            fast, fport = fastpath.start_fast_server(wsrv, "127.0.0.1", 0)
            client = fastpath.FastClient(timeout_s=600)
            try:
                got = payloads.get_data_from_message(client.call(
                    "127.0.0.1", fport, "predict",
                    payloads.build_message(X.astype(np.int32))))
            finally:
                client.close()
            local = wsrv.predict(X, names=[])
            if not np.array_equal(got, local):
                raise AssertionError(f"fast-lane predict {got} != "
                                     f"in-process {local}")
            log(f"wire fast predict B=2 S=512 nll={got.tolist()} "
                f"equal_to_in_process=True")
            out["fast_predict_nll"] = got.tolist()

        if rest is None:
            return out
        # (3) phase 4's burst at once over NDJSON.
        with eng.stats.lock:
            ttft0 = (eng.stats.ttft_sum, eng.stats.ttft_count)
        results, wall = run_concurrent(
            lambda r: ndjson_stream(rest.port, r), reqs, timeout_s=600)
        with eng.stats.lock:
            ttft_ms = 1000.0 * (eng.stats.ttft_sum - ttft0[0]) / max(
                1, eng.stats.ttft_count - ttft0[1])
        n_tok = sum(len(t) for t, _, _ in results)
        first_ms = sorted(1000.0 * f for _, f, _ in results)
        p50, p95 = (float(np.percentile(first_ms, q)) for q in (50, 95))
        same = sum(t == s for (t, _, _), s in zip(results, toks))
        log(f"wire burst ndjson requests={len(reqs)} tokens={n_tok} "
            f"wall_s={wall:.3f} tokens_per_s={n_tok / wall:.1f} "
            f"(9a's in-process burst {serve['tokens_per_s']:.1f}) "
            f"client_first_line_ms p50={p50:.1f} p95={p95:.1f} "
            f"engine_mean_ttft_ms={ttft_ms:.1f} "
            f"streams_equal_to_phase4={same}/{len(reqs)} (reported only)")
        out["burst"] = {"requests": len(reqs), "tokens": n_tok,
                        "wall_s": wall, "tokens_per_s": n_tok / wall,
                        "inproc_tokens_per_s": serve["tokens_per_s"],
                        "client_first_line_ms": first_ms,
                        "client_first_line_p50_ms": p50,
                        "client_first_line_p95_ms": p95,
                        "engine_mean_ttft_ms": ttft_ms,
                        "streams_equal_to_phase4": same}

        # (4) a client that hangs up after its first line. The request is
        # one whose stream in (1), alone as here, ran its whole budget
        # without an EOS, so it cannot end by itself in the first tokens.
        full = [r for r, t in zip(greedy, want) if len(t) == MAX_NEW]
        if not full:
            raise AssertionError("no greedy stream ran its whole budget")
        before = eng.stats.snapshot()["cancelled_total"]
        conn = http.client.HTTPConnection("127.0.0.1", rest.port,
                                          timeout=600)
        body = dict(full[0], max_new_tokens=CANCEL_NEW)
        conn.request("POST", "/generate_stream", body=json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200 or not json.loads(resp.readline())[
                "token_ids"]:
            raise AssertionError("the cancelled stream sent no first line")
        t_close = time.perf_counter()
        conn.sock.shutdown(socket.SHUT_RDWR)
        conn.close()
        while (eng.stats.snapshot()["cancelled_total"] == before
               and time.perf_counter() - t_close < CANCEL_WAIT_S):
            time.sleep(0.005)
        cancel_s = time.perf_counter() - t_close
        if eng.stats.snapshot()["cancelled_total"] != before + 1:
            raise AssertionError(f"cancelled_total did not rise by 1 within "
                                 f"{CANCEL_WAIT_S} s of the hang-up")
        leaks = eng.debug_lifecycle_check()
        while leaks and time.perf_counter() - t_close < 2 * CANCEL_WAIT_S:
            time.sleep(0.01)
            leaks = eng.debug_lifecycle_check()
        if leaks:
            raise AssertionError(f"lifecycle leaks after the cancel: {leaks}")
        log(f"wire cancel: cancelled_total +1 after {cancel_s:.3f} s, "
            f"lifecycle audit clean")
        out["cancel_s"] = cancel_s

        # (5) metrics and readiness.
        status, text = http_get(rest.port, "/metrics")
        series = ("torchserver_itl_p50_ms", "torchserver_goodput",
                  "torchserver_deadline_margin_ms_bucket")
        missing = [s for s in series if s.encode() not in text]
        if status != 200 or missing:
            raise AssertionError(f"/metrics {status} lacks {missing}")
        ready = http_get(rest.port, "/ready")[0]
        if ready != 200:
            raise AssertionError(f"/ready answered {ready} before drain")
        if not wsrv.drain(timeout=60):
            raise AssertionError("drain did not reach quiescence")
        drained = http_get(rest.port, "/ready")[0]
        if drained != 503:
            raise AssertionError(f"/ready answered {drained} after drain")
        snap = eng.stats.snapshot()
        log(f"wire metrics: {', '.join(series)} exposed; itl_p50_ms="
            f"{snap['itl_p50_ms']} itl_p95_ms={snap['itl_p95_ms']} "
            f"goodput={snap['goodput']}; /ready 200 -> 503 after drain")
        out.update(ready_before=ready, ready_after_drain=drained,
                   itl_p50_ms=snap["itl_p50_ms"],
                   itl_p95_ms=snap["itl_p95_ms"],
                   mean_itl_ms=snap["mean_itl_ms"])
        return out
    finally:
        if fast is not None:
            fast.shutdown()
            fast.server_close()
        if gsrv is not None:
            channel.close()
            gsrv.stop(grace=1)
        if rest is not None:
            rest.close()
        wsrv.stop()


# ---------------------------------------------------------------------------
# Phase 9c: the inference-graph orchestrator in front of llama3-8b units
# ---------------------------------------------------------------------------

GRAPH_S = 512  # tokens per row of the graph phase's requests
GRAPH_REPS = 6  # sequential requests timed per graph and transport
GRAPH_FUSE = 8  # concurrent requests of g5


class EngineThread:
    """The port's ``EngineServer`` started on 127.0.0.1 (ephemeral ports)
    from an event loop on a background thread: a blocking client call on
    the loop that hosts grpc.aio would deadlock it."""

    def __init__(self, es):
        import asyncio

        self.es = es
        self.errors = []
        self._stop = threading.Event()
        started = threading.Event()

        async def amain():
            await es.start(host="127.0.0.1")
            started.set()
            while not self._stop.is_set():
                await asyncio.sleep(0.02)
            await es.stop()

        def run():
            try:
                asyncio.run(amain())
            except BaseException as e:  # re-raised by close(), never lost
                self.errors.append(e)
                started.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        if not started.wait(60) or self.errors:
            raise RuntimeError(f"engine server did not start: {self.errors}")
        self.http, self.grpc = es.http_port, es.grpc_port

    def close(self):
        self._stop.set()
        self._thread.join(60)
        if self._thread.is_alive() or self.errors:
            raise RuntimeError(f"engine server did not stop: {self.errors}")


class GraphUnit:
    """Instrumentation of this script: the llama3-8b server as a graph's
    unit. Each ``predict`` goes to the server unchanged; the unit keeps
    the rows, the request's ``batch_index`` tag (set by the engine's
    micro-batcher on a fused call) and the answer, so that g5's answers
    can be held to the rows of the fused call that produced them."""

    def __init__(self, srv):
        self.srv = srv
        self.calls = []

    def predict(self, X, names, meta=None):
        out = self.srv.predict(X, names, meta)
        tag = ((meta or {}).get("tags") or {}).get("batch_index")
        if tag:
            self.calls.append((tag, out))
        return out

    def tags(self):
        return self.srv.tags()


def percentiles_ms(seconds):
    import numpy as np

    ms = [1000.0 * s for s in seconds]
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 95))


def phase_graph(srv):
    """The port's orchestrator (``seldon_tpu_torch/orchestrator``) in front
    of the llama3-8b ``TorchServer`` of phase 4 (full width, its weights,
    scoring with the preset's ``"xla"`` attention as ``JAXServer.predict``
    does: no hand-written kernel lies on this path). The server is one
    unit behind the port's wrapper on 127.0.0.1: REST, gRPC and the fast
    lane. ``EngineServer`` instances run on an event loop on a background
    thread; clients are the stdlib's ``http.client`` and the port's
    ``SeldonStub`` / ``ModelStub``.

    Graphs: g1 a solo MODEL over gRPC with the fast lane (sync lane,
    unbatched); g2 a solo MODEL over REST, proto then JSON (asyncio lane);
    g3 ``RANDOM_ABTEST`` over the unit reached over gRPC and over REST; g4
    ``AVERAGE_COMBINER`` over the same two children; g5 g1's graph with the
    micro-batcher on, 8 concurrent requests carrying the same row.

    Gates (any failure raises): every g1-g4 answer over REST and gRPC is
    bit-equal to ``srv.predict`` on the same rows ([1, 512] and [2, 512]
    token ids); ``requestPath`` names the units walked; g3's ``routing``
    names the branch that answered; g1 rides the sync lane; g5 fuses
    (``fused_calls`` >= 1, ``batched_requests`` > 1) and each fused answer
    equals its rows of the fused call's ``predict``, each direct one the
    solo ``predict``; a feedback through g3 answers 200 and moves the
    reward counter; ``/ready`` 200 and ``seldon_graph_ready 1.0``. A
    transport library missing here fails the phase.

    Reported: p50 / p95 of GRAPH_REPS sequential requests per graph and
    transport, the p50 of a direct unit call on the same rows over the
    same transport, made in turns with them, and their difference (the
    orchestrator's hop; also the median of the 20 paired differences),
    the p50 of a ``SIMPLE_MODEL`` graph (the walk alone), g5's fused
    calls, batched requests and wall time, and fused-vs-solo NLL
    differences."""
    import numpy as np

    libs = host_libraries()
    missing = [n for n in ("aiohttp", "grpc", "google.protobuf") if not
               libs[n]]
    if missing:
        raise AssertionError(f"graph: transport libraries missing: {missing}")
    import grpc

    from seldon_tpu_torch.core import payloads
    from seldon_tpu_torch.orchestrator.server import EngineServer
    from seldon_tpu_torch.orchestrator.spec import (PredictorSpec,
                                                    default_unit_types)
    from seldon_tpu_torch.proto import prediction_grpc
    from seldon_tpu_torch.proto import prediction_pb2 as pb
    from seldon_tpu_torch.runtime import fastpath, wrapper
    from seldon_tpu_torch.runtime.metrics_server import ServerMetrics

    rng = np.random.default_rng(9)
    vocab = srv.cfg.vocab_size
    X1 = rng.integers(0, vocab, (1, GRAPH_S))
    X2 = rng.integers(0, vocab, (2, GRAPH_S))
    want1 = srv.predict(X1, names=[])
    want2 = srv.predict(X2, names=[])
    out = {"card": card_line(), "S": GRAPH_S, "reps": GRAPH_REPS}

    unit = GraphUnit(srv)
    channels = []
    rest = gsrv = fast = fast_client = None
    try:
        rest = RestThread(wrapper.build_rest_app(unit))
        gsrv = wrapper.build_grpc_server(unit)
        gport = gsrv.add_insecure_port("127.0.0.1:0")
        gsrv.start()
        fast, fport = fastpath.start_fast_server(unit, "127.0.0.1", 0)

        def stub(port, kind="Seldon"):
            ch = grpc.insecure_channel(f"127.0.0.1:{port}")
            channels.append(ch)
            return prediction_grpc.STUBS[kind](ch)

        def ep(port, type_="GRPC", **kw):
            return {"service_host": "127.0.0.1", "service_port": port,
                    "type": type_, **kw}

        by_grpc = {"name": "via-grpc", "type": "MODEL", "endpoint": ep(gport)}
        by_rest = {"name": "via-rest", "type": "MODEL",
                   "endpoint": ep(rest.port, "REST")}
        solo = {"name": "llm", "type": "MODEL",
                "image": "torchserver:llama3-8b",
                "endpoint": ep(gport, fast_port=fport)}
        graphs = {
            "g1": (solo, False, {"llm"}),
            "g2_proto": (dict(by_rest, name="llm"), False, {"llm"}),
            "g2_json": (dict(by_rest, name="llm",
                             endpoint=ep(rest.port, "REST", content="json")),
                        False, {"llm"}),
            "g3": ({"name": "ab", "implementation": "RANDOM_ABTEST",
                    "children": [by_grpc, by_rest]}, False, None),
            "g4": ({"name": "mean", "implementation": "AVERAGE_COMBINER",
                    "children": [by_grpc, by_rest]}, False,
                   {"mean", "via-grpc", "via-rest"}),
            "walk_only": ({"name": "simple", "implementation": "SIMPLE_MODEL"},
                          False, {"simple"}),
            "g5": (solo, True, {"llm"}),
        }

        def engine(name):
            graph, batching, _ = graphs[name]
            spec = PredictorSpec.from_dict({"name": name, "graph": graph})
            default_unit_types(spec.graph)
            return EngineThread(EngineServer(
                spec=spec, http_port=0, grpc_port=0, enable_batching=batching,
                metrics=ServerMetrics()))

        def ask(et, X, puid, transport, seldon):
            """(NLLs as f64, requestPath, routing, seconds) of one request."""
            t0 = time.perf_counter()
            if transport == "grpc":
                msg = payloads.build_message(X.astype(np.float64))
                msg.meta.puid = puid
                resp = seldon.Predict(msg, timeout=600)
                dt = time.perf_counter() - t0
                return (np.asarray(payloads.get_data_from_message(resp),
                                   np.float64), dict(resp.meta.requestPath),
                        dict(resp.meta.routing), dt)
            status, raw = http_post(
                et.http, "/api/v0.1/predictions",
                {"data": {"ndarray": X.tolist()}, "meta": {"puid": puid}})
            dt = time.perf_counter() - t0
            if status != 200:
                raise AssertionError(f"engine answered {status}: "
                                     f"{raw[:500]!r}")
            body = json.loads(raw)
            return (np.asarray(payloads.get_data_from_message(
                payloads.dict_to_message(body)), np.float64),
                body["meta"]["requestPath"],
                body["meta"].get("routing", {}), dt)

        def direct(transport, X):
            """One direct unit call (no engine) and its seconds."""
            t0 = time.perf_counter()
            if transport == "grpc":
                got = payloads.get_data_from_message(model_stub.Predict(
                    payloads.build_message(X.astype(np.float64)), timeout=600))
            elif transport == "rest":
                status, raw = http_post(
                    rest.port, "/predict", {"data": {"ndarray": X.tolist()}})
                if status != 200:
                    raise AssertionError(f"unit answered {status}")
                got = payloads.get_data_from_message(
                    payloads.dict_to_message(json.loads(raw)))
            else:
                got = payloads.get_data_from_message(fast_client.call(
                    "127.0.0.1", fport, "predict",
                    payloads.build_message(X.astype(np.float64))))
            dt = time.perf_counter() - t0
            if not np.array_equal(np.asarray(got, np.float32), want1):
                raise AssertionError(f"direct {transport} unit call {got} != "
                                     f"predict {want1}")
            return dt
        model_stub = stub(gport, "Model")
        fast_client = fastpath.FastClient(timeout_s=600)
        # Direct unit calls: the baseline of each transport.
        base = {}
        for transport in ("grpc", "rest", "fast"):
            direct(transport, X1)  # warm
            base[transport] = percentiles_ms(
                [direct(transport, X1) for _ in range(GRAPH_REPS)])
        t0 = time.perf_counter()
        for _ in range(GRAPH_REPS):
            srv.predict(X1, names=[])
        inproc_ms = 1000.0 * (time.perf_counter() - t0) / GRAPH_REPS
        log(f"graph direct unit p50/p95 ms: grpc={base['grpc'][0]:.2f}/"
            f"{base['grpc'][1]:.2f} rest={base['rest'][0]:.2f}/"
            f"{base['rest'][1]:.2f} fast={base['fast'][0]:.2f}/"
            f"{base['fast'][1]:.2f}; in-process predict mean "
            f"{inproc_ms:.2f} ms (B 1 x S {GRAPH_S})")
        out["direct_ms"] = {t: {"p50": p[0], "p95": p[1]}
                            for t, p in base.items()}
        out["inproc_predict_mean_ms"] = inproc_ms

        out["graphs"] = {}
        for name in ("g1", "g2_proto", "g2_json", "g3", "g4", "walk_only"):
            et = engine(name)
            try:
                lane = type(et.es._grpc_server).__name__
                if name == "g1" and lane != "_Server":
                    raise AssertionError(f"g1 is not on the sync lane: {lane}")
                if name in ("g2_proto", "g2_json") and lane != "Server":
                    raise AssertionError(f"{name} is not on the asyncio "
                                         f"lane: {lane}")
                seldon = stub(et.grpc)
                res = {"lane": "sync" if lane == "_Server" else "asyncio"}
                for transport in ("rest", "grpc"):
                    # In turns with a direct unit call over the same
                    # transport, so that both sample the same moments of
                    # the host and the card.
                    seen, paired = [], []
                    for i, X in enumerate([X2] + [X1] * GRAPH_REPS):
                        nll, path, routing, dt = ask(
                            et, X, f"{name}-{transport}-{i}", transport,
                            seldon)
                        seen.append((nll, path, routing, dt))
                        if i and name != "walk_only":
                            paired.append(direct(transport, X1))
                    for i, (nll, path, routing, _) in enumerate(seen):
                        want_paths = graphs[name][2]
                        if name == "g3":
                            if set(routing) != {"ab"}:
                                raise AssertionError(f"g3 routing {routing}")
                            want_paths = {"ab", ("via-grpc", "via-rest")[
                                routing["ab"]]}
                        if set(path) != want_paths:
                            raise AssertionError(f"{name} requestPath {path} "
                                                 f"!= {want_paths}")
                        if name == "walk_only":
                            continue
                        want = want2 if i == 0 else want1
                        if not np.array_equal(nll, want.astype(np.float64)):
                            raise AssertionError(
                                f"{name} over {transport}: {nll} != "
                                f"srv.predict {want}")
                    p50, p95 = percentiles_ms([s[3] for s in seen[1:]])
                    res[transport] = {"p50_ms": p50, "p95_ms": p95}
                    if name == "walk_only":
                        log(f"graph {name} (SIMPLE_MODEL, {res['lane']} lane)"
                            f" over {transport}: p50={p50:.3f} p95="
                            f"{p95:.3f} ms")
                        continue
                    direct_p50 = percentiles_ms(paired)[0]
                    hop = p50 - direct_p50
                    pair_hop = float(np.median(
                        [1000.0 * (s[3] - d) for s, d in zip(seen[1:],
                                                             paired)]))
                    res[transport].update(direct_p50_ms=direct_p50,
                                          hop_p50_ms=hop,
                                          hop_paired_median_ms=pair_hop)
                    if name == "g3":
                        res[transport]["branches"] = sorted(
                            {s[2]["ab"] for s in seen})
                    log(f"graph {name} ({res['lane']} lane) over {transport}"
                        f": p50={p50:.2f} p95={p95:.2f} ms, direct unit "
                        f"p50={direct_p50:.2f} ms in turns, hop={hop:.2f} ms"
                        f" (median of paired differences {pair_hop:.2f} ms),"
                        f" NLL bit-equal to srv.predict")
                if name == "g3":
                    ready = http_get(et.http, "/ready")[0]
                    if ready != 200:
                        raise AssertionError(f"g3 /ready answered {ready}")
                    fb = {"reward": 1.0,
                          "request": {"data": {"ndarray": X1.tolist()}},
                          "response": {"meta": {"puid": "fb-1",
                                                "routing": {"ab": 1}}}}
                    status, raw = http_post(et.http, "/api/v0.1/feedback",
                                            fb)
                    if status != 200:
                        raise AssertionError(f"feedback answered {status}")
                    text = http_get(et.http, "/metrics")[1]
                    for series in (
                            b"seldon_graph_ready 1.0",
                            b'seldon_api_model_feedback_reward_total'
                            b'{unit="ab"} 1.0'):
                        if series not in text:
                            raise AssertionError(f"/metrics lacks {series}")
                    log("graph g3 feedback 200, reward counter +1.0; /ready "
                        "200; seldon_graph_ready 1.0")
                    res["feedback_status"] = status
                    res["ready"] = ready
                out["graphs"][name] = res
            finally:
                et.close()

        # g5: the micro-batcher fuses concurrent rows into one unit call.
        et = engine("g5")
        try:
            seldon = stub(et.grpc)
            ask(et, X1, "g5-warm", "grpc", seldon)  # connect the lanes
            before = dict(et.es.batcher.stats)
            unit.calls.clear()
            msgs = []
            for i in range(GRAPH_FUSE):
                msg = payloads.build_message(X1.astype(np.float64))
                msg.meta.puid = f"g5-{i}"
                msgs.append(msg)
            t0 = time.perf_counter()
            futs = [seldon.Predict.future(m, timeout=600) for m in msgs]
            answers = {m.meta.puid: np.asarray(
                payloads.get_data_from_message(f.result()), np.float32)
                for m, f in zip(msgs, futs)}
            wall = time.perf_counter() - t0
            stats = {k: et.es.batcher.stats[k] - before.get(k, 0)
                     for k in et.es.batcher.stats}
        finally:
            et.close()
        if stats["fused_calls"] < 1 or stats["batched_requests"] < 2:
            raise AssertionError(f"g5 did not fuse: {stats}")
        fused, sizes = {}, []
        for tag, nll in unit.calls:
            bi = pb.BatchIndex.FromString(bytes.fromhex(tag))
            sizes.append(len(bi.puids))
            row = 0
            for puid, n in zip(bi.puids, bi.row_counts):
                fused[puid] = np.asarray(nll[row: row + n])
                row += n
        if sum(1 for p in answers if p in fused) != stats["batched_requests"]:
            raise AssertionError(f"g5: fused puids {sorted(fused)} do not "
                                 f"match the stats {stats}")
        diffs = []
        for puid, got in answers.items():
            if puid in fused:
                if not np.array_equal(got, fused[puid]):
                    raise AssertionError(f"g5 {puid}: {got} != its row of "
                                         f"the fused predict {fused[puid]}")
            elif not np.array_equal(got, want1):
                raise AssertionError(f"g5 direct {puid}: {got} != {want1}")
            diffs.append(float(np.max(np.abs(got - want1))))
        log(f"graph g5 (micro-batcher) requests={GRAPH_FUSE} fused_calls="
            f"{stats['fused_calls']} batched_requests="
            f"{stats['batched_requests']} direct_calls="
            f"{stats['direct_calls']} fused_sizes={sizes} wall_ms="
            f"{1000.0 * wall:.2f}; answers equal their rows of the fused "
            f"predict; max |fused - solo| NLL={max(diffs):.3g} (reported)")
        out["g5"] = {"stats": stats, "wall_ms": 1000.0 * wall,
                     "fused_sizes": sizes,
                     "max_abs_fused_minus_solo": max(diffs),
                     "answers_equal_fused_rows": True}
        return out
    finally:
        if fast_client is not None:
            fast_client.close()
        for ch in channels:
            ch.close()
        if fast is not None:
            fast.shutdown()
            fast.server_close()
        if gsrv is not None:
            gsrv.stop(grace=1)
        if rest is not None:
            rest.close()


# ---------------------------------------------------------------------------
# Phase 9h: the client, the contract tester and the load generator, the
# orchestrator under load, and a bandit router
# ---------------------------------------------------------------------------

LOAD_CLIENTS = 8
LOAD_WARMUP_S = 5.0
LOAD_SECONDS = 10.0
LOAD_CANCEL_FRAC = 0.25
LOAD_DEADLINE_FRAC = 0.25
ORCH_CLIENTS = 8
ORCH_SECONDS = 3.0
ROUTER_PREDICTS = 30  # then as many counted; every one fed back
ROUTER_EPSILON = 0.2
ROUTER_SHARE_MIN = 0.7
CLIENT_PROMPTS = ("The port serves llama3-8b on one card. ",
                  "Seldon graphs route requests through units; ",
                  "A load generator drives closed-loop clients: ")


def cut_server(srv, reqs, dev):
    """Phase 4's server on its weights cut to their first CUT_LAYERS
    layers (shared, not copied), in the state phase 6 leaves phase 4's
    (loaded, its engine freed): phase 4's 8 requests go through it once
    first. Returns (server, streams, phase 4's report at this depth)."""
    import copy

    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    cut = copy.copy(srv)
    cut.params, cut.cfg = shallow(srv.params, srv.cfg, CUT_LAYERS)
    cut.engine, cut._loaded = None, False
    cut._load_lock = threading.Lock()
    cut.load()
    rpa.launches = 0
    results, wall = run_concurrent(cut.generate, reqs, timeout_s=600)
    if not cut.engine.drain(timeout=60):
        raise AssertionError("cut engine did not go idle after the requests")
    launches = rpa.launches
    snap = cut.engine.stats.snapshot()
    cut.stop()
    cut.engine = None
    gc.collect()
    torch.cuda.empty_cache()
    toks = [r["token_ids"] for r in results]
    want = cut.cfg.n_layers * (snap["decode_dispatches"]
                               + snap["prefill_waves"])
    if launches != want:
        raise AssertionError(f"cut: B1 launches {launches} != layers x legs "
                             f"{want}")
    n_tok = sum(len(t) for t in toks)
    log(f"cut: phase 4's server at {CUT_LAYERS} layers for the phases from "
        f"9b on: tokens={n_tok} wall_s={wall:.3f} tokens_per_s="
        f"{n_tok / wall:.1f} B1 launches {launches} (expected {want})")
    return cut, toks, {"layers": CUT_LAYERS, "launches": launches,
                       "tokens": n_tok, "wall_s": wall,
                       "tokens_per_s": n_tok / wall}


def phase4_twin(srv, dev):
    """A loaded server of phase 4's configuration (the ragged engine on
    the kernel leg) on phase 4's weights, shared, not copied. Its engine
    reads the environment as it is now."""
    from seldon_tpu_torch.servers.torchserver import TorchServer

    s = TorchServer(preset=srv.preset, max_slots=srv.max_slots,
                    max_seq_len=srv.max_seq_len,
                    prefill_chunk=srv.prefill_chunk, ragged=1,
                    ragged_kernel="pallas", init_seed=0, device=dev)
    s.params, s.cfg = srv.params, srv.cfg
    s.load()
    return s


def run_loadtester(argv):
    """The port's loadtester CLI, in this process: its JSON ledger."""
    import contextlib
    import io

    from seldon_tpu_torch import loadtester

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        loadtester.main(argv)
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def token_contract(path, width):
    """A contract of `width` token-id features (categorical over the
    byte range), written to `path`."""
    with open(path, "w") as f:
        json.dump({"features": [{"name": "tok", "dtype": "INT",
                                 "ftype": "categorical",
                                 "values": list(range(256)),
                                 "repeat": width}]}, f)
    return path


def phase_load(srv, reqs, dev):
    """The port's client (``seldon_tpu_torch/client.py``), contract tester
    (``runtime/tester.py``), load generator (``loadtester.py``) and graph
    components (``components/``) against a llama3-8b ``TorchServer`` on
    the card (phase 4's weights and engine configuration: ragged, kernel
    leg, B1) behind REST, gRPC and the fast lane.

    Gates: (1) three greedy text prompts through ``SeldonClient.generate``
    over REST and gRPC and ``generate_stream`` over gRPC (the client's
    streaming route) equal ``srv.generate``; ``microservice(predict)``
    over REST, ``rest-proto`` and gRPC equals ``srv.predict`` on [2, 512]
    token ids; (2) ``run_contract_test`` over REST and gRPC with a
    token-id contract; (3) the loadtester, ``--transport generate``, 8
    clients, 10 s, 32 new tokens, ``--cancel-frac 0.25``,
    ``--deadline-ms`` half the p50 latency of a 5 s warm-up pass with
    ``--deadline-frac 0.25`` (``--decode-len-dist uniform:32,32`` makes
    each request's body, and so each deadline draw, its own: ROADMAP.md
    C16): the outcomes add up with no error, at least one cancel and one
    deadline fired, the engine's ``deadline_expired_total`` moved by the
    loadtester's deadlines plus the cancels whose deadline passed before
    the hang-up was noticed, its ``cancelled_total`` by the rest of the
    cancels less those whose stream ended first (both printed), the
    engine audits clean with every pool block free once idle, B1
    launched; (4) the orchestrator under load (reported): ``--transport
    rest`` and ``grpc``, 8 clients, 5 s each, the B 1 x S 512 predict
    payload, against an ``EngineServer`` serving phase 9c's solo-MODEL
    graph g1 and directly against the unit, in turns, no errors; (5) an
    ``EpsilonGreedy`` ROUTER unit over two children that are the unit,
    every predict fed back with reward 1 for branch 1, 0 for branch 0:
    after 30 predicts, at least 0.7 of the next 30 route to branch 1, and
    every answer equals ``srv.predict``."""
    import numpy as np

    from seldon_tpu_torch.client import SeldonClient
    from seldon_tpu_torch.components import EpsilonGreedy
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.orchestrator.server import EngineServer
    from seldon_tpu_torch.orchestrator.spec import (PredictorSpec,
                                                    default_unit_types)
    from seldon_tpu_torch.runtime import fastpath, tester, wrapper
    from seldon_tpu_torch.runtime.metrics_server import ServerMetrics
    from seldon_tpu_torch.servers.torchserver import TorchServer

    libs = host_libraries()
    missing = [n for n in ("aiohttp", "grpc", "google.protobuf") if not
               libs[n]]
    if missing:
        raise AssertionError(f"load: transport libraries missing: {missing}")
    out = {"card": card_line()}
    lsrv = phase4_twin(srv, dev)
    eng, cfg = lsrv.engine, lsrv.cfg
    rest = gsrv = fast = rsrv = None
    clients, engines = [], []
    try:
        rest = RestThread(wrapper.build_rest_app(lsrv))
        gsrv = wrapper.build_grpc_server(lsrv)
        gport = gsrv.add_insecure_port("127.0.0.1:0")
        gsrv.start()
        fast, fport = fastpath.start_fast_server(lsrv, "127.0.0.1", 0)
        url = f"http://127.0.0.1:{rest.port}"

        # (1) the client, one request at a time.
        by = {t: SeldonClient(host="127.0.0.1", port=rest.port,
                              grpc_port=gport, transport=t, timeout_s=600)
              for t in ("rest", "rest-proto", "grpc")}
        clients += by.values()
        rpa.launches = 0
        for i, prompt in enumerate(CLIENT_PROMPTS):
            kw = dict(max_new_tokens=MAX_NEW, temperature=0.0, seed=i)
            want = lsrv.generate(dict(kw, prompt=prompt))["token_ids"]
            got = {"rest": by["rest"].generate(prompt=prompt, **kw)[
                       "token_ids"],
                   "grpc": by["grpc"].generate(prompt=prompt, **kw)[
                       "token_ids"],
                   "grpc_stream": [t for c in by["grpc"].generate_stream(
                       prompt=prompt, **kw) for t in c["token_ids"]]}
            differ = {k: v for k, v in got.items() if v != want}
            if not want or differ:
                raise AssertionError(f"client generate {i}: {differ} != "
                                     f"in-process {want}")
        X = np.random.default_rng(11).integers(0, cfg.vocab_size,
                                               (2, GRAPH_S))
        want = lsrv.predict(X, names=[])
        for t, c in by.items():
            r = c.microservice(data=X, method="predict")
            if not r.success or not np.array_equal(
                    np.asarray(r.data, np.float64), want.astype(np.float64)):
                raise AssertionError(f"client predict over {t}: "
                                     f"{r.error or r.data} != {want}")
        client_launches = rpa.launches
        if client_launches == 0:
            raise AssertionError("the client's generate launched no B1")
        log(f"load client: {len(CLIENT_PROMPTS)} prompts equal over REST "
            f"generate, gRPC generate and generate_stream; predict [2, "
            f"{GRAPH_S}] equal over rest, rest-proto, grpc; B1 launches "
            f"{client_launches}")

        # (2) the contract tester.
        os.makedirs(OUT_DIR, exist_ok=True)
        contract = token_contract(os.path.join(OUT_DIR, "contract.json"),
                                  64)
        for t, port in (("rest", rest.port), ("grpc", gport)):
            res = tester.run_contract_test(contract, host="127.0.0.1",
                                           port=port, transport=t,
                                           n_requests=3, batch_size=2)
            if not res["ok"]:
                raise AssertionError(f"contract test over {t}: "
                                     f"{res['failures']}")
        log("load contract tester: 3 requests of [2, 64] token ids over "
            "REST and gRPC, ok")

        # (3) the load generator.
        gen = [url, "--transport", "generate", "--clients",
               str(LOAD_CLIENTS), "--max-new-tokens", str(MAX_NEW)]
        warm = run_loadtester(gen + ["--seconds", str(LOAD_WARMUP_S)])
        wait_idle(eng)
        deadline_ms = max(1, int(warm["detail"]["p50_ms"] / 2))
        before = eng.stats.snapshot()
        rpa.launches = 0
        main_run = run_loadtester(gen + [
            "--seconds", str(LOAD_SECONDS),
            "--cancel-frac", str(LOAD_CANCEL_FRAC),
            "--deadline-ms", str(deadline_ms),
            "--deadline-frac", str(LOAD_DEADLINE_FRAC),
            "--decode-len-dist", f"uniform:{MAX_NEW},{MAX_NEW}"])
        wait_idle(eng)
        launches = rpa.launches
        after = eng.stats.snapshot()
        d = main_run["detail"]
        oc = d["outcomes"]
        moved = {k: after[k] - before[k] for k in (
            "cancelled_total", "deadline_expired_total")}
        problems = []
        if sum(oc.values()) != d["requests"] + d["errors"]:
            problems.append(f"outcomes {oc} do not add up to "
                            f"{d['requests']} + {d['errors']}")
        if oc["error"]:
            problems.append(f"{oc['error']} error outcomes")
        if not oc["cancelled"] or not oc["deadline"]:
            problems.append(f"inert: cancelled {oc['cancelled']}, deadline "
                            f"{oc['deadline']}")
        # Every deadline the client saw the engine counted; a cancel
        # reaches the engine unless its stream ended first, by finishing
        # or by its deadline passing before the hang-up was noticed.
        expired_first = moved["deadline_expired_total"] - oc["deadline"]
        ended_first = (oc["cancelled"] - moved["cancelled_total"]
                       - expired_first)
        if expired_first < 0 or ended_first < 0 or \
                not moved["cancelled_total"]:
            problems.append(f"engine counters moved {moved}, loadtester "
                            f"counted {oc}")
        if eng.debug_lifecycle_check():
            problems.append(f"leaks {eng.debug_lifecycle_check()}")
        if not launches:
            problems.append("B1 never launched")
        if problems:
            raise AssertionError("load: " + "; ".join(problems))
        log(f"load generate: {d['requests']} completed + {d['errors']} "
            f"other in {LOAD_SECONDS} s, {main_run['value']} req/s, "
            f"tokens/s {d['tokens_per_s']}, ttft p50/p95 "
            f"{d['ttft_p50_ms']}/{d['ttft_p95_ms']} ms, itl p50/p95 "
            f"{d['itl_p50_ms']}/{d['itl_p95_ms']} ms, outcomes {oc}; "
            f"deadline_ms {deadline_ms} (warm-up p50 "
            f"{warm['detail']['p50_ms']} ms, {warm['value']} req/s, "
            f"tokens/s {warm['detail']['tokens_per_s']}); engine "
            f"{moved} (cancels that expired first {expired_first}, that "
            f"ended first {ended_first}); B1 launches {launches}; audit "
            f"clean")
        out.update(client_launches=client_launches, warmup=warm,
                   generate=main_run, deadline_ms=deadline_ms,
                   engine_moved=moved, launches=launches)

        # (4) the orchestrator under load, in turns with the bare unit.
        solo = {"name": "llm", "type": "MODEL",
                "image": "torchserver:llama3-8b",
                "endpoint": {"service_host": "127.0.0.1",
                             "service_port": gport, "type": "GRPC",
                             "fast_port": fport}}
        spec = PredictorSpec.from_dict({"name": "g1", "graph": solo})
        default_unit_types(spec.graph)
        et = EngineThread(EngineServer(spec=spec, http_port=0, grpc_port=0,
                                       enable_batching=False,
                                       metrics=ServerMetrics()))
        engines.append(et)
        row = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                                (1, GRAPH_S))
        payload = json.dumps({"data": {"ndarray": row.tolist()}})
        common = ["--clients", str(ORCH_CLIENTS), "--seconds",
                  str(ORCH_SECONDS), "--payload", payload]
        runs = {
            "engine_rest": [f"http://127.0.0.1:{et.http}", "--transport",
                            "rest"],
            "unit_rest": [url, "--transport", "rest", "--path",
                          "/predict"],
            "engine_grpc": [url, "--transport", "grpc", "--grpc-host",
                            f"127.0.0.1:{et.grpc}"],
            "unit_grpc": [url, "--transport", "grpc", "--grpc-host",
                          f"127.0.0.1:{gport}"],
        }
        orch = {}
        for name, argv in runs.items():
            res = run_loadtester(argv + common)
            det = res["detail"]
            if det["errors"] or not det["requests"]:
                raise AssertionError(f"orchestrator under load {name}: "
                                     f"{det}")
            orch[name] = {"req_per_s": res["value"], **{
                k: det[k] for k in ("requests", "p50_ms", "p90_ms",
                                    "p99_ms")}}
            log(f"load orchestrator {name}: {res['value']} req/s over "
                f"{ORCH_CLIENTS} clients, p50/p90/p99 {det['p50_ms']}/"
                f"{det['p90_ms']}/{det['p99_ms']} ms ({det['requests']} "
                f"requests)")
        for t in ("rest", "grpc"):
            orch[f"hop_p50_ms_{t}"] = (orch[f"engine_{t}"]["p50_ms"]
                                       - orch[f"unit_{t}"]["p50_ms"])
        log(f"load orchestrator hop under load (p50, engine minus unit): "
            f"rest {orch['hop_p50_ms_rest']:.2f} ms, grpc "
            f"{orch['hop_p50_ms_grpc']:.2f} ms (reported only)")
        out["orchestrator"] = orch

        # (5) a bandit router over two children that are the unit.
        router = EpsilonGreedy(n_branches=2, epsilon=ROUTER_EPSILON, seed=0)
        rsrv = wrapper.build_grpc_server(router)
        rport = rsrv.add_insecure_port("127.0.0.1:0")
        rsrv.start()
        child = {"type": "MODEL",
                 "endpoint": {"service_host": "127.0.0.1",
                              "service_port": gport, "type": "GRPC"}}
        spec = PredictorSpec.from_dict({"name": "bandit", "graph": {
            "name": "router", "type": "ROUTER",
            "endpoint": {"service_host": "127.0.0.1", "service_port": rport,
                         "type": "GRPC"},
            "children": [dict(child, name="c0"), dict(child, name="c1")]}})
        default_unit_types(spec.graph)
        rt = EngineThread(EngineServer(spec=spec, http_port=0, grpc_port=0,
                                       enable_batching=False,
                                       metrics=ServerMetrics()))
        engines.append(rt)
        rc = SeldonClient(host="127.0.0.1", port=rt.http, transport="rest",
                          timeout_s=600)
        clients.append(rc)
        want1 = lsrv.predict(row, names=[])
        branches = []
        for i in range(2 * ROUTER_PREDICTS):
            r = rc.predict(data=row)
            if not r.success or not np.array_equal(
                    np.asarray(r.data, np.float64),
                    want1.astype(np.float64)):
                raise AssertionError(f"router predict {i}: "
                                     f"{r.error or r.data} != {want1}")
            b = int(r.msg.meta.routing["router"])
            branches.append(b)
            fb = rc.feedback(response_msg=r.msg,
                             reward=1.0 if b == 1 else 0.0)
            if not fb.success:
                raise AssertionError(f"router feedback {i}: {fb.error}")
        share = sum(branches[ROUTER_PREDICTS:]) / ROUTER_PREDICTS
        if share < ROUTER_SHARE_MIN:
            raise AssertionError(f"router: branch 1 share {share} < "
                                 f"{ROUTER_SHARE_MIN} after "
                                 f"{ROUTER_PREDICTS} predicts ({branches})")
        log(f"load router: epsilon-greedy (epsilon {ROUTER_EPSILON}, seed "
            f"0), every predict fed back: branch-1 share {share:.3f} over "
            f"predicts {ROUTER_PREDICTS + 1}-{2 * ROUTER_PREDICTS} (first "
            f"{ROUTER_PREDICTS}: "
            f"{sum(branches[:ROUTER_PREDICTS]) / ROUTER_PREDICTS:.3f}); "
            f"router means {router.metrics()}; answers equal srv.predict")
        out["router"] = {"branches": branches, "share": share,
                         "means": router.metrics()}
        return out
    finally:
        for c in clients:
            c.close()
        for e in engines:
            e.close()
        if rsrv is not None:
            rsrv.stop(grace=1)
        if fast is not None:
            fast.shutdown()
            fast.server_close()
        if gsrv is not None:
            gsrv.stop(grace=1)
        if rest is not None:
            rest.close()
        lsrv.stop()


# ---------------------------------------------------------------------------
# Phase 9i: supervised recovery under a seeded fault storm
# ---------------------------------------------------------------------------

# The storm of the JAX package's heal audit (tools/heal_audit.py).
HEAL_STORM = dict(seed=17, dispatch_fail=0.05, slow_boundary=0.05,
                  slow_ms=2, hang=0.02, hang_ms=1500, nan_inject=0.02)
HEAL_MAX_RETRIES = 6
HEAL_TINY_WATCHDOG_MS = 1000
HEAL_TOPUP_ROUNDS = 4
HEAL_TINY_LENS = (12, 26, 7, 30, 16, 3, 20, 9)
HEAL_LT_CLIENTS, HEAL_LT_SECONDS = 4, 10.0
HEAL_TAP_CHECKS = 6  # B1 launches held to the plain version on replays
# No request of the storm may take longer (a request parked in the pen
# with nothing to release it shows here first: ROADMAP.md C17).
HEAL_LIVENESS_S = 60.0
# The frozen /debug/health key set (tools/heal_audit.py keeps the same).
HEALTH_TOP_KEYS = frozenset({
    "enabled", "state", "mode", "max_retries", "watchdog_ms",
    "resurrected", "quarantined", "watchdog_trips", "retry_exhausted",
    "sentinel_trips", "recoveries", "consecutive_faults",
    "clean_boundaries", "pen", "suspects", "probing", "pressure",
})


def decision_gap(row, req):
    """The top-2 gap of the sampler's decision on a logits row: the raw
    logits for a greedy request, the masked temperature-scaled logits
    plus the request's Gumbel noise at that position for a sampled one."""
    import torch

    from seldon_tpu_torch.models import sampling

    if req["temperature"] <= 0:
        return top2_gap(row)
    pos = req["position"]
    scaled = sampling._mask_top_k_top_p(
        row[None] / req["temperature"],
        torch.tensor([req.get("top_k", 0)]),
        torch.tensor([req.get("top_p", 1.0)]))[0]
    noise = sampling.gumbel_noise(torch.tensor([req["seed"]]),
                                  torch.tensor([pos]), row.shape[-1])[0]
    return top2_gap(scaled + noise.to(scaled.device))


def stream_verdict(req, got, want, rows):
    """None when `got` equals `want`, else the first differing token with
    the clean run's decision gap there."""
    if got == want:
        return None
    k = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
             min(len(got), len(want)))
    pos = len(req["prompt_token_ids"]) + k
    row = rows.get((req["seed"], pos))
    gap = (decision_gap(row, dict(req, position=pos))
           if row is not None else None)
    return {"token": k, "gap": gap}


def submit_all(eng, reqs, to_sampling):
    """Every request submitted while the scheduler is held off (so the
    first wave sees them all), then drained: [(tokens, error item)]."""
    with eng._book:
        qs = [eng.submit(r["prompt_token_ids"], to_sampling(r))
              for r in reqs]
    out = []
    for q in qs:
        toks, err = [], None
        while True:
            item = q.get(timeout=300)
            if item is None:
                break
            if "error" in item:
                err = item
            else:
                toks.extend(item["tokens"])
        out.append((toks, err))
    return out


class HealTap(KernelTap):
    """KernelTap on the launches of replay waves only: a launch is checked
    once the engine's supervisor has recovered at least once, up to
    HEAL_TAP_CHECKS launches."""

    def __init__(self, n_layers, heal):
        super().__init__(n_layers, leg="replay")
        self.heal = heal

    def live(self):
        return (self.heal.recoveries > 0
                and self.checked["replay"] < HEAL_TAP_CHECKS)


class FirstFold:
    """Instrumentation of this script: the tokens each request (by seed)
    had delivered when it was first resurrected."""

    def __init__(self, seeds):
        self.seeds = set(seeds)
        self.first = {}

    def __enter__(self):
        from seldon_tpu_torch.servers.engine import InferenceEngine

        self._cls, self._orig = InferenceEngine, \
            InferenceEngine._prepare_resurrect
        orig, first, seeds = self._orig, self.first, self.seeds

        def recorded(eng, req):
            seed = req.params.seed
            if seed in seeds and seed not in first:
                first[seed] = list(req.gen_hist)
            return orig(eng, req)

        InferenceEngine._prepare_resurrect = recorded
        return self

    def __exit__(self, *exc):
        self._cls._prepare_resurrect = self._orig


class FetchClock:
    """Instrumentation of this script: the longest wait of a boundary's
    host copies (the boundary fetch the watchdog bounds)."""

    def __enter__(self):
        from seldon_tpu_torch.servers import engine

        self._mod, self._orig = engine._HostCopy, engine._HostCopy.wait
        orig = self._orig
        self.longest_s = 0.0

        def timed(host):
            t0 = time.perf_counter()
            out = orig(host)
            self.longest_s = max(self.longest_s, time.perf_counter() - t0)
            return out

        self._mod.wait = timed
        return self

    def __exit__(self, *exc):
        self._mod.wait = self._orig


def supervisor_verdict(err):
    """"poison" or "exhausted" for an error item the heal supervisor's
    verdict produced (a quarantine, a spent retry budget), else None."""
    if err["kind"] == "poison":
        return "poison"
    if (err["kind"] == "internal" and not err["retriable"]
            and err["error"].startswith("resurrection budget exhausted")):
        return "exhausted"
    return None


def heal_verdicts(name, reqs, results, clean, rows):
    """Hold healed streams to clean ones: every stream equals its clean
    stream or parts at a near-tie of the clean run's decision. An error
    item may only be a supervisor verdict — with no poison source armed, a
    quarantine or a spent retry budget is the storm's doing (ROADMAP.md
    C15) — and what that request delivered follows the same rule.
    Returns (near ties, {"poison": n, "exhausted": n})."""
    from seldon_tpu_torch.ops.ragged_paged_attention import (
        RAGGED_LOGITS_ATOL)

    ties, verdicts = [], {"poison": 0, "exhausted": 0}
    for i, (req, (got, err), want) in enumerate(zip(reqs, results, clean)):
        if err is not None:
            v = supervisor_verdict(err)
            if v is None:
                raise AssertionError(f"{name} request {i}: {err}")
            verdicts[v] += 1
            want = want[:len(got)]
        v = stream_verdict(req, got, want, rows)
        if v is None:
            continue
        if v["gap"] is None or v["gap"] >= RAGGED_LOGITS_ATOL:
            raise AssertionError(f"{name} request {i} parts from the clean "
                                 f"stream at token {v['token']} (clean "
                                 f"decision gap {v['gap']})")
        ties.append(dict(v, request=i))
    for t in ties:
        log(f"{name}: near-tie reported: request {t['request']} token "
            f"{t['token']} clean decision gap {t['gap']:.3g}")
    return ties, verdicts


class RecoveryCaptures:
    """Instrumentation of this script: at every device-state rebuild (a
    recovery), the programs the rebuild dropped, each of which would be
    captured anew: a rebuild that resets the state in place keeps every
    program object and the state binding they hold."""

    def __init__(self, eng):
        self.eng, self.rebuilds, self.dropped = eng, 0, 0

    def __enter__(self):
        orig = self.eng._rebuild_device_state

        def counted():
            progs = self.eng._programs
            held = {k: progs.get(k) for k in progs.keys()}
            home = progs.home
            orig()
            self.rebuilds += 1
            if progs.home is not home:
                self.dropped += len(held)
            else:
                self.dropped += sum(progs.get(k) is not p
                                    for k, p in held.items())

        self.eng._rebuild_device_state = counted
        return self

    def __exit__(self, *exc):
        del self.eng._rebuild_device_state


def capture_report(name, eng, recoveries, rc):
    """The engine's captured programs over a storm: programs held,
    captures made (each program's first, and those a tap's re-capture
    made), and the captures the recoveries caused, per recovery: the
    programs each rebuild dropped (``rc``: the storm's RecoveryCaptures;
    0 when every recovery resets the state in place)."""
    progs = eng._programs
    held, made = len(progs), progs.captures
    out = {"programs": held, "captures": made, "recoveries": recoveries,
           "rebuilds": rc.rebuilds, "programs_dropped": rc.dropped,
           "captures_per_recovery": rc.dropped / max(rc.rebuilds, 1),
           "capture_ms": list(progs.capture_ms)}
    log(f"{name}: {held} captured programs, {made} captures in all; "
        f"{rc.rebuilds} rebuilds over {recoveries} recoveries dropped "
        f"{rc.dropped} programs ({out['captures_per_recovery']:.2f} "
        f"captures per recovery)")
    return out


def heal_tiny(dev):
    """(i) ``tiny`` on the card: the ragged engine on the kernel leg (B1
    at Dh 16), clean against healed under the storm, the same requests
    (4 greedy, 4 sampled) topped up until a dispatch fault landed."""
    import dataclasses

    import numpy as np
    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.models.sampling import SamplingParams
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.chaos import ChaosConfig
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    ecfg = EngineConfig(max_slots=4, max_seq_len=96,
                        prompt_buckets=(16, 32, 64), paged_kv=True,
                        kv_block=8, prefix_block=8, chunked_prefill=True,
                        prefill_chunk=8, ragged=True, ragged_kernel="pallas")
    storm = dataclasses.replace(
        ecfg, heal=True, heal_max_retries=HEAL_MAX_RETRIES,
        heal_watchdog_ms=HEAL_TINY_WATCHDOG_MS,
        chaos=ChaosConfig(**HEAL_STORM))
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist()
               for n in HEAL_TINY_LENS]

    def wave(rnd):
        return [{"prompt_token_ids": p, "seed": 100 * rnd + i,
                 "max_new_tokens": 24,
                 "temperature": 0.0 if i % 2 == 0 else 0.8, "top_k": 20}
                for i, p in enumerate(prompts)]

    def sampling(r):
        return SamplingParams(temperature=r["temperature"], top_k=r["top_k"],
                              max_new_tokens=r["max_new_tokens"],
                              seed=r["seed"])

    eng = InferenceEngine(params, cfg, storm, dev)
    rcap = RecoveryCaptures(eng).__enter__()
    eng.start()
    reqs, results = [], []
    rpa.launches = 0
    try:
        for rnd in range(1 + HEAL_TOPUP_ROUNDS):
            reqs += wave(rnd)
            results += submit_all(eng, wave(rnd), sampling)
            if eng.chaos_counts()["dispatch_faults"]:
                break
        wait_idle(eng)
        launches = rpa.launches
        health, chaos = eng.debug_health(), eng.chaos_counts()
        leaks = eng.debug_lifecycle_check()
        programs = capture_report("heal tiny", eng, health["recoveries"],
                                  rcap)
    finally:
        eng.stop()
    if not chaos["dispatch_faults"]:
        raise AssertionError(f"heal tiny: the storm is inert ({chaos})")
    ref = InferenceEngine(params, cfg, ecfg, dev)
    ref.start()
    try:
        with LogitTap([r["seed"] for r in reqs]) as tap:
            clean = [t for t, e in submit_all(ref, reqs, sampling)]
    finally:
        ref.stop()
    ties, verdicts = heal_verdicts("heal tiny", reqs, results, clean,
                                   tap.rows)
    problems = []
    if (health["quarantined"], health["retry_exhausted"]) != (
            verdicts["poison"], verdicts["exhausted"]):
        problems.append(f"health {health} does not account for the "
                        f"verdicts {verdicts}")
    if not health["recoveries"] or not health["resurrected"]:
        problems.append(f"nothing recovered: {health}")
    if leaks:
        problems.append(f"leaks {leaks}")
    if not launches:
        problems.append("B1 never launched")
    if problems:
        raise AssertionError("heal tiny: " + "; ".join(problems))
    equal = sum(got == want for (got, _), want in zip(results, clean))
    log(f"heal tiny (ragged, kernel leg, Dh {cfg.head_dim}): {len(reqs)} "
        f"requests in {len(reqs) // len(prompts)} rounds, {equal} streams "
        f"equal to the clean run, {len(ties)} near-ties, supervisor "
        f"verdicts {verdicts} (C15); chaos {chaos}; health recoveries "
        f"{health['recoveries']} resurrected {health['resurrected']} "
        f"watchdog_trips {health['watchdog_trips']} sentinel_trips "
        f"{health['sentinel_trips']}; B1 launches {launches}")
    return {"requests": len(reqs), "equal": equal, "near_ties": ties,
            "verdicts_c15": verdicts, "chaos": chaos, "health": health,
            "launches": launches, "programs": programs}


def heal_full(srv, reqs, dev):
    """(ii) llama3-8b at full width (phase 4's weights, shared): a
    ``TorchServer`` armed by its environment (``HEAL``, ``CHAOS`` and the
    storm's ``CHAOS_*``, ``FLIGHT_RECORDER``, and ``GRAFTSAN``: zero
    lock-contract violations under recovery) behind REST; phase 4's 8
    requests and the loadtester (4 clients, 10 s) at once."""
    import numpy as np

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.runtime import wrapper
    from seldon_tpu_torch.servers.torchserver import TorchServer

    out = {}
    csrv = phase4_twin(srv, dev)
    try:
        with FetchClock() as clock:
            clean = [t for t, e in submit_all(csrv.engine, reqs,
                                              csrv._to_sampling)]
        with LogitTap([r["seed"] for r in reqs]) as tap:
            tapped = [t for t, e in submit_all(csrv.engine, reqs,
                                               csrv._to_sampling)]
    finally:
        csrv.stop()
        del csrv
    if tapped != clean:
        log("heal full: the tapped clean run's streams differ from the "
            "untapped one's (reported only)")
    watchdog_ms = max(2000, int(4000 * clock.longest_s) + 1)
    env = {"HEAL": "1", "HEAL_MAX_RETRIES": str(HEAL_MAX_RETRIES),
           "HEAL_WATCHDOG_MS": str(watchdog_ms), "FLIGHT_RECORDER": "1",
           "CHAOS": "1", "CHAOS_SEED": str(HEAL_STORM["seed"]),
           "CHAOS_DISPATCH_FAIL": str(HEAL_STORM["dispatch_fail"]),
           "CHAOS_SLOW_BOUNDARY": str(HEAL_STORM["slow_boundary"]),
           "CHAOS_SLOW_MS": str(HEAL_STORM["slow_ms"]),
           "CHAOS_HANG": str(HEAL_STORM["hang"]),
           "CHAOS_HANG_MS": str(watchdog_ms + 1500),
           "CHAOS_NAN_INJECT": str(HEAL_STORM["nan_inject"]),
           "GRAFTSAN": "1", "GRAFTSAN_SEED": str(SAN_SEED)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        ssrv = phase4_twin(srv, dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    eng = ssrv.engine
    rest = None
    try:
        if eng._heal is None or eng._chaos is None or eng._san is None:
            raise AssertionError("heal full: HEAL=1 / CHAOS=1 / GRAFTSAN=1 "
                                 "armed nothing")
        rest = RestThread(wrapper.build_rest_app(ssrv))
        url = f"http://127.0.0.1:{rest.port}"
        idle = json.loads(http_get(rest.port, "/debug/health")[1])
        if set(idle) != HEALTH_TOP_KEYS or idle["state"] != "healthy":
            raise AssertionError(f"heal full: idle /debug/health {idle}")
        not_ready, stop = [], threading.Event()

        def probe():
            while not stop.is_set():
                status = http_get(rest.port, "/healthz")[0]
                if status != 200:
                    not_ready.append(status)
                time.sleep(0.2)

        ledger = {}

        def load():
            ledger.update(run_loadtester([
                url, "--transport", "generate", "--clients",
                str(HEAL_LT_CLIENTS), "--seconds", str(HEAL_LT_SECONDS),
                "--max-new-tokens", str(MAX_NEW)]))

        threads = [threading.Thread(target=probe),
                   threading.Thread(target=load)]
        rpa.launches = 0
        for t in threads:
            t.start()
        try:
            with FirstFold([r["seed"] for r in reqs]) as folds, \
                    HealTap(srv.cfg.n_layers, eng._heal) as ktap, \
                    LogitTap([r["seed"] for r in reqs]) as stap, \
                    RecoveryCaptures(eng) as rcap:
                results = submit_all(eng, reqs, ssrv._to_sampling)
                # Replays of the loadtester's requests count too.
                threads[1].join(600)
        finally:
            stop.set()
            for t in threads:
                t.join(600)
        wait_idle(eng, timeout_s=120)
        launches = rpa.launches
        health, chaos = eng.debug_health(), eng.chaos_counts()
        problems = []
        errs = [(i, e) for i, (_, e) in enumerate(results) if e]
        ours = [i for i, e in errs if supervisor_verdict(e)]
        if len(ours) != len(errs):
            problems.append(f"error items {errs}")
        lt = ledger.get("detail", {})
        if not lt.get("requests"):
            problems.append(f"the loadtester completed nothing: {ledger}")
        if lt.get("p99_ms", 0.0) > 1000.0 * HEAL_LIVENESS_S or \
                lt.get("errors", 0) != lt.get("outcomes", {}).get("error"):
            problems.append(f"loadtester requests stalled or failed outside "
                            f"the engine: {lt}")
        # A loadtester stream the supervisor failed (a quarantine or a
        # spent budget: C15) ends in an error trailer, which the
        # loadtester counts as an error outcome.
        judged = health["quarantined"] + health["retry_exhausted"]
        if lt.get("outcomes", {}).get("error", 0) != judged - len(ours):
            problems.append(f"loadtester errors {lt.get('outcomes')} are "
                            f"not the supervisor's other verdicts ({judged}"
                            f" - {len(ours)})")
        for i, ((got, err), want, r) in enumerate(zip(results, clean,
                                                      reqs)):
            if err is None and len(got) != len(want):
                problems.append(f"request {i} delivered {len(got)} tokens, "
                                f"the clean run {len(want)}")
            pre = folds.first.get(r["seed"])
            if pre is not None and pre != want[:len(pre)]:
                problems.append(f"request {i}: tokens before its first "
                                f"fault {pre} != clean {want[:len(pre)]}")
        if not health["recoveries"] or not health["resurrected"]:
            problems.append(f"nothing recovered: {health}, chaos {chaos}")
        if chaos["hangs"] and not health["watchdog_trips"]:
            problems.append("hangs fired but the watchdog never tripped")
        if chaos["nan_injects"] and not health["sentinel_trips"]:
            problems.append("poison fired but the sentinel never tripped")
        if not_ready:
            problems.append(f"/healthz answered {not_ready}")
        if ktap.checked["replay"] == 0:
            problems.append("no replay wave's B1 launch was checked")
        elif max(ktap.errs["replay"][0], ktap.errs["replay"][2]) > max(
                TOL_M, TOL_ACC) or ktap.errs["replay"][1] > TOL_L:
            problems.append(f"B1 on replay waves off its plain version by "
                            f"{ktap.errs['replay']}")
        if not launches:
            problems.append("B1 never launched")
        if problems:
            raise AssertionError("heal full: " + "; ".join(problems))
        # Report: whole streams against the clean ones (C1 at this width).
        storm_cmp = compare_legs(
            reqs, "heal full storm vs clean",
            ([t for t, _ in results], stap.rows), (clean, tap.rows))
        # A clean streak walks the supervisor back to healthy.
        eng._chaos = None
        for r in reqs[:WIRE_PROMPTS]:
            ssrv.generate(r)
        wait_idle(eng)
        final = json.loads(http_get(rest.port, "/debug/health")[1])
        timeline = json.loads(http_get(rest.port, "/debug/timeline")[1])
        metrics = {m["key"] for m in ssrv.metrics()}
        heal_recs = [rec for rec in timeline["records"]
                     if rec["kind"] == "heal"]
        gauges = [f"torchserver_heal_{k}" for k in (
            "resurrected", "quarantined", "watchdog_trips",
            "retry_exhausted", "pressure")]
        problems = []
        if set(final) != HEALTH_TOP_KEYS or final["state"] != "healthy":
            problems.append(f"final /debug/health {final}")
        if not heal_recs or any({"state", "error"} - set(rec["detail"])
                                for rec in heal_recs):
            problems.append(f"heal records {heal_recs[:2]}")
        missing = [g for g in gauges if g not in metrics]
        if missing:
            problems.append(f"metrics() lacks {missing}")
        if eng.debug_lifecycle_check():
            problems.append(f"leaks {eng.debug_lifecycle_check()}")
        # The JAX heal audit's last check: the lock contract held under
        # recovery.
        if eng._san.violations:
            problems.append("sanitizer violations: " + "; ".join(
                v.render() for v in eng._san.violations[:3]))
        if problems:
            raise AssertionError("heal full: " + "; ".join(problems))
        log(f"heal full (llama3-8b, ragged, kernel leg): watchdog_ms "
            f"{watchdog_ms} (longest clean fetch "
            f"{1000 * clock.longest_s:.1f} ms), hang_ms "
            f"{watchdog_ms + 1500}; chaos {chaos}; health recoveries "
            f"{health['recoveries']} resurrected {health['resurrected']} "
            f"watchdog_trips {health['watchdog_trips']} sentinel_trips "
            f"{health['sentinel_trips']} quarantined {health['quarantined']}"
            f" retry_exhausted {health['retry_exhausted']} (C15; of the 8 "
            f"requests {len(ours)}); {len(results)} requests with "
            f"{len(folds.first)} resurrected, tokens before each first "
            f"fault equal the clean run's; loadtester {lt['requests']} "
            f"completed, outcomes {lt['outcomes']}, {ledger['value']} "
            f"req/s; /healthz ready throughout; B1 launches {launches}, "
            f"replay-wave launches checked {ktap.checked['replay']} (max "
            f"err m/l/acc {ktap.errs['replay']}); {len(heal_recs)} heal "
            f"records; back to healthy after a clean streak; sanitizer "
            f"armed: {eng._san.audits} audits, 0 violations")
        out.update(watchdog_ms=watchdog_ms,
                   longest_clean_fetch_ms=1000 * clock.longest_s,
                   chaos=chaos, health=health, final_health=final,
                   supervisor_failed=ours,
                   resurrected_requests=len(folds.first),
                   loadtester=ledger, launches=launches,
                   b1_replay_errors=ktap.errs["replay"],
                   b1_replay_checks=ktap.checked["replay"],
                   heal_records=len(heal_recs), storm_vs_clean=storm_cmp,
                   sanitizer_audits=eng._san.audits,
                   sanitizer_violations=len(eng._san.violations),
                   programs=capture_report("heal full", eng,
                                           health["recoveries"], rcap))
        return out
    finally:
        if rest is not None:
            rest.close()
        ssrv.stop()


def phase_heal(srv, reqs, dev):
    """Supervised recovery on the card, in two parts: (i) ``tiny`` on the
    ragged kernel leg, every healed stream held to the clean engine's
    token for token except at reported near-ties; (ii) llama3-8b at full
    width through a ``TorchServer`` armed by ``HEAL=1 CHAOS=1``, with the
    loadtester concurrent: no error item that is not a quarantine, every
    unquarantined stream as long as the clean run's, each stream's tokens
    before its first fault equal to the clean run's, recoveries and
    resurrections (watchdog and sentinel trips where those faults fired),
    the frozen ``/debug/health`` keys and a return to "healthy",
    ``/healthz`` ready throughout, the ``torchserver_heal_*`` gauges,
    "heal" records in ``/debug/timeline``, B1 held to its plain version
    on replay waves, a clean audit. On this engine (one dispatch per
    token) the storm wrecks enough waves that the bisection may convict an
    innocent whose probe round a random fault hit, and a request wrecked
    more than ``heal_max_retries`` times fails non-retriably; the JAX
    supervisor does the same (ROADMAP.md C15). Such a verdict is the only
    error allowed: each is printed, and the supervisor's ``quarantined`` /
    ``retry_exhausted`` counters must account for every one, the
    loadtester's error outcomes included. Whole full-width storm streams
    against the clean ones are reported (C1)."""
    return {"tiny": heal_tiny(dev), "full": heal_full(srv, reqs, dev),
            "card": card_line()}


# ---------------------------------------------------------------------------
# Phases 9j-9k: the runtime sanitizer, and the prepackaged servers
# ---------------------------------------------------------------------------

SAN_SEED = 7  # GRAFTSAN_SEED of phase 9j


class SleepCount:
    """Instrumentation of this script: while active, counts the sleeps
    the runtime sanitizer's ``perturb`` takes (the ``time.sleep`` of its
    module) and their seconds."""

    def __enter__(self):
        import types

        from seldon_tpu_torch.servers import graftsan

        self._mod, self._orig = graftsan, graftsan.time
        self._lock = threading.Lock()
        self.count, self.seconds = 0, 0.0

        def sleep(s):
            with self._lock:
                self.count += 1
                self.seconds += s
            self._orig.sleep(s)

        graftsan.time = types.SimpleNamespace(sleep=sleep)
        return self

    def __exit__(self, *exc):
        self._mod.time = self._orig


def phase_sanitize(srv, reqs, toks, dev):
    """9j: the runtime sanitizer (``GRAFTSAN=1``, ``GRAFTSAN_SEED``) armed on
    an engine of phase 4's configuration (the ragged wave on B1's kernel
    leg) with phase 4's weights (9a's cut), phase 4's 8 requests queued
    at once, against the same engine unarmed on the same schedule. Gates:
    every stream (6 greedy, 2 sampled with per-request keys) equal to the
    unarmed run's; zero violations; a boundary audit for every wave; at
    least one ``perturb`` sleep taken; B1 launches = layers x wave legs;
    a clean leak audit. Reported: the streams equal to phase 4's own (its
    8 requests came from 8 threads, so its waves may have been packed
    otherwise: ROADMAP.md C1), the sleeps, tokens/s armed and unarmed (no
    claim)."""
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = srv.cfg

    def burst(s):
        eng = s.engine
        before = eng.stats.snapshot()
        rpa.launches = 0
        t0 = time.perf_counter()
        results = submit_all(eng, reqs, s._to_sampling)
        wall = time.perf_counter() - t0
        wait_idle(eng)
        launches = rpa.launches
        after = eng.stats.snapshot()
        errs = [e for _, e in results if e]
        if errs:
            raise AssertionError(f"sanitize: error items {errs}")
        streams = [t for t, _ in results]
        return streams, wall, launches, {k: after[k] - before[k] for k in (
            "decode_dispatches", "prefill_waves")}

    off = phase4_twin(srv, dev)
    try:
        clean, clean_wall, _, _ = burst(off)
    finally:
        off.stop()
        del off
    env = {"GRAFTSAN": "1", "GRAFTSAN_SEED": str(SAN_SEED)}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        armed = phase4_twin(srv, dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    eng = armed.engine
    try:
        san = eng._san
        if san is None:
            raise AssertionError("sanitize: GRAFTSAN=1 armed nothing")
        audits0 = san.audits
        with SleepCount() as sleeps:
            streams, wall, launches, st = burst(armed)
        audits = san.audits - audits0
        leaks = eng.debug_lifecycle_check()
    finally:
        armed.stop()
    waves = st["decode_dispatches"]
    want = cfg.n_layers * (waves + st["prefill_waves"])
    problems = []
    differ = [i for i, (a, b) in enumerate(zip(streams, clean)) if a != b]
    if differ or len(streams) != len(clean):
        problems.append(f"streams {differ} differ from the unarmed run's")
    if san.violations:
        problems.append("violations: " + "; ".join(
            v.render() for v in san.violations[:3]))
    if audits < waves:
        problems.append(f"{audits} audits for {waves} waves")
    if not sleeps.count:
        problems.append("no perturb sleep was taken")
    if launches != want:
        problems.append(f"B1 launches {launches} != layers x legs {want}")
    if leaks:
        problems.append(f"leaks {leaks}")
    if problems:
        raise AssertionError("sanitize: " + "; ".join(problems))
    phase4 = [strip_eos(t, cfg) for t in streams]
    same4 = [a == b for a, b in zip(phase4, toks)]
    n_tok = sum(len(t) for t in streams)
    log(f"sanitize ({srv.preset}, ragged, kernel leg, GRAFTSAN_SEED="
        f"{SAN_SEED}): {len(streams)} streams equal to the unarmed run's "
        f"on one schedule ({N_GREEDY} greedy, {len(streams) - N_GREEDY} "
        f"sampled); violations 0; audits {audits} for {waves} waves; "
        f"perturb sleeps {sleeps.count} ({1e3 * sleeps.seconds:.3f} ms); "
        f"B1 launches {launches} (expected {want}); clean audit; equal to "
        f"phase 4's streams {sum(same4)} of {len(same4)} (reported); "
        f"tokens/s armed {n_tok / wall:.1f} unarmed "
        f"{sum(len(t) for t in clean) / clean_wall:.1f}")
    return {"card": card_line(), "seed": SAN_SEED, "launches": launches,
            "waves": waves, "prefill_waves": st["prefill_waves"],
            "audits": audits, "violations": 0, "sleeps": sleeps.count,
            "sleep_ms": 1e3 * sleeps.seconds,
            "equal_phase4": sum(same4), "tokens_per_s": n_tok / wall,
            "tokens_per_s_unarmed": sum(len(t) for t in clean) / clean_wall}


PP_DIR = os.path.join("build", "prepackaged")  # model files, made anew
PP_SEED = 12
# (a) an XGBoost ensemble of UCI HIGGS's width: 28 features, 1000 trees
# of xgboost's default max_depth 6, binary:logistic, base_score 0.5.
XGB_FEATURES, XGB_TREES, XGB_DEPTH = 28, 1000, 6
XGB_ROWS, XGB_NAN = 8192, 0.01
XGB_REPS = 10
# (b) a logistic model.npz of MNIST's shape.
SK_IN, SK_OUT, SK_ROWS = 784, 10, 4096
PROB_ATOL = 1e-5
NEAR_TIE = 1e-5  # top-2 probability gap below which a label may flip
# (c) the three detectors at their JAX defaults on KDD Cup 99's width.
KDD_FEATURES, DET_ROWS, DET_OUTLIERS = 41, 4096, 64
DET_SEQ_ROWS, DET_SEQ_T = 1024, 10
DET_EPOCHS = 3
DET_RTOL = 1e-4
# (d) integrated gradients over (b)'s head.
IG_ROWS, IG_STEPS, IG_CLASS = 16, 128, 3
IG_ATOL = 1e-5
# (e) the graph's rows per request and requests.
PP_GRAPH_ROWS, PP_GRAPH_REQUESTS = 16, 4


def xgb_forest(rng):
    """Full trees in heap order (node i's children 2i+1, 2i+2): feature,
    f32 threshold and missing-goes-left of every internal node, f32 leaf
    values; and the xgboost JSON dump of the same trees."""
    import numpy as np

    n_int = 2 ** XGB_DEPTH - 1
    feat = rng.integers(0, XGB_FEATURES, (XGB_TREES, n_int))
    thr = rng.normal(size=(XGB_TREES, n_int)).astype(np.float32)
    miss_left = rng.random((XGB_TREES, n_int)) < 0.5
    leaf = (0.1 * rng.normal(size=(XGB_TREES, n_int + 1))).astype(
        np.float32)

    def node(t, i):
        if i >= n_int:
            return {"nodeid": i, "leaf": float(leaf[t, i - n_int])}
        yes, no = 2 * i + 1, 2 * i + 2
        return {"nodeid": i, "split": f"f{int(feat[t, i])}",
                "split_condition": float(thr[t, i]), "yes": yes, "no": no,
                "missing": yes if miss_left[t, i] else no,
                "children": [node(t, yes), node(t, no)]}

    dump = [node(t, 0) for t in range(XGB_TREES)]
    return (feat, thr, miss_left, leaf), dump


def numpy_tree_walk(forest, X):
    """Final heap node of every (row, tree), walked in numpy from the
    generator's own arrays (not from the dump's parse): the oracle of the
    device cursors. A full tree's heap ids are its dense ids."""
    import numpy as np

    feat, thr, miss_left, _ = forest
    B, T = X.shape[0], feat.shape[0]
    tree = np.arange(T)[None, :]
    rows = np.arange(B)[:, None]
    node = np.zeros((B, T), np.int64)
    for _ in range(XGB_DEPTH):
        x = X[rows, feat[tree, node]]
        yes, no = 2 * node + 1, 2 * node + 2
        nxt = np.where(x < thr[tree, node], yes, no)
        node = np.where(np.isnan(x),
                        np.where(miss_left[tree, node], yes, no), nxt)
    return node


def tree_bytes(B, T, F, depth):
    """Bytes a traversal must move: each row read once, and per (row,
    tree) the path's nodes in the ensemble's own 4-byte fields (feature,
    threshold and the taken child per level, then the leaf value) with the
    row's feature value each level; the margins written once."""
    return 4 * (B * F + B * T * (4 * depth + 1) + B)


def prepackaged_xgb(rng, dev):
    """(a): the served ensemble against the numpy walk; rows/s."""
    import numpy as np
    import torch

    from seldon_tpu_torch.ops import trees
    from seldon_tpu_torch.servers.xgboostserver import XGBoostServer

    forest, dump = xgb_forest(rng)
    path = os.path.join(PP_DIR, "xgb")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.json"), "w") as f:
        json.dump({"trees": dump, "objective": "binary:logistic",
                   "base_score": 0.5}, f)
    X = rng.normal(size=(XGB_ROWS, XGB_FEATURES)).astype(np.float32)
    X[rng.random(X.shape) < XGB_NAN] = np.nan
    t0 = time.perf_counter()
    srv = XGBoostServer(model_uri=path, device=dev)
    srv.load()
    load_s = time.perf_counter() - t0
    got = srv.predict(X, [])
    Xd = torch.from_numpy(X).to(dev)
    cursors = srv._trees.leaves(Xd).cpu().numpy()
    want_nodes = numpy_tree_walk(forest, X)
    n_int = 2 ** XGB_DEPTH - 1
    margins = forest[3][np.arange(XGB_TREES)[None, :],
                        want_nodes - n_int].astype(np.float64).sum(1)
    want = 1.0 / (1.0 + np.exp(-margins))  # base_score 0.5: margin 0
    err = float(np.abs(got.astype(np.float64) - want).max())
    problems = []
    if srv.tags()["backend"] != "torch-trees" or \
            srv._trees.device.type != dev.type:
        problems.append(f"route {srv.tags()} on {srv._trees.device}")
    if not np.array_equal(cursors, want_nodes):
        problems.append(f"{int((cursors != want_nodes).sum())} cursors "
                        f"differ from the numpy walk")
    if err > PROB_ATOL:
        problems.append(f"probabilities off by {err}")
    if problems:
        raise AssertionError("prepackaged xgboost: " + "; ".join(problems))
    # Rows/s through the server (upload, traversal, read-back), and the
    # traversal alone on resident rows by CUDA events.
    srv.predict(X, [])
    t0 = time.perf_counter()
    for _ in range(XGB_REPS):
        srv.predict(X, [])
    server_s = (time.perf_counter() - t0) / XGB_REPS
    dev_ms = (cuda_time_ms(lambda: trees.predict(srv._trees, Xd, "binary"),
                           XGB_REPS, 2) if dev.type == "cuda" else None)
    nbytes = tree_bytes(XGB_ROWS, XGB_TREES, XGB_FEATURES, XGB_DEPTH)
    bound_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    out = {"trees": XGB_TREES, "depth": XGB_DEPTH, "rows": XGB_ROWS,
           "nan_share": float(np.isnan(X).mean()), "load_s": load_s,
           "max_abs_err": err, "server_rows_per_s": XGB_ROWS / server_s,
           "device_ms": dev_ms, "bound_ms": bound_ms, "bytes": nbytes,
           "device_rows_per_s": (XGB_ROWS / (dev_ms / 1e3)
                                 if dev_ms else None),
           "bound_rows_per_s": XGB_ROWS / (bound_ms / 1e3)}
    log(f"prepackaged (a) xgboost: {XGB_TREES} trees depth {XGB_DEPTH} x "
        f"{XGB_FEATURES} features, {XGB_ROWS} rows ({out['nan_share']:.4f} "
        f"NaN); cursors bit-equal to the numpy walk; probabilities max err "
        f"{err:.3g}; load {load_s:.2f} s; server {out['server_rows_per_s']:.0f}"
        f" rows/s; traversal {dev_ms} ms = {out['device_rows_per_s']} rows/s"
        f" against a bound of {bound_ms:.4f} ms ({nbytes} bytes)")
    return srv, X, out


def prepackaged_sklearn(rng, dev):
    """(b): the logistic model.npz against a numpy f64 product, with the
    process's f32 matmul precision lowered around the call."""
    import numpy as np
    import torch

    from seldon_tpu_torch.servers.sklearnserver import (SKLearnServer,
                                                       export_linear_model)

    coef = (0.05 * rng.normal(size=(SK_OUT, SK_IN))).astype(np.float32)
    intercept = (0.1 * rng.normal(size=SK_OUT)).astype(np.float32)
    path = os.path.join(PP_DIR, "sklearn")
    export_linear_model(path, coef, intercept, classes=np.arange(SK_OUT))
    X = rng.uniform(0.0, 1.0, size=(SK_ROWS, SK_IN)).astype(np.float32)
    logits = X.astype(np.float64) @ coef.T.astype(np.float64) + intercept
    e = np.exp(logits - logits.max(1, keepdims=True))
    want = e / e.sum(1, keepdims=True)
    proba = SKLearnServer(model_uri=path, device=dev)
    labels = SKLearnServer(model_uri=path, method="predict", device=dev)
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 for the others
        t0 = time.perf_counter()
        got = proba.predict(X, [])
        proba_s = time.perf_counter() - t0
        got_labels = labels.predict(X, [])
        after = torch.get_float32_matmul_precision()
    finally:
        torch.set_float32_matmul_precision(before)
    err = float(np.abs(got.astype(np.float64) - want).max())
    top2 = np.sort(want, 1)[:, -2:]
    ties = np.flatnonzero(top2[:, 1] - top2[:, 0] < NEAR_TIE)
    clear = np.setdiff1d(np.arange(SK_ROWS), ties)
    flips = np.flatnonzero(got_labels[clear] != want[clear].argmax(1))
    problems = []
    if proba.tags()["backend"] != "torch" or \
            proba._head.device.type != dev.type:
        problems.append(f"route {proba.tags()} on {proba._head.device}")
    if after != "high":
        problems.append(f"the head left the precision at {after!r}")
    if err > PROB_ATOL:
        problems.append(f"probabilities off by {err}")
    if len(flips):
        problems.append(f"labels differ outside near-ties at rows "
                        f"{clear[flips][:10].tolist()}")
    if problems:
        raise AssertionError("prepackaged sklearn: " + "; ".join(problems))
    for i in ties:
        log(f"prepackaged (b) near-tie row {i}: top-2 gap "
            f"{top2[i, 1] - top2[i, 0]:.3g}, label {got_labels[i]} vs "
            f"numpy {want[i].argmax()}")
    log(f"prepackaged (b) sklearn: {SK_IN} x {SK_OUT} logistic, {SK_ROWS} "
        f"rows, float32 matmul precision 'high' outside the head; "
        f"probabilities max err {err:.3g} against the numpy f64 product; "
        f"labels equal on {len(clear)} rows, {len(ties)} near-ties; "
        f"predict_proba {1e3 * proba_s:.2f} ms")
    return proba, X, {"rows": SK_ROWS, "max_abs_err": err,
                      "near_ties": ties.tolist(), "proba_ms": 1e3 * proba_s}


def prepackaged_detectors(rng, dev):
    """(c): the isolation forest fitted on the host, the VAE and the
    Seq2Seq-LSTM fitted on the card for DET_EPOCHS epochs; each scored on
    the card and by the port on the CPU from the same state."""
    import numpy as np

    from seldon_tpu_torch.components import (IsolationForestDetector,
                                             Seq2SeqLSTMDetector,
                                             VAEDetector)

    X = rng.normal(size=(DET_ROWS, KDD_FEATURES)).astype(np.float32)
    Xo = rng.normal(4.0, 1.0, size=(DET_OUTLIERS, KDD_FEATURES)).astype(
        np.float32)
    S = rng.normal(size=(DET_SEQ_ROWS, DET_SEQ_T, KDD_FEATURES)).astype(
        np.float32)
    So = rng.normal(0.0, 3.0, size=(DET_OUTLIERS, DET_SEQ_T,
                                    KDD_FEATURES)).astype(np.float32)
    cases = (("iforest", lambda: IsolationForestDetector(device=dev).fit(X),
              X, Xo),
             ("vae", lambda: VAEDetector(device=dev).fit(X, epochs=DET_EPOCHS),
              X, Xo),
             ("lstm", lambda: Seq2SeqLSTMDetector(device=dev).fit(
                 S, epochs=DET_EPOCHS), S, So))
    out, problems = {}, []
    for name, fit, inl, outl in cases:
        t0 = time.perf_counter()
        det = fit()
        fit_s = time.perf_counter() - t0
        rows = np.concatenate([inl[:DET_OUTLIERS], outl])
        t0 = time.perf_counter()
        got = det.predict(rows, [])
        score_s = time.perf_counter() - t0
        host = type(det).from_jax_state(det.__getstate__(), device="cpu")
        want = host.predict(rows, [])
        rel = float(np.max(np.abs(got - want) / np.abs(want)))
        if det.device.type != dev.type or rel > DET_RTOL:
            problems.append(f"{name} on {det.device}: card vs CPU rel "
                            f"{rel}")
        sep = float(got[DET_OUTLIERS:].mean() / got[:DET_OUTLIERS].mean())
        out[name] = {"fit_s": fit_s, "score_ms": 1e3 * score_s,
                     "rows": len(rows), "max_rel_err": rel,
                     "outlier_over_inlier": sep}
        log(f"prepackaged (c) {name}: fit {fit_s:.2f} s "
            f"({'host' if name == 'iforest' else dev.type}), score "
            f"{len(rows)} rows {1e3 * score_s:.2f} ms, card vs CPU max rel "
            f"{rel:.3g}, mean outlier / inlier score {sep:.3f}")
    if problems:
        raise AssertionError("prepackaged detectors: " + "; ".join(problems))
    return out


def prepackaged_ig(head, X, dev):
    """(d): integrated gradients over (b)'s head on the card: completeness
    per row, and the CPU port's attributions on the same head."""
    import numpy as np

    from seldon_tpu_torch.components import IntegratedGradients
    from seldon_tpu_torch.servers.sklearnserver import LinearHead

    rows = X[:IG_ROWS]
    t0 = time.perf_counter()
    attr = IntegratedGradients(head, steps=IG_STEPS, output_index=IG_CLASS,
                               device=dev).explain(rows)
    ig_s = time.perf_counter() - t0
    f = (head.predict_numpy(rows)[:, IG_CLASS].astype(np.float64)
         - head.predict_numpy(np.zeros_like(rows))[:, IG_CLASS])
    gap = np.abs(attr.astype(np.float64).sum(1) - f)
    host_head = LinearHead(head.coef_t.T.cpu().numpy(),
                           head.intercept.cpu().numpy(), classifier=True,
                           device="cpu")
    host = IntegratedGradients(host_head, steps=IG_STEPS,
                               output_index=IG_CLASS,
                               device="cpu").explain(rows)
    err = float(np.abs(attr - host).max())
    bad = np.flatnonzero(gap > 1e-3 * np.abs(f) + 1e-5)
    if len(bad) or err > IG_ATOL:
        raise AssertionError(f"prepackaged ig: completeness off at rows "
                             f"{bad.tolist()} (gaps {gap[bad].tolist()}), "
                             f"card vs CPU {err}")
    log(f"prepackaged (d) ig: {IG_ROWS} rows x {SK_IN} features, {IG_STEPS}"
        f" steps, class {IG_CLASS}: completeness gap max {gap.max():.3g} "
        f"(|f(x) - f(b)| min {np.abs(f).min():.3g}); card vs CPU max err "
        f"{err:.3g}; {1e3 * ig_s:.1f} ms")
    return {"rows": IG_ROWS, "steps": IG_STEPS, "completeness_gap":
            float(gap.max()), "max_abs_err": err, "ms": 1e3 * ig_s}


def prepackaged_graph(xgb_srv, X, dev):
    """(e): an isolation-forest detector as the input transformer in front
    of (a)'s XGBoost model, both port units over REST behind the port's
    orchestrator: answers bit-equal to direct calls, the detector's tags
    in meta; with ``requests`` on the host, the occlusion explainer unit
    against that predictor equal to a local OcclusionExplainer."""
    import numpy as np

    from seldon_tpu_torch.components import (ExplainerServer,
                                             IsolationForestDetector,
                                             OcclusionExplainer)
    from seldon_tpu_torch.core import payloads
    from seldon_tpu_torch.orchestrator.server import EngineServer
    from seldon_tpu_torch.orchestrator.spec import PredictorSpec
    from seldon_tpu_torch.runtime import wrapper
    from seldon_tpu_torch.runtime.metrics_server import ServerMetrics

    clean = X[~np.isnan(X).any(1)]
    det = IsolationForestDetector(threshold=0.55, device=dev).fit(
        clean[:2048])
    n = PP_GRAPH_ROWS * PP_GRAPH_REQUESTS
    rows = clean[-n:].copy()
    rows[::PP_GRAPH_ROWS] += 6.0  # one planted outlier per request
    units = [RestThread(wrapper.build_rest_app(u)) for u in (det, xgb_srv)]
    et = None
    out = {}
    try:
        def ep(port):
            return {"service_host": "127.0.0.1", "service_port": port,
                    "type": "REST"}

        spec = PredictorSpec.from_dict({"name": "prepackaged", "graph": {
            "name": "iforest", "type": "TRANSFORMER",
            "endpoint": ep(units[0].port),
            "children": [{"name": "xgb", "type": "MODEL",
                          "endpoint": ep(units[1].port)}]}})
        et = EngineThread(EngineServer(spec=spec, http_port=0, grpc_port=0,
                                       enable_batching=False,
                                       metrics=ServerMetrics()))
        problems, lat = [], []
        for i in range(PP_GRAPH_REQUESTS):
            part = rows[i * PP_GRAPH_ROWS:(i + 1) * PP_GRAPH_ROWS]
            t0 = time.perf_counter()
            status, raw = http_post(et.http, "/api/v0.1/predictions",
                                    {"data": {"ndarray": part.tolist()}})
            lat.append(time.perf_counter() - t0)
            if status != 200:
                raise AssertionError(f"prepackaged graph: {status} "
                                     f"{raw[:300]!r}")
            body = json.loads(raw)
            got = np.asarray(payloads.get_data_from_message(
                payloads.dict_to_message(body)), np.float64)
            want = xgb_srv.predict(part, []).astype(np.float64)
            det.predict(part, [])
            tags = det.tags()
            meta = body["meta"]
            if not np.array_equal(got, want):
                problems.append(f"request {i}: answer differs from the "
                                f"direct call by "
                                f"{np.abs(got - want).max()}")
            if {k: meta.get("tags", {}).get(k) for k in tags} != tags:
                problems.append(f"request {i}: meta tags {meta.get('tags')}"
                                f" against {tags}")
            if set(meta.get("requestPath", {})) != {"iforest", "xgb"}:
                problems.append(f"request {i}: path {meta.get('requestPath')}")
        out.update(requests=PP_GRAPH_REQUESTS, rows=n,
                   outliers_tagged=tags["outlier_count"],
                   latency_ms=[1e3 * s for s in lat])
        libs = host_libraries()
        if libs["requests"]:
            xs = ExplainerServer(predictor_host=f"127.0.0.1:{et.http}")
            remote = xs.predict(rows[:2], [])
            local = OcclusionExplainer(
                lambda Z: xgb_srv.predict(Z, [])).explain(rows[:2])
            if not np.array_equal(remote, local):
                problems.append(f"occlusion over the graph differs from the "
                                f"local explainer by "
                                f"{np.abs(remote - local).max()}")
            out["occlusion"] = {"rows": 2, "features": rows.shape[1],
                                "max_abs_attr": float(np.abs(local).max())}
        else:
            out["occlusion"] = "skipped: requests is not installed"
        if problems:
            raise AssertionError("prepackaged graph: " + "; ".join(problems))
    finally:
        if et is not None:
            et.close()
        for u in units:
            u.close()
    log(f"prepackaged (e) graph: iforest TRANSFORMER -> xgb MODEL over REST,"
        f" {PP_GRAPH_REQUESTS} requests of {PP_GRAPH_ROWS} rows bit-equal to"
        f" direct calls, detector tags in meta; occlusion explainer: "
        f"{out['occlusion']}; latency ms {[round(v, 2) for v in out['latency_ms']]}")
    return out


def prepackaged_mlflow(rng, dev):
    """The MLflow sklearn-pickle route, where sklearn and PyYAML are on the
    host: a LogisticRegression pickled beside its MLmodel, served on the
    device head against a numpy f64 product of its f32 parameters."""
    import numpy as np

    libs = host_libraries()
    if not (libs["sklearn"] and libs["yaml"]):
        return {"ran": False, "reason": f"sklearn {libs['sklearn']}, yaml "
                                        f"{libs['yaml']}"}
    import pickle

    from sklearn.linear_model import LogisticRegression

    from seldon_tpu_torch.servers.mlflowserver import MLFlowServer

    X = rng.normal(size=(512, 20))
    y = (X[:, 0] + X[:, 1] > 0).astype(int) + (X[:, 2] > 1).astype(int)
    clf = LogisticRegression(max_iter=500).fit(X, y)
    path = os.path.join(PP_DIR, "mlflow")
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "model.pkl"), "wb") as f:
        pickle.dump(clf, f)
    with open(os.path.join(path, "MLmodel"), "w") as f:
        f.write("flavors:\n  sklearn:\n    pickled_model: model.pkl\n"
                "    serialization_format: cloudpickle\n")
    srv = MLFlowServer(model_uri=path, method="predict_proba", device=dev)
    Xt = rng.normal(size=(256, 20)).astype(np.float32)
    got = srv.predict(Xt, [])
    coef = clf.coef_.astype(np.float32).astype(np.float64)
    logits = Xt.astype(np.float64) @ coef.T + clf.intercept_.astype(
        np.float32)
    e = np.exp(logits - logits.max(1, keepdims=True))
    err = float(np.abs(got - e / e.sum(1, keepdims=True)).max())
    if srv.tags()["backend"] != "torch" or err > PROB_ATOL:
        raise AssertionError(f"prepackaged mlflow: {srv.tags()}, err {err}")
    log(f"prepackaged mlflow: sklearn pickle route ran on {dev.type} "
        f"(backend torch), probabilities max err {err:.3g}")
    return {"ran": True, "max_abs_err": err}


def phase_prepackaged(dev):
    """9k: the prepackaged servers and learned components on the card,
    every file made under ``build/prepackaged`` from a seeded generator:
    (a) XGBoost (``model.json``, HIGGS's 28 features, 1000 trees of depth
    6, binary:logistic) on 8192 rows with ~1% NaN: cursors bit-equal to a
    numpy walk, probabilities within 1e-5, rows/s against the bytes'
    bound; (b) SKLearn (``model.npz``, 784 x 10 logistic) on 4096 rows:
    probabilities within 1e-5 of a numpy f64 product with the process's
    matmul precision lowered, labels equal outside near-ties; (c) the
    isolation forest, VAE and Seq2Seq-LSTM at their defaults on KDD Cup
    99's 41 features, scored on the card and on the CPU from the same
    state within rtol 1e-4; (d) integrated gradients over (b)'s head:
    completeness and the CPU's attributions; (e) an isolation forest as
    the input transformer of (a)'s model behind the port's orchestrator,
    both REST units: answers bit-equal to direct calls, tags in meta, the
    occlusion explainer over it where ``requests`` is installed; and the
    MLflow sklearn pickle where sklearn and PyYAML are."""
    import numpy as np

    libs = host_libraries()
    log("prepackaged host libraries: " + ", ".join(
        f"{k} {v}" for k, v in libs.items()))
    rng = np.random.default_rng(PP_SEED)
    t0 = time.perf_counter()
    xgb_srv, X28, a = prepackaged_xgb(rng, dev)
    sk_srv, X784, b = prepackaged_sklearn(rng, dev)
    c = prepackaged_detectors(rng, dev)
    d = prepackaged_ig(sk_srv._head, X784, dev)
    e = prepackaged_graph(xgb_srv, X28, dev)
    m = prepackaged_mlflow(rng, dev)
    if not m["ran"]:
        log(f"prepackaged mlflow: not run here ({m['reason']})")
    return {"card": card_line(), "host_libraries": libs, "xgboost": a,
            "sklearn": b, "detectors": c, "ig": d, "graph": e, "mlflow": m,
            "seconds": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# Phase 9d: the prefix cache on the ragged path, and checkpoint loading
# ---------------------------------------------------------------------------

SHARED_LEN = 1024  # the shared system prompt: a multiple of the chunk
COW_SHARED_LEN = 1040  # the copy-on-write round's: 32.5 blocks of 32
COW_KV_BLOCK, COW_PREFIX_BLOCK = 32, 16
PRIME_SUFFIX = 16  # the priming request: shared prompt + 16 tokens
PREFIX_SEED = 0x9D
LOAD_LAYERS = 2  # depth of the checkpoint written and loaded
LOAD_REQUESTS = 3  # greedy requests, one at a time, loaded vs in memory
SHARED_TAP_CHECKS = 2  # B1 launches held to the plain version per leg


def prefix_requests(vocab, shared_len, seed):
    """(priming request, 8 requests): a shared prompt of `shared_len`
    token ids from a seeded rng, followed by the priming request's 16
    tokens or each request's own suffix of PROMPT_LENS tokens; MAX_NEW
    greedy tokens each."""
    import numpy as np

    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, shared_len).tolist()

    def req(n, s):
        return {"prompt_token_ids": shared + rng.integers(0, vocab,
                                                          n).tolist(),
                "max_new_tokens": MAX_NEW, "seed": s, "temperature": 0.0}

    prime = req(PRIME_SUFFIX, 300)
    return prime, [req(n, 200 + i) for i, n in enumerate(PROMPT_LENS)]


def strip_eos(toks, cfg):
    return toks[:-1] if toks and toks[-1] == cfg.eos_token_id else toks


def prefix_run(params, cfg, ecfg, dev, reqs, to_sampling, prime=None,
               taps=(), direct_copy=False):
    """A fresh engine: warmup, the priming request alone (when given),
    then `reqs` at once under `taps`. B1's launch count is set to 0 just
    before the priming request and read after the burst has drained.
    Returns the streams (trailing EOS stripped), the burst's mean TTFT,
    wall seconds, tokens/s and prefill waves, the engine's stats, the
    launches, the leak audit and, with `direct_copy`, whether one
    copy-on-write of a block the trie holds onto a free block is
    bit-equal to its source on every pool array."""
    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, ecfg, dev)
    eng.warmup()
    eng.start()
    out = {}
    try:
        rpa.launches = 0
        if prime is not None:
            eng.generate_blocking(prime["prompt_token_ids"],
                                  to_sampling(prime))
        before = eng.stats.snapshot()
        with contextlib.ExitStack() as stack:
            for tap in taps:
                stack.enter_context(tap)
            results, wall = run_concurrent(
                lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                                to_sampling(r)),
                reqs, timeout_s=900)
        if not eng.drain(timeout=60):
            raise AssertionError("engine did not go idle after the burst")
        out["launches"] = rpa.launches
    finally:
        eng.stop()
    stats = eng.stats.snapshot()
    if direct_copy:
        refs = eng._paged_prefix.block_refs()
        src, dst = max(refs), eng._allocator.alloc()
        eng._cow(src, dst)
        out["direct_copy"] = {"src": src, "dst": dst, "equal": all(
            torch.equal(a[:, dst], a[:, src])
            for a in eng._state["cache"].values())}
        eng._allocator.unref(dst)
    out["leaks"] = eng.debug_lifecycle_check()
    streams = [strip_eos(r["token_ids"], cfg) for r in results]
    n_tok = sum(len(r["token_ids"]) for r in results)
    out.update(
        streams=streams, stats=stats, wall_s=wall, tokens=n_tok,
        tokens_per_s=n_tok / wall,
        mean_ttft_ms=sum(r["ttft_ms"] for r in results) / len(results),
        burst_waves=stats["decode_dispatches"] - before["decode_dispatches"],
        burst_prefill_waves=stats["prefill_waves"] - before["prefill_waves"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


class SharedTableTap:
    """Instrumentation of this script: while active, B1's launches at the
    first and last layer whose block table gives one pool block id to the
    live columns of two rows are each followed by the plain version on
    the same inputs, on the card, up to SHARED_TAP_CHECKS per wave leg;
    the errors are kept by leg with the number of shared block ids. Reads
    the table back at those layers (after every replay of a captured
    wave, ``on_host``); used on a comparison run only."""

    def __init__(self, n_layers):
        self.n_layers = n_layers
        self.calls = 0
        self.checked = {"decode": 0, "prefill": 0}
        self.shared_ids = {"decode": 0, "prefill": 0}
        self.errs = {}

    def __enter__(self):
        from seldon_tpu_torch.ops import ragged_paged_attention as rpa

        self._rpa, self._orig = rpa, rpa.partials_kernel

        def check(q, layer, table, bound, got):
            leg = "decode" if q.shape[1] == 1 else "prefill"
            if self.checked[leg] >= SHARED_TAP_CHECKS:
                return
            block = layer["k"].shape[2]
            t, b = table.cpu(), bound.amax(dim=1).cpu()
            seen, shared = {}, set()
            for row in range(t.shape[0]):
                n = -(-int(b[row]) // block)
                for bid in set(t[row, :n].tolist()) - {0}:
                    if seen.setdefault(bid, row) != row:
                        shared.add(bid)
            if not shared:
                return
            want = rpa.partials_sparse(q, layer, table, bound)
            err = compare_partials(got, want, bound)
            self.errs[leg] = tuple(map(max, self.errs.get(leg, (0.0,) * 3),
                                       err))
            self.checked[leg] += 1
            self.shared_ids[leg] = max(self.shared_ids[leg], len(shared))

        def tapped(q, layer, table, bound):
            got = self._orig(q, layer, table, bound)
            li = self.calls % self.n_layers
            self.calls += 1
            if li in (0, self.n_layers - 1):
                on_host(functools.partial(check, q, layer, table, bound,
                                          got))
            return got

        rpa.partials_kernel = tapped
        recapture()
        return self

    def __exit__(self, *exc):
        self._rpa.partials_kernel = self._orig
        recapture()


def write_safetensors(path, tensors):
    """Write {name: CPU tensor} as one .safetensors file: an 8-byte
    little-endian header length, the JSON header (dtype, shape,
    data_offsets), then the raw bytes in order."""
    import torch

    tags = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, offset = {}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": tags[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            f.write(t.contiguous().view(-1).view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset


def write_hf_checkpoint(params, cfg, path, n_shards=2):
    """The port's weights as an HF Llama checkpoint directory: config.json,
    `n_shards` safetensors shards and model.safetensors.index.json;
    projections in HF's [out, in] layout, weights bf16, norms f32.
    Returns the bytes written."""
    hf_cfg = {
        "architectures": ["LlamaForCausalLM"], "model_type": "llama",
        "vocab_size": cfg.vocab_size, "hidden_size": cfg.d_model,
        "intermediate_size": cfg.d_ff, "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "max_position_embeddings": cfg.max_seq_len,
        "rope_theta": cfg.rope_theta, "rms_norm_eps": cfg.rms_norm_eps,
        "eos_token_id": cfg.eos_token_id, "pad_token_id": cfg.pad_token_id,
        "tie_word_embeddings": cfg.tie_embeddings, "torch_dtype": "bfloat16",
    }
    names = [("model.embed_tokens.weight", params.embed, False)]
    for i, bp in enumerate(params.blocks):
        p = f"model.layers.{i}."
        names += [(p + "input_layernorm.weight", bp.attn_norm, False),
                  (p + "self_attn.q_proj.weight", bp.wq, True),
                  (p + "self_attn.k_proj.weight", bp.wk, True),
                  (p + "self_attn.v_proj.weight", bp.wv, True),
                  (p + "self_attn.o_proj.weight", bp.wo, True),
                  (p + "post_attention_layernorm.weight", bp.mlp_norm, False),
                  (p + "mlp.gate_proj.weight", bp.w_gate, True),
                  (p + "mlp.up_proj.weight", bp.w_up, True),
                  (p + "mlp.down_proj.weight", bp.w_down, True)]
    names.append(("model.norm.weight", params.final_norm, False))
    if params.lm_head is not None:
        names.append(("lm_head.weight", params.lm_head, True))
    per = -(-len(names) // n_shards)
    weight_map, total = {}, 0
    os.makedirs(path, exist_ok=True)
    for s in range(n_shards):
        shard = f"model-{s + 1:05d}-of-{n_shards:05d}.safetensors"
        part = names[s * per:(s + 1) * per]
        tensors = {name: (t.t() if tr else t).contiguous().cpu()
                   for name, t, tr in part}
        total += write_safetensors(os.path.join(path, shard), tensors)
        weight_map.update({name: shard for name, _, _ in part})
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_cfg, f)
    return total


def prefix_round(params, cfg, ecfg, dev, to_sampling):
    """The shared prompt of SHARED_LEN (a multiple of the chunk): cold
    (cache off) and warm (cache on, primed) through fresh engines, each
    once timed and once under LogitTap."""
    import torch

    prime, reqs = prefix_requests(cfg.vocab_size, SHARED_LEN, PREFIX_SEED)
    seeds = [r["seed"] for r in reqs]
    ecfg_w = dataclasses.replace(ecfg, prefix_cache=True)
    cold = prefix_run(params, cfg, ecfg, dev, reqs, to_sampling)
    warm = prefix_run(params, cfg, ecfg_w, dev, reqs, to_sampling,
                      prime=prime)
    with LogitTap(seeds) as cold_tap:
        cold_t = prefix_run(params, cfg, ecfg, dev, reqs, to_sampling)
    with LogitTap(seeds) as warm_tap:
        warm_t = prefix_run(params, cfg, ecfg_w, dev, reqs, to_sampling,
                            prime=prime)
    s = warm["stats"]
    n = len(reqs)
    want = {"prefix_hits": n, "prefix_tokens_saved": n * SHARED_LEN,
            "zero_copy_admissions": n, "cow_copies": 0,
            "prefix_seed_copies": 0}
    for run in (warm, warm_t):
        got = {k: run["stats"][k] for k in want}
        if got != want:
            raise AssertionError(f"prefix counters {got} != {want}")
    expected = cfg.n_layers * (s["decode_dispatches"] + s["prefill_waves"])
    if warm["launches"] != expected:
        raise AssertionError(f"prefix phase: B1 launches {warm['launches']}"
                             f" != layers x legs {expected}")
    for name, run in (("cold", cold), ("warm", warm), ("cold tapped", cold_t),
                      ("warm tapped", warm_t)):
        if run["leaks"]:
            raise AssertionError(f"prefix {name} run leaks {run['leaks']}")
    streams = {"cold": cold["streams"], "warm": warm["streams"],
               "cold tapped": cold_t["streams"],
               "warm tapped": warm_t["streams"]}
    if any(st != cold["streams"] for st in streams.values()):
        raise AssertionError("a warm stream differs from the cold one: "
                             + json.dumps(streams))
    cmp = compare_legs(reqs, "prefix warm vs cold", (warm_t["streams"],
                                                     warm_tap.rows),
                       (cold_t["streams"], cold_tap.rows))
    first = [(r["seed"], len(r["prompt_token_ids"])) for r in reqs]
    unequal = [k for k in first
               if not torch.equal(warm_tap.rows[k], cold_tap.rows[k])]
    if unequal or cmp["max_logit_diff"] != 0.0:
        raise AssertionError(f"warm logits differ from cold ones: first "
                             f"tokens {unequal}, max |diff| "
                             f"{cmp['max_logit_diff']}")
    report = {k: {m: run[m] for m in ("mean_ttft_ms", "wall_s", "tokens",
                                      "tokens_per_s", "burst_waves",
                                      "burst_prefill_waves")}
              for k, run in (("cold", cold), ("warm", warm))}
    for k in ("cold", "warm"):
        r = report[k]
        log(f"prefix {k}: shared={SHARED_LEN} requests={n} "
            f"mean_ttft_ms={r['mean_ttft_ms']:.1f} "
            f"prefill_waves={r['burst_prefill_waves']} "
            f"waves={r['burst_waves']} tokens={r['tokens']} "
            f"wall_s={r['wall_s']:.3f} tokens_per_s="
            f"{r['tokens_per_s']:.1f}")
    log(f"prefix warm: counters {want} held; B1 launches "
        f"{warm['launches']} (layers x legs {expected}); streams equal to "
        f"cold; logits bit-equal at {cmp['positions']} positions, first "
        f"tokens included")
    report.update(counters={k: s[k] for k in want}, launches=warm["launches"],
                  expected_launches=expected, logits=cmp)
    return report


def cow_round(params, cfg, ecfg, dev, to_sampling, floor):
    """kv_block 32, prefix_block 16 and a shared prompt of COW_SHARED_LEN:
    every warm admission matches 32.5 pool blocks and copies one. Cold
    and warm under LogitTap; the warm run also under SharedTableTap, and
    one direct copy on its pool afterwards."""
    prime, reqs = prefix_requests(cfg.vocab_size, COW_SHARED_LEN,
                                  PREFIX_SEED + 1)
    seeds = [r["seed"] for r in reqs]
    ecfg_c = dataclasses.replace(ecfg, kv_block=COW_KV_BLOCK,
                                 prefix_block=COW_PREFIX_BLOCK)
    ecfg_w = dataclasses.replace(ecfg_c, prefix_cache=True)
    with LogitTap(seeds) as cold_tap:
        cold = prefix_run(params, cfg, ecfg_c, dev, reqs, to_sampling)
    shared_tap = SharedTableTap(cfg.n_layers)
    with LogitTap(seeds) as warm_tap:
        warm = prefix_run(params, cfg, ecfg_w, dev, reqs, to_sampling,
                          prime=prime, taps=(shared_tap,), direct_copy=True)
    s, n = warm["stats"], len(reqs)
    want = {"prefix_hits": n, "prefix_tokens_saved": n * COW_SHARED_LEN,
            "zero_copy_admissions": n, "cow_copies": n,
            "prefix_seed_copies": 0}
    got = {k: s[k] for k in want}
    if got != want:
        raise AssertionError(f"copy-on-write counters {got} != {want}")
    if not warm["direct_copy"]["equal"]:
        raise AssertionError(f"a direct copy-on-write is not bit-equal to "
                             f"its source: {warm['direct_copy']}")
    if cold["leaks"] or warm["leaks"]:
        raise AssertionError(f"copy-on-write leaks: {cold['leaks']} "
                             f"{warm['leaks']}")
    if min(shared_tap.checked.values()) == 0:
        raise AssertionError(f"no launch with shared block ids was checked "
                             f"on a wave leg: {shared_tap.checked}")
    bad = {leg: e for leg, e in shared_tap.errs.items()
           if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
    if bad:
        raise AssertionError(f"B1 disagrees with its plain version over "
                             f"shared block ids: {bad}")
    cmp = compare_legs(reqs, "copy-on-write warm vs cold",
                       (warm["streams"], warm_tap.rows),
                       (cold["streams"], cold_tap.rows))
    if cmp["median_logit_diff"] > floor:
        raise AssertionError(f"copy-on-write warm logits differ from cold "
                             f"ones by {cmp['median_logit_diff']} (median), "
                             f"over phase 6's nudge floor {floor}")
    log(f"copy-on-write: kv_block={COW_KV_BLOCK} prefix_block="
        f"{COW_PREFIX_BLOCK} shared={COW_SHARED_LEN}: counters {want} "
        f"held; direct copy {warm['direct_copy']}; B1 vs plain over shared "
        f"block ids: checked {shared_tap.checked}, shared ids "
        f"{shared_tap.shared_ids}, err {shared_tap.errs}; median |logit "
        f"diff| {cmp['median_logit_diff']:.4g} <= nudge floor {floor:.4g}")
    return {"counters": got, "direct_copy": warm["direct_copy"],
            "shared_tap": {"checked": shared_tap.checked,
                           "shared_ids": shared_tap.shared_ids,
                           "errors": shared_tap.errs},
            "logits": cmp, "floor": floor,
            "mean_ttft_ms": {"cold": cold["mean_ttft_ms"],
                             "warm": warm["mean_ttft_ms"]}}


def write_orbax_checkpoint(params, cfg, path):
    """The port's weights as an orbax directory, written by
    ``checkpoint.save_checkpoint``. Returns the bytes written."""
    from seldon_tpu_torch.servers import checkpoint

    checkpoint.save_checkpoint(path, params, cfg)
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


# load_round's checkpoint formats: (writer returning the bytes written,
# the label in its log line).
CHECKPOINT_WRITERS = {
    "hf": (write_hf_checkpoint, "an HF checkpoint"),
    "orbax": (write_orbax_checkpoint, "an orbax directory (save_checkpoint)"),
}


def differing_leaves(a, b):
    """The names of the leaves (parameters and buffers) where two models
    differ in name set, dtype, shape or bits."""
    import torch

    def named(m):
        return {k: t for k, t in list(m.named_parameters())
                + list(m.named_buffers()) if t is not None}

    x, y = named(a), named(b)
    if x.keys() != y.keys():
        return sorted(x.keys() ^ y.keys())
    return [k for k in x if x[k].dtype != y[k].dtype
            or x[k].shape != y[k].shape
            or not torch.equal(x[k].contiguous().view(torch.uint8),
                               y[k].contiguous().view(torch.uint8))]


def load_round(srv, dev, fmt, n_layers):
    """Phase 4's weights cut to ``n_layers`` layers at full width, written
    in format ``fmt`` (``CHECKPOINT_WRITERS``) under build/ and served
    from it by ``TorchServer(model_uri=...)`` on the card, against the
    same cut served from memory: parameters bit-equal, LOAD_REQUESTS
    greedy requests one at a time with equal streams and bit-equal
    logits, B1 launches = layers x legs. The checkpoint stays on disk
    (its path in the result) for its caller, which removes it; a failed
    round removes it."""
    import shutil
    import tempfile

    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.engine import InferenceEngine
    from seldon_tpu_torch.servers.torchserver import TorchServer

    write, label = CHECKPOINT_WRITERS[fmt]
    p_cut, cfg_cut = shallow(srv.params, srv.cfg, n_layers)
    os.makedirs("build", exist_ok=True)
    path = tempfile.mkdtemp(prefix=f"{fmt}_ckpt_", dir="build")
    out = {"path": path}
    lsrv = None
    kept = False
    try:
        t0 = time.perf_counter()
        nbytes = write(p_cut, cfg_cut, path)
        out["write_s"] = time.perf_counter() - t0
        lsrv = TorchServer(model_uri=path, max_slots=32, max_seq_len=2048,
                           ragged=1, ragged_kernel="pallas", device=dev)
        t0 = time.perf_counter()
        with lsrv._load_lock:
            lsrv._load_model()
        # The copies to the card are queued on the stream: wait for them.
        lsrv.params.embed.sum().item()
        load_s = time.perf_counter() - t0
        lsrv.load()
        if lsrv.params.device != dev:
            raise AssertionError(f"{fmt}: the checkpoint loaded on "
                                 f"{lsrv.params.device}, not {dev}")
        if dataclasses.asdict(lsrv.cfg) != dataclasses.asdict(cfg_cut):
            raise AssertionError(f"{fmt}: loaded config {lsrv.cfg} != "
                                 f"{cfg_cut}")
        unequal = differing_leaves(lsrv.params, p_cut)
        if unequal:
            raise AssertionError(f"{fmt}: loaded leaves differ: {unequal}")
        reqs = requests(cfg_cut.vocab_size)[:LOAD_REQUESTS]
        ecfg = lsrv.engine.ecfg
        rpa.launches = 0
        with LogitTap([r["seed"] for r in reqs]) as tap_l:
            loaded = [lsrv.generate(r)["token_ids"] for r in reqs]
        launches = rpa.launches
        snap = lsrv.engine.stats.snapshot()
        lsrv.stop()
        leaks = lsrv.engine.debug_lifecycle_check()
        lsrv = None
        gc.collect()
        eng = InferenceEngine(p_cut, cfg_cut, ecfg, dev)
        eng.start()
        try:
            with LogitTap([r["seed"] for r in reqs]) as tap_m:
                memory = [strip_eos(eng.generate_blocking(
                    r["prompt_token_ids"], srv._to_sampling(r))["token_ids"],
                    cfg_cut) for r in reqs]
        finally:
            eng.stop()
        if leaks or eng.debug_lifecycle_check():
            raise AssertionError(f"{fmt} load round leaks: {leaks}")
        if loaded != memory:
            raise AssertionError(f"{fmt}: loaded streams {loaded} != "
                                 f"in-memory streams {memory}")
        if sorted(tap_l.rows) != sorted(tap_m.rows):
            raise AssertionError(f"{fmt}: loaded and in-memory runs sampled "
                                 "different positions")
        diff = [k for k in tap_l.rows
                if not torch.equal(tap_l.rows[k], tap_m.rows[k])]
        if diff:
            raise AssertionError(f"{fmt}: loaded logits differ at {diff}")
        expected = cfg_cut.n_layers * (snap["decode_dispatches"]
                                       + snap["prefill_waves"])
        if launches == 0 or launches != expected:
            raise AssertionError(f"{fmt} load round: B1 launches {launches} "
                                 f"!= layers x legs {expected}")
        out.update(bytes=nbytes, load_s=load_s, gb_per_s=nbytes / load_s / 1e9,
                   launches=launches, positions=len(tap_l.rows))
        log(f"load {fmt}: {n_layers}-layer llama3-8b cut as {label}, "
            f"{nbytes / 1e9:.3f} GB written in {out['write_s']:.2f} s; "
            f"TorchServer(model_uri) loaded it on the card in {load_s:.2f} "
            f"s ({out['gb_per_s']:.2f} GB/s from disk to the card); "
            f"parameters bit-equal; {LOAD_REQUESTS} greedy streams equal "
            f"and logits bit-equal at {len(tap_l.rows)} positions; B1 "
            f"launches {launches}")
        kept = True
        return out
    finally:
        if lsrv is not None:
            lsrv.stop()
        if not kept:
            shutil.rmtree(path, ignore_errors=True)


ORBAX_FIXTURES = ("bf16", "int8")  # tests/data/torch_orbax_tiny_<kind>
# Depth of (b)'s cut: 1, not LOAD_LAYERS' 2: with 2 the whole script ran
# 972.7 s on an H100 (NVIDIA H100 80GB HBM3, 700.00 W), near its 1200 s
# limit.
ORBAX_LAYERS = 1
ORBAX_DECODE_MB = 64  # the decoder's rate: fixture frames decoded to this


def _orbax_fixture(kind):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "data", f"torch_orbax_tiny_{kind}")


def orbax_fixture_round(kind, dev):
    """(a) One committed JAX-written ``tiny`` orbax fixture served on the
    card by ``TorchServer(model_uri=..., ragged=1,
    ragged_kernel="pallas")``: every leaf's SHA-256 equals the record's;
    the greedy stream of each recorded prompt equals JAX's, or diverges
    where JAX's recorded top-2 gap is under RAGGED_LOGITS_ATOL (a
    near-tie, reported); B1 launches = layers x wave legs."""
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers import checkpoint
    from seldon_tpu_torch.servers.torchserver import TorchServer

    path = _orbax_fixture(kind)
    with open(os.path.join(path, "record.json")) as f:
        rec = json.load(f)
    fsrv = TorchServer(model_uri=path, max_slots=4, max_seq_len=64,
                       prefill_chunk=16, ragged=1, ragged_kernel="pallas",
                       device=dev)
    try:
        fsrv.load()
        digests = checkpoint.leaf_sha256(fsrv.params)
        if digests != rec["leaves"]:
            bad = sorted(k for k in rec["leaves"]
                         if digests.get(k) != rec["leaves"][k])
            raise AssertionError(f"orbax {kind}: leaves {bad} differ from "
                                 f"the fixture's SHA-256")
        rpa.launches = 0
        got = [fsrv.generate({"prompt_token_ids": p,
                              "max_new_tokens": rec["max_new_tokens"],
                              "temperature": 0.0})["token_ids"]
               for p in rec["prompts"]]
        launches = rpa.launches
        snap = fsrv.engine.stats.snapshot()
    finally:
        fsrv.stop()
    ties = []
    for r, (g, w) in enumerate(zip(got, rec["streams"])):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        gap = rec["top2_gaps"][r][i] if i < len(w) else float("inf")
        if not gap < rpa.RAGGED_LOGITS_ATOL:
            raise AssertionError(
                f"orbax {kind}: request {r} diverges from JAX's stream at "
                f"token {i} where JAX's top-2 gap is {gap} (not a near-tie)"
                f": {g} vs {w}")
        ties.append({"request": r, "token": i, "gap": gap})
    legs = snap["decode_dispatches"] + snap["prefill_waves"]
    if launches == 0 or launches != 2 * legs:  # tiny has 2 layers
        raise AssertionError(f"orbax {kind}: B1 launches {launches} != "
                             f"layers x legs {2 * legs}")
    log(f"orbax (a) {kind}: JAX-written tiny fixture, {len(digests)} leaves "
        f"SHA-256-equal; {len(got)} greedy streams: "
        f"{len(got) - len(ties)} equal to JAX's, near-ties {ties}; B1 "
        f"launches {launches}")
    return {"leaves": len(digests), "streams": got, "near_ties": ties,
            "launches": launches}


def orbax_decode_rate():
    """(d) The zstd decoder's rate on this host: the bf16 fixture's chunk
    frames (Huffman literals and FSE sequences, as JAX's zstd level 1
    wrote them) decoded over and over until ORBAX_DECODE_MB MB came out."""
    import numpy as np

    from seldon_tpu_torch.servers import ocdbt, zarr_v2, zstd

    reader = ocdbt.OcdbtReader(os.path.join(_orbax_fixture("bf16"),
                                            "params"))
    arrays = zarr_v2.ZarrStore(reader)
    frames = []
    for key in reader.list():
        name, _, chunk = key.rpartition("/")
        if chunk != ".zarray":
            meta = arrays.meta(name)
            frames.append((reader.view(key), np.empty(meta.chunks,
                                                      meta.np_dtype)))
    total = compressed = 0
    t0 = time.perf_counter()
    while total < ORBAX_DECODE_MB * 1e6:
        for raw, out in frames:
            total += zstd.decompress_into(raw, out)
            compressed += raw.size
    secs = time.perf_counter() - t0
    return {"mb_per_s": total / secs / 1e6, "decoded_bytes": total,
            "ratio": compressed / total, "frames": len(frames)}


def orbax_round(srv, dev):
    """Orbax checkpoint directories (``servers/checkpoint.py`` with the
    port's own zstd, OCDBT and zarr readers):
    (a) the JAX-written fixtures on the card (``orbax_fixture_round``);
    (b) ``load_round`` in the orbax format at ORBAX_LAYERS layers;
    (c) ``build_rank_shard(cfg, ("orbax", path), dev, r, 2)`` for r = 0, 1
    in this process (no group), each bit-equal to the cut's slice
    (``tp_sharding.shard_params``); (d) the decoder's MB/s. The
    checkpoint is removed afterwards, also on failure."""
    import shutil
    import types

    import torch

    from seldon_tpu_torch.models import tp_sharding
    from seldon_tpu_torch.servers import mesh_engine

    out = {"fixtures": {k: orbax_fixture_round(k, dev)
                        for k in ORBAX_FIXTURES}}
    out.update(load_round(srv, dev, "orbax", ORBAX_LAYERS))
    path = out.pop("path")
    try:
        p_cut, cfg_cut = shallow(srv.params, srv.cfg, ORBAX_LAYERS)
        shards = {}
        for r in range(2):
            t0 = time.perf_counter()
            got = mesh_engine.build_rank_shard(cfg_cut, ("orbax", path), dev,
                                               r, 2)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            want = tp_sharding.shard_params(
                types.SimpleNamespace(rank=r, world=2), cfg_cut, p_cut)
            unequal = differing_leaves(got, want)
            if unequal:
                raise AssertionError(f"orbax (c): rank {r}'s shard differs "
                                     f"from the cut's slice: {unequal}")
            shards[r] = {"seconds": secs, "leaves": len(list(
                got.parameters()))}
            del got, want
        out["shards"] = shards
        log(f"orbax (c): build_rank_shard(('orbax', path)) for ranks 0 and "
            f"1 of tp 2 bit-equal to the cut's slices "
            f"({shards[0]['seconds']:.2f} s, {shards[1]['seconds']:.2f} s)")
    finally:
        shutil.rmtree(path, ignore_errors=True)
    out["decode"] = orbax_decode_rate()
    log(f"orbax (d): zstd decoder {out['decode']['mb_per_s']:.1f} MB/s on "
        f"the card's host ({out['decode']['frames']} JAX-written frames, "
        f"{out['decode']['decoded_bytes'] / 1e6:.1f} MB out, compressed to "
        f"{out['decode']['ratio']:.3f})")
    return out


def phase_prefix(srv, legs, dev):
    """The prefix cache on the ragged path (``prefix_cache=True``), with
    phase 4's llama3-8b weights and engine configuration (32 slots, 2048
    positions, ``kv_block=16``, chunk 128, bf16 pool, the kernel leg), and
    checkpoint loading from a ``model_uri``.

    Prefix round: a shared prompt of SHARED_LEN token ids; one priming
    request (shared + 16 tokens), then 8 requests (shared + suffixes of
    PROMPT_LENS tokens, MAX_NEW greedy tokens each) at once; the same 8
    served cold by an engine with the cache off. Gates: prefix_hits 8,
    prefix_tokens_saved 8 x SHARED_LEN, zero_copy_admissions 8,
    cow_copies 0, prefix_seed_copies 0; B1 launches = layers x wave legs;
    clean leak audits; every warm stream equal to the cold one, and the
    logits of every shared position (first tokens included) bit-equal:
    SHARED_LEN is a multiple of the chunk, so every row splits pool and
    fresh columns where the cold run does. Reported: TTFT, prefill waves
    and tokens/s, cold against warm.

    Copy-on-write round: kv_block 32, prefix_block 16, a shared prompt of
    COW_SHARED_LEN tokens. Gates: cow_copies 8; a direct copy on the
    full-width pool bit-equal to its source; B1 held to its plain version
    (phase 3's tolerances) at launches whose tables share block ids
    between rows; warm against cold logits within phase 6's full-depth
    one-ulp nudge floor (the split point moves, ROADMAP.md C1); streams
    reported.

    Load round: see ``load_round``; the load seconds and GB/s from disk
    to the card are reported. Orbax round: see ``orbax_round``."""
    ecfg = srv._engine_config(srv.cfg)
    floor = legs["depths"][srv.cfg.n_layers]["nudged_vs_masked"][
        "median_logit_diff"]
    out = {"prefix": prefix_round(srv.params, srv.cfg, ecfg, dev,
                                  srv._to_sampling)}
    out["cow"] = cow_round(srv.params, srv.cfg, ecfg, dev, srv._to_sampling,
                           floor)
    out["load"] = load_round(srv, dev, "hf", LOAD_LAYERS)
    out["orbax"] = orbax_round(srv, dev)
    return out


# ---------------------------------------------------------------------------
# Phases 9e-9f: the bucketed and dense engines, speculative decoding
# ---------------------------------------------------------------------------

# The bucketed phase's three engines over phase 4's weights under
# attn_impl="flash": (a) paged, (b) the JAX engine's default dense slab,
# (c) paged with chunked prefill.
BUCKETED = {"a_paged": dict(paged_kv=True),
            "b_dense": dict(paged_kv=False),
            "c_chunked": dict(paged_kv=True, chunked_prefill=True)}


def bucketed_ecfg(srv, **kw):
    """Phase 4's engine configuration (32 slots, 2048 positions, the
    prompt buckets, kv_block 16, chunk 128) on the bucketed engine."""
    ecfg = srv._engine_config(srv.cfg)
    return dataclasses.replace(ecfg, **dict(dict(
        ragged=False, chunked_prefill=False, ragged_kernel="masked"), **kw))


def engine_burst(params, cfg, ecfg, dev, reqs, to_sampling, taps=(),
                 draft=None, spy=None, warm=None, eager=False, prof=None):
    """One fresh engine serving `reqs` at once under `taps`;
    `spy(engine)` is called once the engine exists. ``eager``: inside
    ``wave_program.disabled()``, else the captured programs. ``warm``:
    before the burst, under the taps (which then ``reset``), the
    engine's ``warmup`` (``"lattice"``: every key captured) or the same
    burst once untimed (``"burst"``: the keys it dispatches), so the
    burst replays programs captured before it; ``prof`` (a
    ``torch.profiler.profile``) is entered around the burst alone. B1's
    and B2's launch counts are set to 0 just before the burst and read
    after it has drained. Returns the streams (trailing EOS stripped),
    the wall seconds, tokens/s, mean TTFT, the stats, the launches, the
    programs (keys, captures, capture ms, the graph pool's bytes) and the
    leak audit. Unless warmed, each program is captured at its first
    dispatch (the kernels are built by phase 2): its tokens/s and TTFT
    include those captures (eager: each shape's first dispatch)."""
    import torch

    from seldon_tpu_torch.ops import flash_attention as fa
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers import wave_program
    from seldon_tpu_torch.servers.engine import InferenceEngine

    eng = InferenceEngine(params, cfg, ecfg, dev, draft=draft)
    if spy is not None:
        spy(eng)
    out = {}
    try:
        with contextlib.ExitStack() as stack:
            if eager:
                stack.enter_context(wave_program.disabled())
            for tap in taps:
                stack.enter_context(tap)
            if warm == "lattice":
                eng.warmup()
            eng.start()
            if warm == "burst":
                run_concurrent(
                    lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                                    to_sampling(r)),
                    reqs, timeout_s=900)
                wait_idle(eng)
            if warm is not None:
                torch.cuda.synchronize()
                for tap in taps:
                    if hasattr(tap, "reset"):
                        tap.reset()
            captures = eng._programs.captures
            rpa.launches = 0
            fa.reset_launches()
            with prof if prof is not None else contextlib.nullcontext():
                results, wall = run_concurrent(
                    lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                                    to_sampling(r)),
                    reqs, timeout_s=900)
                torch.cuda.synchronize()
            if not eng.drain(timeout=60):
                raise AssertionError("engine did not go idle after the "
                                     "burst")
            out["launches_b1"] = rpa.launches
            out["launches_b2"] = fa.launches
            progs = eng._programs
            out["programs"] = {
                "keys": progs.keys(), "captures": progs.captures,
                "captures_in_burst": progs.captures - captures,
                "capture_ms": list(progs.capture_ms),
                "pool_bytes": progs.pool_bytes(), "runs": progs.runs}
    finally:
        eng.stop()
    out["stats"] = eng.stats.snapshot()
    out["leaks"] = eng.debug_lifecycle_check()
    if out["leaks"]:
        raise AssertionError(f"leak audit after the burst: {out['leaks']}")
    toks = [r["token_ids"] for r in results]
    if any(not t for t in toks) or any(not 0 <= x < cfg.vocab_size
                                       for t in toks for x in t):
        raise AssertionError("a request returned no tokens or a token id "
                             "outside the vocabulary")
    n_tok = sum(len(t) for t in toks)
    out.update(streams=[strip_eos(t, cfg) for t in toks], wall_s=wall,
               tokens=n_tok, tokens_per_s=n_tok / wall,
               mean_ttft_ms=sum(r["ttft_ms"] for r in results) / len(results))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


class FlashBoundTap:
    """Instrumentation of this script: while active, sums the bound (the
    larger of bytes over the memory rate and operations over the bf16
    rate, ``flash_work``) of each B2 launch, from its shapes on the host
    (in a captured program at every replay, ``on_host``); nothing waits
    for the device."""

    def __enter__(self):
        from seldon_tpu_torch.ops import flash_attention as fa

        self._fa, self._orig = fa, fa.flash_kernel
        self.bound_ms = 0.0

        def add(ms):
            self.bound_ms += ms

        def tapped(q, k, v, causal, q_offset, *rest, **kw):
            nbytes, ops = flash_work(q, k, causal, q_offset)
            on_host(functools.partial(add, max(
                nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S) * 1e3))
            return self._orig(q, k, v, causal, q_offset, *rest, **kw)

        fa.flash_kernel = tapped
        recapture()
        return self

    def reset(self):
        self.bound_ms = 0.0

    def __exit__(self, *exc):
        self._fa.flash_kernel = self._orig
        recapture()


def profiled_burst(params, cfg, ecfg, dev, reqs, to_sampling, draft=None,
                   eager=False, warm="lattice"):
    """`engine_burst` on a warmed engine (its programs captured before
    the burst by ``warm``, ``eager`` inside ``wave_program.disabled()``)
    under
    ``torch.profiler``: the device's busy time (the union of its kernels'
    and copies' intervals), its idle share of the burst's wall time, the
    host's launch calls, and the device kernels that take the most time;
    B1's and B2's device time per launch beside their bounds per launch,
    from this burst's own inputs (BurstTap, FlashBoundTap). The
    profiler's own cost is inside the wall time."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    b1, b2 = BurstTap(leg="all"), FlashBoundTap()
    res = engine_burst(params, cfg, ecfg, dev, reqs, to_sampling,
                       taps=(b1, b2), draft=draft, warm=warm, eager=eager,
                       prof=prof)
    busy_ms, span_ms, by_name = device_breakdown(prof)
    wall_ms = res["wall_s"] * 1e3
    calls = launch_calls(prof)
    dispatches = (res["stats"]["admit_dispatches"]
                  + res["stats"]["decode_dispatches"])
    out = {"route": "eager" if eager else "captured",
           "wall_ms": wall_ms, "device_busy_ms": busy_ms,
           "device_span_ms": span_ms,
           "device_idle_share": 1.0 - busy_ms / wall_ms,
           "tokens_per_s": res["tokens_per_s"], "tokens": res["tokens"],
           "launch_calls": calls, "dispatches": dispatches,
           "launches_per_dispatch": sum(calls.values()) / max(dispatches,
                                                               1),
           "programs": res["programs"],
           "b1_device_ms": sum(v[0] for k, v in by_name if b1_leg(k)),
           "b2_device_ms": sum(v[0] for k, v in by_name
                               if "flash_fwd" in k),
           "b1_launches": res["launches_b1"],
           "b2_launches": res["launches_b2"],
           "top_device": [{"name": k, "ms": v[0], "count": v[1]}
                          for k, v in by_name[:12]]}
    if b1.calls:
        out["b1_ms_per_launch"] = out["b1_device_ms"] / res["launches_b1"]
        out["b1_bound_ms_per_launch"] = (b1.bounds_by_leg()["all"]["bound_ms"]
                                         / res["launches_b1"])
    if res["launches_b2"]:
        out["b2_ms_per_launch"] = out["b2_device_ms"] / res["launches_b2"]
        out["b2_bound_ms_per_launch"] = b2.bound_ms / res["launches_b2"]
    return out


def log_profile(name, p):
    log(f"{name} profile ({p['route']}): wall_ms={p['wall_ms']:.1f} "
        f"device_busy_ms={p['device_busy_ms']:.1f} device_idle_share="
        f"{p['device_idle_share']:.3f} tokens_per_s="
        f"{p['tokens_per_s']:.1f} host launches per dispatch="
        f"{p['launches_per_dispatch']:.1f} b1_device_ms="
        f"{p['b1_device_ms']:.2f} b2_device_ms={p['b2_device_ms']:.2f}"
        + "".join(f" {k}={p[k]:.4f}" for k in (
            "b1_ms_per_launch", "b1_bound_ms_per_launch",
            "b2_ms_per_launch", "b2_bound_ms_per_launch") if k in p))
    for d in p["top_device"][:6]:
        log(f"{name} profile device {d['ms']:9.2f} ms {d['count']:6d}x "
            f"{d['name'][:90]}")


def first_token_diffs(reqs, rows, ref_rows):
    """max |logit diff| over the vocabulary at each greedy request's first
    token (key (seed, len(prompt))), against the reference rows."""
    out = []
    for r in reqs:
        key = (r["seed"], len(r["prompt_token_ids"]))
        out.append(float((rows[key] - ref_rows[key]).abs().max()))
    return out


def phase_bucketed(srv, reqs, toks, legs, kernel_leg, dev):
    """The bucketed engine families (``ragged=False``) on phase 4's
    weights (9a's cut), ``attn_impl="flash"``: (a) the paged pool, (b)
    the JAX engine's default, the dense slab (32 slots x 2048 positions),
    (c) paged with chunked prefill; phase 4's 8 requests at once.
    Reported per engine: tokens/s, mean TTFT, admission and decode
    dispatches (the profiled bursts of these engines: phase 5d). Every
    engine runs its families as captured programs. Gates:
     * B2 launches = layers x cold admission dispatches (a warm or
       chunked admission runs ``prefill_with_prefix``, no kernel: (c)
       launches none);
     * B2 within phase 3b's one-ulp gate of ``flash_blockwise`` on its
       own inputs at the first, middle and last layer of every cold
       admission of the tapped bursts of (a) and (b);
     * the first-token logits of the 6 greedy requests in (a) and (b)
       within SCORE_DRIFT_MAX x phase 6's full-depth nudge floor of the
       ragged kernel leg's (phase 6's rows; two rounding paths differ
       here, the cold prefill's B2 against the chunked prefill's B1, as
       in phase 7's flash-vs-xla gate), median over the requests;
     * a clean leak audit after every burst.
    Greedy streams against phase 4's are reported (ROADMAP.md C1)."""
    import torch

    params = srv.params
    cfg = dataclasses.replace(srv.cfg, attn_impl="flash")
    floor = legs["depths"][srv.cfg.n_layers]["nudged_vs_masked"][
        "median_logit_diff"]
    greedy = reqs[:N_GREEDY]
    _, kernel_rows = kernel_leg
    out = {"floor": floor, "engines": {}}
    checks = []
    for name, kw in BUCKETED.items():
        ecfg = bucketed_ecfg(srv, **kw)
        res = engine_burst(params, cfg, ecfg, dev, reqs, srv._to_sampling)
        s = res["stats"]
        if res["launches_b2"] != cfg.n_layers * s["cold_admit_dispatches"]:
            raise AssertionError(
                f"{name}: B2 launches {res['launches_b2']} != layers x cold "
                f"admissions {s['cold_admit_dispatches']}")
        if res["launches_b1"]:
            raise AssertionError(f"{name}: the bucketed engine launched B1")
        eng = {k: res[k] for k in ("tokens", "wall_s", "tokens_per_s",
                                   "mean_ttft_ms", "launches_b2")}
        eng.update({k: s[k] for k in (
            "admit_dispatches", "cold_admit_dispatches", "prefill_chunks",
            "decode_dispatches", "decode_steps")})
        eng["streams_equal_phase4"] = sum(
            a == b for a, b in zip(res["streams"][:N_GREEDY],
                                   toks[:N_GREEDY]))
        if name != "c_chunked":
            tap = FlashTap(cfg.n_layers)
            with LogitTap([r["seed"] for r in greedy]) as logits:
                tapped = engine_burst(params, cfg, ecfg, dev, greedy,
                                      srv._to_sampling, taps=(tap,))
            if not tap.checks:
                raise AssertionError(f"{name}: no B2 launch was checked")
            bad = [c for c in tap.checks if not c["ok"]]
            if bad:
                raise AssertionError(f"{name}: B2 disagrees with its plain "
                                     f"version on the admission's inputs: "
                                     f"{bad[:3]}")
            checks += tap.checks
            diffs = first_token_diffs(greedy, logits.rows, kernel_rows)
            med = sorted(diffs)[len(diffs) // 2]
            eng.update(first_token_logit_diff=diffs,
                       first_token_median_diff=med,
                       b2_checked=len(tap.checks),
                       b2_max_abs_err=max(c["max_abs_err"]
                                          for c in tap.checks),
                       tapped_launches_b2=tapped["launches_b2"])
            if med > SCORE_DRIFT_MAX * floor:
                raise AssertionError(
                    f"{name}: first-token logits {med:.4g} from the ragged "
                    f"kernel leg's, beyond {SCORE_DRIFT_MAX} x the nudge "
                    f"floor {floor:.4g}")
        out["engines"][name] = eng
        log(f"bucketed {name}: tokens={eng['tokens']} wall_s="
            f"{eng['wall_s']:.3f} tokens_per_s={eng['tokens_per_s']:.1f} "
            f"mean_ttft_ms={eng['mean_ttft_ms']:.1f} admit_dispatches="
            f"{eng['admit_dispatches']} (cold {eng['cold_admit_dispatches']})"
            f" prefill_chunks={eng['prefill_chunks']} decode_dispatches="
            f"{eng['decode_dispatches']} decode_steps={eng['decode_steps']}"
            f" b2_launches={eng['launches_b2']} greedy streams equal phase "
            f"4's: {eng['streams_equal_phase4']}/{N_GREEDY}"
            + (f"; first-token |logit diff| vs the ragged kernel leg median "
               f"{eng['first_token_median_diff']:.4g} (floor {floor:.4g}); "
               f"B2 checked {eng['b2_checked']} launches, max_abs_err "
               f"{eng['b2_max_abs_err']:.3g}"
               if "b2_checked" in eng else ""))
        gc.collect()
        torch.cuda.empty_cache()
    out["launches"] = sum(e["launches_b2"] for e in out["engines"].values())
    out["b2_max_abs_err"] = max(c["max_abs_err"] for c in checks)
    return out



class SpecAudit:
    """Instrumentation of this script: wraps the engine's
    ``_spec_post_process`` to keep each verify wave's (k, wave rows,
    emitted, drafted, accepted) and, after its rollback, audit the pool:
    the allocator's used blocks equal the blocks the live requests'
    tables hold, and no wave row still live holds a block past the one
    its next position writes (a full acceptance may leave it one short:
    the next wave's growth adds it). Host bookkeeping only, nothing waits
    for the device."""

    def __init__(self):
        self.waves = []
        self.violations = []

    def __call__(self, eng):
        orig = eng._spec_post_process

        def audited(chunk_data, roster):
            info = eng._spec_wave
            before = (eng._spec_drafted, eng._spec_accepted)
            orig(chunk_data, roster)
            if info is None or chunk_data is None or not info[2]:
                return
            k, wave, n_wave = info
            emitted = int(chunk_data[1].sum(axis=0)[wave].sum())
            self.waves.append((k, n_wave, emitted,
                               eng._spec_drafted - before[0],
                               eng._spec_accepted - before[1]))
            held = sum(len(r.block_ids) for r in eng._slots
                       if r is not None and not r.finished)
            used = eng._allocator.snapshot()["used"]
            bs = eng._kv_block
            short = [r.rid for s, r in enumerate(roster) if wave[s]
                     and r is not None and not r.finished
                     and eng._slots[s] is r and len(r.block_ids) > min(
                         eng._nbs, (len(r.tokens) + r.n_generated - 1)
                         // bs + 1)]
            if used != held or short:
                self.violations.append({"used": used, "held": held,
                                        "rows": short})

        eng._spec_post_process = audited

    def identities(self, stats):
        """Per wave accepted + rejected = drafted and emitted + rejected =
        (k + 1) x wave rows; the totals equal the engine's counters."""
        rejected = 0
        for k, n_wave, emitted, drafted, accepted in self.waves:
            rej = (k + 1) * n_wave - emitted
            if not (accepted + rej == drafted == k * n_wave
                    and emitted + rej == (k + 1) * n_wave):
                raise AssertionError(f"a verify wave breaks the identities: "
                                     f"{(k, n_wave, emitted, drafted)}")
            rejected += rej
        sums = (sum(w[3] for w in self.waves), sum(w[4] for w in self.waves),
                rejected, len(self.waves))
        want = (stats["spec_drafted_tokens"], stats["spec_accepted_tokens"],
                stats["spec_rejected_tokens"], stats["spec_verify_waves"])
        if sums != want:
            raise AssertionError(f"spec counters {want} != the waves' sums "
                                 f"{sums}")
        if self.violations:
            raise AssertionError(f"pool audit after a rollback: "
                                 f"{self.violations[:3]}")
        return {"waves": len(self.waves), "drafted": sums[0],
                "accepted": sums[1], "rejected": rejected,
                "emitted": sum(w[2] for w in self.waves)}


def phase_spec(srv, reqs, legs, dev):
    """Speculative decoding on the paged bucketed engine (``spec_decode``,
    k = SPEC_K, ``ragged_kernel="pallas"``, the preset's attention) with
    phase 4's weights and requests: the n-gram drafter (``SPEC=1``
    alone), then a model drafter passed as ``draft=``: the target's own
    weights cut to 2 layers (``shallow``), which shares the target's
    embedding, head and vocabulary; then the target itself as the draft
    model, over the drafter's 64-token history window (a shorter context
    than the target's, so not every draft is accepted: multi-token waves
    and their rollbacks at full width). Beside it the same engine with
    ``spec_decode=False``. Reported: drafted, accepted and emitted tokens
    per verify wave, verify waves, tokens/s against spec-off (the
    profiled n-gram burst: phase 5d). The verify waves replay captured
    programs. Gates:
     * B1 launches = layers x verify waves (every decode dispatch is one);
     * B1 within phase 3's tolerances of ``partials_sparse`` on the verify
       waves' own inputs (first, middle and last layer), rows outside the
       wave (bound 0) exactly (NEG_INF, 0, 0);
     * per wave accepted + rejected = drafted and emitted + rejected =
       (k + 1) x wave rows, exactly, and the engine's counters re-sum;
     * the pool audit clean after every rollback, and the leak audit
       after every burst;
     * spec-on logits within SCORE_DRIFT_MAX x phase 6's nudge floor of
       spec-off's (median over shared positions of the greedy requests).
    Greedy streams spec-on against spec-off are reported (ROADMAP.md C1:
    the verify wave's kernel leg and the decode chunk's masked leg round
    differently)."""
    import torch

    params, cfg = srv.params, srv.cfg
    floor = legs["depths"][cfg.n_layers]["nudged_vs_masked"][
        "median_logit_diff"]
    greedy = reqs[:N_GREEDY]
    off_cfg = bucketed_ecfg(srv, paged_kv=True)
    on_cfg = dataclasses.replace(off_cfg, spec_decode=True, spec_k=SPEC_K,
                                 ragged_kernel="pallas")
    out = {"floor": floor}
    off = engine_burst(params, cfg, off_cfg, dev, reqs, srv._to_sampling)
    with LogitTap([r["seed"] for r in greedy]) as off_logits:
        off_tapped = engine_burst(params, cfg, off_cfg, dev, greedy,
                                  srv._to_sampling)
    out["off"] = {k: off[k] for k in ("tokens", "wall_s", "tokens_per_s",
                                      "mean_ttft_ms")}
    out["off"]["decode_dispatches"] = off["stats"]["decode_dispatches"]
    draft = shallow(params, cfg, 2)
    launches = 0
    # The self-draft (the target's own weights over the drafter's
    # window) gets drafts accepted: multi-token waves at full width.
    for name, dr in (("ngram", None), ("model", draft),
                     ("self", (params, cfg))):
        audit = SpecAudit()
        res = engine_burst(params, cfg, on_cfg, dev, reqs, srv._to_sampling,
                           draft=dr, spy=audit)
        s = res["stats"]
        if res["launches_b1"] != cfg.n_layers * s["decode_dispatches"]:
            raise AssertionError(
                f"spec {name}: B1 launches {res['launches_b1']} != layers x "
                f"verify waves {s['decode_dispatches']}")
        launches += res["launches_b1"]
        ids = audit.identities(s)
        r = {k: res[k] for k in ("tokens", "wall_s", "tokens_per_s",
                                 "mean_ttft_ms", "launches_b1")}
        r.update(ids, verify_waves=s["decode_dispatches"],
                 acceptance_rate=s["spec_acceptance_rate"],
                 per_wave={k: ids[k] / max(ids["waves"], 1)
                           for k in ("drafted", "accepted", "emitted")},
                 streams_equal_off=sum(a == b for a, b in zip(
                     res["streams"][:N_GREEDY], off["streams"][:N_GREEDY])))
        if name == "ngram":
            tap = KernelTap(cfg.n_layers, leg="verify")
            audit2 = SpecAudit()
            with LogitTap([q["seed"] for q in greedy]) as on_logits:
                tapped = engine_burst(params, cfg, on_cfg, dev, greedy,
                                      srv._to_sampling, taps=(tap,),
                                      spy=audit2)
            audit2.identities(tapped["stats"])
            if not tap.checked.get("verify"):
                raise AssertionError("no verify-wave launch of B1 was "
                                     "checked")
            bad = {leg: e for leg, e in tap.errs.items()
                   if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
            if bad:
                raise AssertionError(f"B1 disagrees with its plain version "
                                     f"on the verify wave's inputs: {bad}")
            cmp = compare_legs(greedy, "spec-on vs spec-off",
                               (tapped["streams"], on_logits.rows),
                               (off_tapped["streams"], off_logits.rows))
            if cmp["median_logit_diff"] > SCORE_DRIFT_MAX * floor:
                raise AssertionError(
                    f"spec-on logits {cmp['median_logit_diff']:.4g} from "
                    f"spec-off, beyond {SCORE_DRIFT_MAX} x the nudge floor "
                    f"{floor:.4g}")
            r.update(b1_checked=tap.checked["verify"],
                     b1_errors=tap.errs["verify"], vs_off=cmp)
        out[name] = r
        log(f"spec {name}: verify_waves={r['verify_waves']} drafted="
            f"{r['drafted']} accepted={r['accepted']} rejected="
            f"{r['rejected']} emitted={r['emitted']} per wave drafted/"
            f"accepted/emitted {r['per_wave']['drafted']:.2f}/"
            f"{r['per_wave']['accepted']:.2f}/"
            f"{r['per_wave']['emitted']:.2f} tokens_per_s="
            f"{r['tokens_per_s']:.1f} (spec-off "
            f"{out['off']['tokens_per_s']:.1f}) mean_ttft_ms="
            f"{r['mean_ttft_ms']:.1f} b1_launches={r['launches_b1']} "
            f"greedy streams equal spec-off: {r['streams_equal_off']}/"
            f"{N_GREEDY}"
            + (f"; B1 checked {r['b1_checked']} launches, err m/l/acc "
               + "/".join(f"{e:.3g}" for e in r["b1_errors"])
               if "b1_checked" in r else ""))
        gc.collect()
        torch.cuda.empty_cache()
    del draft
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# Phase 9g: the engine's observatory (ledgers, pilot, /debug/*)
# ---------------------------------------------------------------------------

# Every ledger of the observatory, armed through the environment as an
# operator arms it (the engine reads the knobs when it is built).
OBS_TURNS = ("off", "on")  # the observatory's timed bursts, in turns
OBS_KNOBS = {"FLIGHT_RECORDER": "1", "COMPILE_LEDGER": "1",
             "DISPATCH_TIMING": "1", "HBM_LEDGER": "1", "SCHED_LEDGER": "1",
             "ROOF_LEDGER": "1", "PILOT": "hold"}

# This script's own copy of the frozen /debug/* key sets (the JAX
# package's schema goldens; timeline: the JAX flight recorder's
# snapshot): (top-level keys, {field: keys of the dict there},
# {field: keys of each element of the list there}).
DEBUG_SCHEMA = {
    "compile": (
        {"warmup_complete", "tp", "mesh_devices", "declared_variants",
         "dispatched_variants", "warmup_coverage", "compile_s_total",
         "live_retrace_count", "live_retraces", "lattice"}, {},
        {"live_retraces": {"key", "rid", "compile_ms", "ts"},
         "lattice": {"key", "dispatches", "first_dispatch_ms",
                     "declared"}}),
    "hbm": (
        {"categories", "devices", "total_bytes", "total_bytes_per_device",
         "total_high_bytes"}, {}, {}),
    "sched": (
        {"boundaries", "dispatch_boundaries", "idle_boundaries",
         "dispatch_cells", "useful_tokens", "bucket_pad_tokens",
         "group_pad_tokens", "spec_rejected_tokens", "frag_tokens",
         "budget_offered_tokens", "budget_used_tokens",
         "budget_starved_passes", "padding_waste_frac",
         "budget_utilization", "goodput_gap", "pool_stall_events",
         "pool_stall_requests", "preemptions", "preempted_tokens", "spec",
         "wait", "conservation", "by_shape"},
        {"goodput_gap": {"bucket_pad_frac", "group_pad_frac",
                         "spec_rejected_frac", "frag_frac", "idle_frac"},
         "spec": {"drafted_tokens", "accepted_tokens", "rejected_tokens",
                  "verify_waves", "acceptance_rate"},
         "wait": {"requests", "total_ms", "pool_ms", "bucket_ms",
                  "budget_ms", "sched_ms", "predicted_ms"},
         "conservation": {"checked", "breaches", "last_breach"}},
        {"by_shape": {"key", "dispatches", "cells", "useful_tokens",
                      "bucket_pad_tokens", "group_pad_tokens",
                      "spec_rejected_tokens"}}),
    "pilot": (
        {"enabled", "mode", "boundaries", "windows", "period_boundaries",
         "decisions_total", "decisions_by_knob", "knobs", "envelope",
         "edf", "counterfactual", "ledger"},
        {"decisions_by_knob": {"dispatch_token_budget", "max_admit",
                               "chunk_bias", "spec_k"},
         "knobs": {"dispatch_token_budget", "max_admit", "chunk_bias",
                   "spec_k"},
         "envelope": {"budget_min", "budget_max", "admit_min", "admit_max",
                      "bias_min", "bias_max", "speck_min", "speck_max"},
         "edf": {"inversions", "reorders", "expired_at_pop"},
         "counterfactual": {"windows", "goodput_delta",
                            "waste_frac_delta"}},
        {"ledger": {"ts", "knob", "old", "new", "rationale",
                    "expected_effect", "signal_snapshot", "effect"}}),
    "roof": (
        {"enabled", "platform", "peaks", "tp", "boundaries", "waves",
         "step", "host_frac", "device_frac", "conservation", "variants",
         "totals"},
        {"peaks": {"tflops", "gbs", "source"},
         "step": {"wall_ms", "host_pre_ms", "device_ms", "host_post_ms",
                  "overlap_ms"},
         "conservation": {"checked", "breaches", "last_breach"},
         "totals": {"dispatches", "flops", "bytes", "device_ms",
                    "predicted_ms", "mfu", "mbu"}},
        {"variants": {"key", "family", "dispatches", "flops", "bytes",
                      "device_ms", "predicted_ms", "capacity_flops",
                      "capacity_bytes", "capacity_predicted_ms", "mfu",
                      "mbu", "bound"}}),
    "timeline": (
        {"epoch_mono", "epoch_wall", "size", "total_recorded", "dropped",
         "records"}, {},
        {"records": {"ts", "kind", "rid", "detail"}}),
}
HBM_CATEGORY_KEYS = {"bytes", "bytes_per_device", "high_bytes", "static"}
PILOT_SIGNAL_KEYS = {
    "boundaries", "dispatch_cells", "useful_tokens", "frag_tokens",
    "budget_dispatches", "budget_starved_passes", "budget_offered_tokens",
    "budget_used_tokens", "pool_stall_events", "preemptions",
    "deadline_expired", "spec_drafted", "spec_accepted", "goodput",
    "queue_depth", "free_slots", "roof_backlog_ms", "heal_pressure"}


def check_schema(kind, snap):
    """Raise unless `snap` has the frozen key sets of /debug/<kind>."""
    top, dicts, lists = DEBUG_SCHEMA[kind]
    bad = []
    if set(snap) != top:
        bad.append(("top", sorted(set(snap) ^ top)))
    for field, keys in dicts.items():
        if set(snap[field]) != keys:
            bad.append((field, sorted(set(snap[field]) ^ keys)))
    for field, keys in lists.items():
        for e in snap[field]:
            if set(e) != keys:
                bad.append((field, sorted(set(e) ^ keys)))
    if kind == "hbm":
        bad += [(n, sorted(set(c) ^ HBM_CATEGORY_KEYS))
                for n, c in snap["categories"].items()
                if set(c) != HBM_CATEGORY_KEYS]
    if kind == "pilot":
        for e in snap["ledger"]:
            if set(e["signal_snapshot"]) != PILOT_SIGNAL_KEYS:
                bad.append(("signal_snapshot", sorted(
                    set(e["signal_snapshot"]) ^ PILOT_SIGNAL_KEYS)))
    if bad:
        raise AssertionError(f"/debug/{kind} breaks its frozen schema: "
                             f"{bad[:5]}")


class KeySpy:
    """Instrumentation of this script: records the static-shape key (the
    JAX engine's spelling) of every dispatch of one engine's device
    families, whether or not the engine's ledgers are armed: at its one
    dispatch site (``InferenceEngine._dispatch``, which a captured
    program and an eager family pass alike) and at the model drafter's
    call (``("draft", k)``). Each key is checked against the family's
    host arguments (the admission's group and bucket, the decode chunk's
    steps, the verify wave's drafts); nothing waits for the device."""

    # family -> the key read off its host arguments and keywords.
    ARGS = {
        "_admit_impl": lambda a, k: ("admit", a[0].shape[1],
                                     a[0].shape[0]),
        "_paged_admit_impl": lambda a, k: (
            "admit-paged", a[1].shape[1], a[1].shape[0], k["prefix_width"]),
        "_admit_chunk_impl": lambda a, k: (
            "chunk", a[0].shape[1], a[0].shape[0], k["prefix_width"]),
        "_paged_admit_chunk_impl": lambda a, k: (
            "chunk", a[1].shape[1], a[1].shape[0], k["prefix_width"]),
        "_chunk_impl": lambda a, k: ("decode", k["n_steps"]),
        "_paged_chunk_impl": lambda a, k: ("decode", k["n_steps"]),
        "_deactivate_impl": lambda a, k: ("deactivate",),
        "_cow_copy_impl": lambda a, k: ("cow",),
        "_verify_impl": lambda a, k: ("verify", a[1].shape[1]),
        "_admit_prefix_impl": lambda a, k: (
            "admit-prefix", a[3].pad_to, a[0].shape[1], a[0].shape[0]),
        "_seed_prefix_impl": lambda a, k: ("seed-prefix", a[0].pad_to),
        "ragged_wave": lambda a, k: ("ragged", a[1].size // a[0].shape[0]),
    }

    def __init__(self, eng):
        self.eng = eng
        self.keys = []
        self.mismatches = []

    def __enter__(self):
        eng, keys = self.eng, self.keys
        orig = eng._dispatch

        def spied(key, name, args, *rest, **kw):
            want = self.ARGS.get(name)
            if want is not None and want(args, kw) != tuple(key):
                self.mismatches.append((tuple(key), want(args, kw)))
            keys.append(tuple(key))
            return orig(key, name, args, *rest, **kw)

        eng._dispatch = spied
        drafter = eng._drafter
        if drafter is not None and drafter.uses_model:
            draft = drafter.draft_batch

            def drafted(rows, k, batch, *rest):
                keys.append(("draft", k))
                return draft(rows, k, batch, *rest)

            drafter.draft_batch = drafted
        return self

    def __exit__(self, *exc):
        del self.eng._dispatch
        if self.eng._drafter is not None and self.eng._drafter.uses_model:
            del self.eng._drafter.draft_batch
        if self.mismatches:
            raise AssertionError(f"KeySpy: dispatched keys against the "
                                 f"families' arguments: "
                                 f"{self.mismatches[:3]}")


def obs_server(srv, cfg, dev, armed, **kw):
    """A ``TorchServer(warmup=1)`` on phase 4's weights (assigned before
    ``load()``) with every ledger of the observatory armed or none;
    returns it loaded and the seconds of its load (the engine built and
    its whole lattice dispatched once)."""
    from seldon_tpu_torch.servers.torchserver import TorchServer

    ecfg = srv._engine_config(srv.cfg)
    saved = {k: os.environ.pop(k, None) for k in OBS_KNOBS}
    try:
        if armed:
            os.environ.update(OBS_KNOBS)
        s = TorchServer(preset=srv.preset, max_slots=srv.max_slots,
                        max_seq_len=ecfg.max_seq_len,
                        prefill_chunk=ecfg.prefill_chunk,
                        init_seed=0, warmup=1, device=dev, **kw)
        s.params, s.cfg = srv.params, cfg
        t0 = time.perf_counter()
        s.load()
        return s, time.perf_counter() - t0
    finally:
        for k, v in saved.items():
            os.environ.pop(k, None)
            if v is not None:
                os.environ[k] = v


def obs_burst(s, reqs, taps=()):
    """Phase 4's requests, every one queued before the scheduler's next
    pass (submitted under the engine's lock, so the ledgers-on and -off
    runs schedule the same waves), under `taps` and a KeySpy. B1's and
    B2's counts are set to 0 just before and read after the engine has
    gone idle."""
    import torch

    from seldon_tpu_torch.ops import flash_attention as fa
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    eng, cfg = s.engine, s.cfg
    rpa.launches = 0
    fa.reset_launches()
    before = eng.stats.snapshot()
    with contextlib.ExitStack() as stack, KeySpy(eng) as spy:
        for tap in taps:
            stack.enter_context(tap)
        with eng._book:
            qs = [eng.submit(r["prompt_token_ids"], s._to_sampling(r))
                  for r in reqs]
        t0 = time.perf_counter()
        streams = []
        for q in qs:
            toks = []
            while True:
                item = q.get(timeout=600)
                if item is None:
                    break
                if "error" in item:
                    raise AssertionError(f"a request failed: {item}")
                toks.extend(item["tokens"])
            streams.append(strip_eos(toks, cfg))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    wait_idle(eng)
    after = eng.stats.snapshot()
    n_tok = sum(len(t) for t in streams)
    return {"streams": streams, "keys": spy.keys, "wall_s": wall,
            "tokens": n_tok, "tokens_per_s": n_tok / wall,
            "launches_b1": rpa.launches, "launches_b2": fa.launches,
            "stats": {k: after[k] - before[k] for k in (
                "decode_dispatches", "prefill_waves",
                "cold_admit_dispatches", "admit_dispatches")}}


def profiled_obs_burst(s, reqs):
    """`obs_burst` under ``torch.profiler``: the device's idle share of
    the burst and the host's stream syncs, beside the roof ledger's
    device_frac over the same boundaries (its step sums before and
    after)."""
    from torch.profiler import ProfilerActivity, profile

    roof0 = s.engine.debug_roof()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    res = obs_burst(s, reqs, taps=(prof,))
    busy_ms, _, _ = device_breakdown(prof)
    syncs = sum(e.count for e in prof.key_averages() if e.key in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize"))
    out = {"wall_ms": res["wall_s"] * 1e3, "device_busy_ms": busy_ms,
           "device_idle_share": 1.0 - busy_ms / (res["wall_s"] * 1e3),
           "host_stream_syncs": syncs}
    roof1 = s.engine.debug_roof()
    if roof0 is not None:
        wall = roof1["step"]["wall_ms"] - roof0["step"]["wall_ms"]
        out["roof_device_frac"] = (
            roof1["step"]["device_ms"] - roof0["step"]["device_ms"]) / wall
        out["roof_host_frac"] = (
            roof1["step"]["host_pre_ms"] + roof1["step"]["host_post_ms"]
            - roof0["step"]["host_pre_ms"]
            - roof0["step"]["host_post_ms"]) / wall
    return out


def fetch_debug(s):
    """Every /debug/* payload of the unit, over REST from the port's
    wrapper app on a background loop: {kind: (status, json)}."""
    from seldon_tpu_torch.runtime import wrapper

    rest = RestThread(wrapper.build_rest_app(s))
    try:
        out = {}
        for kind in (*DEBUG_SCHEMA, "health"):
            status, raw = http_get(rest.port, f"/debug/{kind}")
            out[kind] = (status, json.loads(raw))
        return out
    finally:
        rest.close()


def param_bytes(params):
    seen, total = set(), 0
    for t in (*params.parameters(), *params.buffers()):
        if id(t) not in seen:
            seen.add(id(t))
            total += t.numel() * t.element_size()
    return total


def obs_plain_checks(name, s, reqs):
    """One more burst on the armed server under KernelTap (the ragged
    leg: B1 against ``partials_sparse``) or FlashTap (the bucketed leg: B2
    against ``flash_blockwise``), on this phase's own inputs."""
    n_layers = s.cfg.n_layers
    if name == "ragged":
        tap = KernelTap(n_layers)
        obs_burst(s, reqs, taps=(tap,))
        bad = {leg: e for leg, e in tap.errs.items()
               if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
        if not sum(tap.checked.values()) or bad:
            raise AssertionError(f"B1 against its plain version on the "
                                 f"phase's inputs: checked {tap.checked}, "
                                 f"beyond tolerance {bad}")
        return {"b1_checked": dict(tap.checked),
                "b1_errors": {k: list(v) for k, v in tap.errs.items()}}
    tap = FlashTap(n_layers)
    obs_burst(s, reqs, taps=(tap,))
    bad = [c for c in tap.checks if not c["ok"]]
    if not tap.checks or bad:
        raise AssertionError(f"B2 against its plain version on the "
                             f"phase's inputs: {bad[:3]}")
    return {"b2_checked": len(tap.checks),
            "b2_max_abs_err": max(c["max_abs_err"] for c in tap.checks)}


def phase_observatory(srv, reqs, toks, dev):
    """The engine's observatory at llama3-8b full width and depth, bf16,
    on phase 4's weights and 8 requests, through ``TorchServer`` with
    every ledger armed (``FLIGHT_RECORDER``, ``COMPILE_LEDGER``,
    ``DISPATCH_TIMING``, ``HBM_LEDGER``, ``SCHED_LEDGER``, ``ROOF_LEDGER``,
    ``PILOT=hold``) against the same server with none, each with its
    lattice warmed (``warmup=1``):
     (1) the ragged burst on B1 (``ragged=1, ragged_kernel="pallas"``, the
         dispatch budget set to the raw path's 32 x 128 tokens: the
         pilot's neutral budget is one chunk otherwise, as in the JAX
         controller);
     (2) the bucketed burst on B2 (``paged_kv=1``, ``attn_impl="flash"``).
    Gates, for each: the dispatched key sequence (KeySpy) equal with the
    ledgers on and off, and the greedy streams bit-equal; every
    ``/debug/{timeline,compile,hbm,sched,pilot,roof}`` payload, fetched
    over REST from the served unit, with the frozen key sets
    (``/debug/health`` answers 404 until the supervisor is ported);
    ``live_retrace_count`` 0 after the warmup, every dispatched key in
    ``static_lattice()``; 0 sched and roof conservation breaches; the
    peak table's entry for this card (``source`` "table"); every
    variant's mfu and mbu <= 1.0; the HBM ledger's weights equal to the
    parameters' bytes and its total at most
    ``torch.cuda.memory_allocated()``; B1 launches = layers x wave legs
    and B2 launches = layers x cold admissions; B1 (ragged) and B2
    (bucketed) held to their plain versions on this phase's own inputs
    (KernelTap, FlashTap); the host's stream syncs of a profiled ragged
    burst no more with the ledgers on than off. Reported: tokens/s on
    and off (no claim), the roof totals and the ragged variant's row,
    the profiler's idle share beside the ledger's device_frac, the waste
    fractions, the load (warmup) seconds per server."""
    import torch

    from seldon_tpu_torch.servers import cost_model

    out = {}
    t_phase = time.perf_counter()
    greedy = slice(0, N_GREEDY)
    card = torch.cuda.get_device_name(dev)
    table = cost_model.match_peaks(card)
    ecfg = srv._engine_config(srv.cfg)
    chunk = ecfg.ragged_chunk or ecfg.prefill_chunk
    legs = {
        "ragged": (srv.cfg, dict(
            ragged=1, ragged_kernel="pallas",
            dispatch_token_budget=srv.max_slots * chunk)),
        "bucketed": (dataclasses.replace(srv.cfg, attn_impl="flash"),
                     dict(paged_kv=1)),
    }
    for name, (cfg, kw) in legs.items():
        servers, load_s = {}, {}
        try:
            for tag in ("off", "on"):
                servers[tag], load_s[tag] = obs_server(
                    srv, cfg, dev, tag == "on", **kw)
            # Timed bursts in turns on one card (OBS_TURNS: two turns keep
            # the script inside its time limit).
            runs = {"off": [], "on": []}
            for tag in OBS_TURNS:
                runs[tag].append(obs_burst(servers[tag], reqs))
            profile = ({tag: profiled_obs_burst(servers[tag], reqs)
                        for tag in ("off", "on")}
                       if name == "ragged" else None)
            s = servers["on"]
            debug = fetch_debug(s)
            static = set(s.engine.static_lattice())
            allocated = torch.cuda.memory_allocated(dev)
            res = obs_plain_checks(name, s, reqs)
        finally:
            for s in servers.values():
                s.stop()
            servers.clear()
            s = None
            gc.collect()
            torch.cuda.empty_cache()
        first = runs["off"][0]
        # (1) the same dispatches, the same streams.
        for tag, rs in runs.items():
            for r in rs:
                if r["keys"] != first["keys"]:
                    raise AssertionError(
                        f"{name} {tag}: dispatched keys differ from the "
                        f"first ledgers-off run's ({len(r['keys'])} against "
                        f"{len(first['keys'])})")
                if r["streams"][greedy] != first["streams"][greedy]:
                    raise AssertionError(f"{name} {tag}: a greedy stream "
                                         f"differs with the ledgers on")
        # (2) the payloads and their gates.
        for kind in DEBUG_SCHEMA:
            status, snap = debug[kind]
            if status != 200:
                raise AssertionError(f"{name}: /debug/{kind} answered "
                                     f"{status}: {snap}")
            check_schema(kind, snap)
        if debug["health"][0] != 404:
            raise AssertionError(f"/debug/health answered "
                                 f"{debug['health'][0]}")
        comp, sched = debug["compile"][1], debug["sched"][1]
        roof, hbm = debug["roof"][1], debug["hbm"][1]
        lattice = {e["key"] for e in comp["lattice"]}
        if comp["live_retrace_count"] or not comp["warmup_complete"] \
                or not lattice <= static:
            raise AssertionError(f"{name}: live retraces "
                                 f"{comp['live_retraces'][:3]}, keys "
                                 f"outside the lattice "
                                 f"{sorted(lattice - static)}")
        for led, snap in (("sched", sched), ("roof", roof)):
            if snap["conservation"]["breaches"]:
                raise AssertionError(f"{name}: {led} conservation: "
                                     f"{snap['conservation']}")
        if roof["peaks"]["source"] != "table" or table is None or (
                roof["peaks"]["tflops"], roof["peaks"]["gbs"]) != table:
            raise AssertionError(f"{name}: peaks {roof['peaks']} for "
                                 f"{card!r}, table entry {table}")
        over = [v["key"] for v in roof["variants"]
                if v["mfu"] > 1.0 or v["mbu"] > 1.0]
        if over:
            raise AssertionError(f"{name}: mfu or mbu above 1: {over}")
        want_w = param_bytes(srv.params)
        if hbm["categories"]["weights"]["bytes"] != want_w \
                or hbm["total_bytes"] > allocated:
            raise AssertionError(f"{name}: hbm weights "
                                 f"{hbm['categories']['weights']['bytes']}"
                                 f" (params {want_w}), total "
                                 f"{hbm['total_bytes']} > allocated "
                                 f"{allocated}")
        # (3) the kernels on the path.
        for tag, rs in runs.items():
            for r in rs:
                st = r["stats"]
                want_b1 = (cfg.n_layers * (st["decode_dispatches"]
                                           + st["prefill_waves"])
                           if name == "ragged" else 0)
                want_b2 = (cfg.n_layers * st["cold_admit_dispatches"]
                           if name == "bucketed" else 0)
                if (r["launches_b1"], r["launches_b2"]) != (want_b1,
                                                            want_b2):
                    raise AssertionError(
                        f"{name} {tag}: launches B1 {r['launches_b1']} B2 "
                        f"{r['launches_b2']}, want {want_b1} / {want_b2}")
        if profile and profile["on"]["host_stream_syncs"] > \
                profile["off"]["host_stream_syncs"]:
            raise AssertionError(f"host syncs rose with the ledgers on: "
                                 f"{profile}")
        tps = {t: [r["tokens_per_s"] for r in rs] for t, rs in runs.items()}
        res.update(
            load_s=load_s, tokens_per_s=tps,
            wall_s={t: [r["wall_s"] for r in rs] for t, rs in runs.items()},
            launches={t: {k: sum(r[f"launches_{k}"] for r in rs)
                          for k in ("b1", "b2")} for t, rs in runs.items()},
            dispatches=len(first["keys"]),
            sampled_streams_equal=all(r["streams"] == first["streams"]
                                      for rs in runs.values() for r in rs),
            greedy_equal_phase4=sum(
                a == b for a, b in zip(first["streams"][greedy],
                                       toks[greedy])),
            declared=comp["declared_variants"],
            dispatched_variants=comp["dispatched_variants"],
            warmup_coverage=comp["warmup_coverage"],
            compile_s_total=comp["compile_s_total"],
            peaks=roof["peaks"], roof_totals=roof["totals"],
            host_frac=roof["host_frac"], device_frac=roof["device_frac"],
            step=roof["step"], variants=roof["variants"],
            padding_waste_frac=sched["padding_waste_frac"],
            goodput_gap=sched["goodput_gap"],
            budget_utilization=sched["budget_utilization"],
            wait=sched["wait"],
            hbm={k: c["bytes"] for k, c in hbm["categories"].items()},
            hbm_total=hbm["total_bytes"], memory_allocated=allocated,
            hbm_gap=allocated - hbm["total_bytes"],
            pilot_knobs=debug["pilot"][1]["knobs"],
            timeline_records=debug["timeline"][1]["total_recorded"])
        if profile:
            res["profile"] = profile
        out[name] = res
        tot = roof["totals"]
        log(f"observatory {name}: tokens_per_s "
            + ", ".join(f"{t} {v:.1f}" for t in ("off", "on")
                        for v in tps[t])
            + f"; dispatches {len(first['keys'])} "
            f"equal on and off; greedy streams equal; load_s (warmup) on "
            f"{load_s['on']:.1f} off {load_s['off']:.1f}; declared "
            f"{comp['declared_variants']} variants, live retraces 0; "
            f"launches per burst B1 {first['launches_b1']} B2 "
            f"{first['launches_b2']}")
        log(f"observatory {name} roof: peaks {roof['peaks']} totals mfu "
            f"{tot['mfu']} mbu {tot['mbu']} device_ms {tot['device_ms']} "
            f"predicted_ms {tot['predicted_ms']}; host_frac "
            f"{roof['host_frac']} device_frac {roof['device_frac']}; "
            f"padding_waste_frac {sched['padding_waste_frac']} goodput_gap "
            f"{sched['goodput_gap']}")
        for v in roof["variants"]:
            log(f"observatory {name} variant {v['key']}: dispatches "
                f"{v['dispatches']} device_ms {v['device_ms']} "
                f"predicted_ms {v['predicted_ms']} mfu {v['mfu']} mbu "
                f"{v['mbu']} bound {v['bound']}")
        log(f"observatory {name} hbm: {res['hbm']} total "
            f"{hbm['total_bytes']} memory_allocated {allocated} gap "
            f"{allocated - hbm['total_bytes']}")
        for tag, p in (profile or {}).items():
            log(f"observatory ragged profile {tag}: device_idle_share "
                f"{p['device_idle_share']:.3f} host_stream_syncs "
                f"{p['host_stream_syncs']}"
                + (f" roof device_frac {p['roof_device_frac']:.3f} "
                   f"host_frac {p['roof_host_frac']:.3f}"
                   if "roof_device_frac" in p else ""))
    for kern in ("b1", "b2"):
        out[f"launches_{kern}"] = sum(out[n]["launches"][t][kern]
                                      for n in legs for t in ("on", "off"))
    out["seconds"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# Phases 10-12: int8 weights and W8A8, the sampling noise, MoE
# ---------------------------------------------------------------------------

# Rows and columns of each kept W8A8 product held to the int64 numpy
# product (numpy's integer product runs at ~0.1 GMAC/s on the host).
INT_MM_CHECK_ROWS, INT_MM_CHECK_COLS = 8, 1024
# Projections of one layer, in call order: wq, wk, wv, wo, w_gate, w_up,
# w_down.
QDOTS_PER_LAYER = 7


class IntMmTap:
    """Instrumentation of this script: while active, keeps on the card a
    copy of the int8 input and the s32 output of the W8A8 products of the
    first layer of the burst's first prefill leg and first decode leg (a
    wave leg calls the product QDOTS_PER_LAYER times per layer, in layer
    order, a captured wave's warm run and capture too; a leg of more than
    one query row a slot is a prefill leg). In a captured wave the copies
    are made after the replay (``on_host``). Copies on the card wait for
    nothing."""

    def __init__(self, n_layers, slots):
        self.leg = QDOTS_PER_LAYER * n_layers
        self.slots = slots
        self.calls = 0
        self.kept = []
        self.legs = {}  # leg kind -> products kept

    def __enter__(self):
        from seldon_tpu_torch.models import transformer

        self._mod, self._orig = transformer, transformer._int_mm

        def keep(xq, w, y):
            kind = "decode" if xq.shape[0] <= self.slots else "prefill"
            n = self.legs.get(kind, 0)
            if n < QDOTS_PER_LAYER:
                self.legs[kind] = n + 1
                self.kept.append((xq.clone(), w, y.clone()))

        def tapped(xq, w):
            y = self._orig(xq, w)
            if self.calls % self.leg < QDOTS_PER_LAYER:  # layer 0
                on_host(functools.partial(keep, xq, w, y))
            self.calls += 1
            return y

        transformer._int_mm = tapped
        recapture()
        return self

    def __exit__(self, *exc):
        self._mod._int_mm = self._orig
        recapture()

    def check(self):
        """Each kept output at a spread of rows and columns against the
        int64 numpy product of the same int8 rows and weight columns, bit
        for bit. Returns (products, elements) checked."""
        import numpy as np

        n_el = 0
        for xq, w, y in self.kept:
            M, N = y.shape
            rows = np.unique(np.linspace(0, M - 1, min(
                M, INT_MM_CHECK_ROWS)).astype(np.int64))
            cols = np.unique(np.linspace(0, N - 1, min(
                N, INT_MM_CHECK_COLS)).astype(np.int64))
            a = xq[rows].cpu().numpy().astype(np.int64)
            b = w[:, cols].cpu().numpy().astype(np.int64)
            got = y[rows][:, cols].cpu().numpy().astype(np.int64)
            if not np.array_equal(got, a @ b):
                raise AssertionError(
                    f"torch._int_mm on the card differs from the int64 "
                    f"product ({M}x{xq.shape[1]} @ {xq.shape[1]}x{N}): "
                    f"{int((got != a @ b).sum())} of {got.size} elements")
            n_el += got.size
        return len(self.kept), n_el


def int_mm_layouts(params, dev):
    """``torch._int_mm`` on the served W8A8 weights (stored column-major)
    against a row-major copy of the same weight and against the bf16
    product of the same shape, at the burst's decode (32 rows) and
    prefill (4096 rows) shapes, CUDA-event means. The layout decides
    which cuBLASLt kernel runs (``quantize.set_quantized``)."""
    import torch

    from seldon_tpu_torch.models import transformer

    bp = params.blocks[0]
    out = []
    for name in ("wq", "w_gate", "w_down"):
        w = getattr(bp, name)
        K, N = w.shape
        w_row = w.contiguous()
        wb = torch.randn(K, N, device=dev, dtype=torch.bfloat16)
        for M in (32, 4096):
            x = torch.randint(-127, 128, (M, K), dtype=torch.int8,
                              device=dev)
            xb = torch.randn(M, K, device=dev, dtype=torch.bfloat16)
            row = {"weight": name, "M": M, "K": K, "N": N,
                   "served_col_major": w.stride() == (1, K)}
            row["ms"] = cuda_time_ms(lambda: torch._int_mm(x, w), 20, 3)
            row["row_major_ms"] = cuda_time_ms(
                lambda: torch._int_mm(x, w_row), 20, 3)
            row["bf16_ms"] = cuda_time_ms(lambda: xb @ wb, 20, 3)
            if not torch.equal(transformer._int_mm(x, w),
                               torch._int_mm(x, w_row)):
                raise AssertionError("int8 products differ by layout")
            out.append(row)
            log(f"int_mm {name} M={M} K={K} N={N}: served (column-major) "
                f"{row['ms']:.4f} ms, row-major {row['row_major_ms']:.4f} "
                f"ms, bf16 product {row['bf16_ms']:.4f} ms")
    return out


def weight_bytes(params) -> int:
    return sum(t.numel() * t.element_size() for t in (
        *params.parameters(), *params.buffers()))


def check_weight_codes(bf16_params, q_params):
    """Layer 0's int8 codes and scales as quantized on the card (the
    served model) against ``quantize._quantize_leaf`` of the same bf16
    weights on the CPU, bit for bit. Returns the elements compared."""
    import torch

    from seldon_tpu_torch.models import quantize

    bp, qp = bf16_params.blocks[0], q_params.blocks[0]
    n = 0
    for name in quantize._BLOCK_WEIGHTS:
        q_cpu, s_cpu = quantize._quantize_leaf(getattr(bp, name).cpu())
        q_card = getattr(qp, name).cpu()
        s_card = getattr(qp, f"{name}_scale").cpu()
        if not (torch.equal(q_card, q_cpu)
                and torch.equal(s_card.view(torch.int32),
                                s_cpu.view(torch.int32))):
            raise AssertionError(
                f"{name}: int8 codes or scales quantized on the card differ "
                f"from the CPU's ({int((q_card != q_cpu).sum())} codes, "
                f"{int((s_card != s_cpu).sum())} scales)")
        n += q_cpu.numel() + s_cpu.numel()
    return n


def phase_int8(srv, reqs, bf16_kernel, dev):
    """The same seeded llama3-8b weights served with int8 weights: a
    ``TorchServer(weight_dtype="int8")`` quantizes them on the card at
    load, then the 8 requests of phase 4 go through the ragged wave on
    B1's kernel leg; once weight-only (``act_dtype="bf16"``: the
    projections multiply the dequantized bf16 weights), once W8A8
    (``act_dtype="int8"``: s8 x s8 -> s32 ``torch._int_mm``). Per mode:
    load time, weight bytes on the card, tokens/s, mean TTFT, waves, B1
    and ``_int_mm`` launches, and the 6 greedy requests once more under
    LogitTap and KernelTap.

    Gates: B1 launches = layers x wave legs and ``_int_mm`` launches =
    7 x layers x wave legs (W8A8; 0 weight-only); layer 0's codes and
    scales quantized on the card equal the CPU's bit for bit; the kept
    W8A8 products of layer 0 equal the int64 numpy product bit for bit;
    on the greedy run, B1 agrees with its plain version on this path's
    own inputs within the phase-3 tolerances; (b) of phase 5c on these
    weights cut to CUT_LAYERS, captured against eager bit for bit
    (``captured_pair``). Reported only: the median |logit diff| against
    the bf16 kernel leg at full depth (phase 6)."""
    import gc

    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.torchserver import TorchServer

    out = {}
    for mode, act in (("int8", "bf16"), ("w8a8", "int8")):
        q = TorchServer(preset="llama3-8b", max_slots=32, max_seq_len=2048,
                        ragged=1, ragged_kernel="pallas", init_seed=0,
                        weight_dtype="int8", act_dtype=act, device=dev)
        t0 = time.perf_counter()
        q.load()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cfg = q.cfg
        if (cfg.weight_dtype, cfg.act_dtype) != ("int8", act):
            raise AssertionError(f"{mode}: served config {cfg.weight_dtype}"
                                 f"/{cfg.act_dtype}")
        res = {"load_s": load_s, "weight_bytes": weight_bytes(q.params),
               "bf16_weight_bytes": weight_bytes(srv.params)}
        if mode == "int8":
            res["codes_checked"] = check_weight_codes(srv.params, q.params)
        rpa.launches = 0  # count only this burst's launches
        transformer.int_mm_launches = 0
        imm = IntMmTap(cfg.n_layers, q.max_slots)
        with imm if act == "int8" else contextlib.nullcontext():
            results, wall = run_concurrent(q.generate, reqs, timeout_s=600)
            if not q.engine.drain(timeout=60):
                raise AssertionError("engine did not go idle")
        launches, int_mm = rpa.launches, transformer.int_mm_launches
        snap = q.engine.stats.snapshot()
        q.stop()
        waves, pw = snap["decode_dispatches"], snap["prefill_waves"]
        legs = waves + pw
        toks = [r["token_ids"] for r in results]
        if any(not t for t in toks) or any(
                not 0 <= x < cfg.vocab_size for t in toks for x in t):
            raise AssertionError(f"{mode}: a request returned no or bad "
                                 f"tokens")
        if launches != cfg.n_layers * legs:
            raise AssertionError(f"{mode}: B1 launches {launches} != layers "
                                 f"x legs {cfg.n_layers * legs}")
        want_mm = QDOTS_PER_LAYER * cfg.n_layers * legs if act == "int8" \
            else 0
        if int_mm != want_mm:
            raise AssertionError(f"{mode}: _int_mm launches {int_mm} != "
                                 f"{want_mm}")
        if act == "int8":
            res["int_mm_layouts"] = int_mm_layouts(q.params, dev)
            res["int_mm_checked"] = imm.check()
            if res["int_mm_checked"][0] != 2 * QDOTS_PER_LAYER:
                raise AssertionError(f"kept {res['int_mm_checked'][0]} "
                                     f"W8A8 products, not 14")
        n_tok = sum(len(t) for t in toks)
        res.update(waves=waves, prefill_waves=pw, launches=launches,
                   int_mm_launches=int_mm, tokens=n_tok, wall_s=wall,
                   tokens_per_s=n_tok / wall,
                   mean_ttft_ms=snap["mean_ttft_ms"])
        log(f"serve {mode} (weights int8, activations {act}) load_s="
            f"{load_s:.1f} weight_bytes={res['weight_bytes']} (bf16 "
            f"{res['bf16_weight_bytes']}) waves={waves} prefill_waves={pw} "
            f"B1_launches={launches} int_mm_launches={int_mm} tokens={n_tok}"
            f" wall_s={wall:.3f} tokens_per_s={n_tok / wall:.1f} "
            f"mean_ttft_ms={snap['mean_ttft_ms']:.1f}"
            + (f" codes_checked={res['codes_checked']}" if mode == "int8"
               else f" int_mm_checked(products, elements)="
                    f"{res['int_mm_checked']}"))
        ecfg = q.engine.ecfg
        q.engine = None
        gc.collect()
        torch.cuda.empty_cache()
        # (b): captured against eager on these weights cut to CUT_LAYERS.
        res["captured"] = captured_pair(
            f"{mode} ({CUT_LAYERS} layers)",
            *shallow(q.params, cfg, CUT_LAYERS), ecfg, dev, reqs,
            q._to_sampling)
        gc.collect()
        torch.cuda.empty_cache()
        tap = KernelTap(cfg.n_layers)
        with tap:
            st, rows, _ = run_engine(q.params, cfg, ecfg, dev,
                                     reqs[:N_GREEDY], q._to_sampling)
        res["vs_bf16"] = compare_legs(
            reqs[:N_GREEDY], f"{mode} vs bf16 (kernel leg, full depth)",
            (st, rows), bf16_kernel)
        bad = {leg: e for leg, e in tap.errs.items()
               if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
        if bad or min(tap.checked.values()) == 0:
            raise AssertionError(f"{mode}: B1 disagrees with its plain "
                                 f"version on this path's inputs or was "
                                 f"not checked: {tap.errs} {tap.checked}")
        res["tap"] = {"checked": tap.checked, "errors": tap.errs}
        log(f"{mode}: B1 on this path's own inputs, "
            + "; ".join(f"{leg} {tap.checked[leg]} launches checked, err "
                        f"m={e[0]:.3g} l_rel={e[1]:.3g} acc/l={e[2]:.3g}"
                        for leg, e in sorted(tap.errs.items())))
        out[mode] = res
        del q, st, rows
        gc.collect()
        torch.cuda.empty_cache()
    return out


TP_DEVICES = ("cuda:0", "cuda:0")  # two ranks sharing the one card
TP_TINY_MODES = {
    "dense": {},
    "paged": dict(paged_kv=True, kv_block=16, kv_pool_blocks=12,
                  prompt_buckets=(16, 32)),
    "chunked": dict(chunked_prefill=True, prefill_chunk=8, prefix_block=8),
    "ragged": dict(paged_kv=True, chunked_prefill=True, prefill_chunk=8,
                   prefix_block=8, kv_block=8, ragged=True,
                   ragged_kernel="pallas"),
    "spec": dict(spec_decode=True, spec_k=2, paged_kv=True, kv_block=8,
                 prefix_block=8, ragged_kernel="pallas"),
}
TP_TINY_PROMPTS = [list(range(2, 2 + n)) for n in (5, 12, 24, 7)]
TP_WEIGHT_BYTES = 11_497_652_224  # llama3-8b at tp = 2, per rank
RING_S = 4096
# 9l (c): the ring's median |logit diff| against "xla" at most this many
# times what a one-ulp embedding nudge moves "xla" (both medians over the
# same 4096 positions): the nudge floor, with 10% for the spread of a
# ratio of two such medians (phase 5's and 6's ratios of like pairs read
# 0.986-0.999 on the H100).
RING_DRIFT_MAX = 1.1
# Phase 9j's burst at a quarter of its new tokens: each of tp = 2's 64
# staged gathers per wave leg waits on the other rank's share of the one
# card (PERF.md, phase 9l), and the phase has ~90 s on the slowest host.
TP_MAX_NEW = 8
# One decode row, the burst's decode and prefill rows: the sliced-GEMM
# gate's row counts.
TP_GEMM_M = (1, 32, 1527)
TP_GEMM_REPS = 20  # timed calls per full projection and route
# 9l (d): the dense prefix burst's depth and new tokens.
TP_PREFIX_LAYERS = 4
TP_PREFIX_NEW = 8
# 9l (f): the paths of C18 (i) at full width and this depth: the sparse
# ragged leg and the spec engine's masked and kernel verify legs.
TP_F_LAYERS = 4
TP_F_MODES = (("sparse", dict(ragged_kernel="sparse")),
              ("spec-masked", dict(ragged=False, chunked_prefill=False,
                                   spec_decode=True, spec_k=4,
                                   ragged_kernel="masked")),
              ("spec-kernel", dict(ragged=False, chunked_prefill=False,
                                   spec_decode=True, spec_k=4,
                                   ragged_kernel="pallas")))
# 9l (f)'s report: the head-batched products of the sparse walk and of
# both verify bodies at llama3-8b's 8 KV heads x 4, 32 slots, kv_block 16
# (a prefill chunk of 128 rows, spec_k 4, a 2048-position window): name,
# equation, the two operands' shapes, and the head dim of each operand
# and of the output.
TP_HEAD_PRODUCTS = (
    ("walk scores, decode", "bskgd,bktd->bkgst", (32, 1, 8, 4, 128),
     (32, 8, 16, 128), 2, 1, 1),
    ("walk scores, verify", "bskgd,bktd->bkgst", (32, 5, 8, 4, 128),
     (32, 8, 16, 128), 2, 1, 1),
    ("walk scores, prefill", "bskgd,bktd->bkgst", (32, 128, 8, 4, 128),
     (32, 8, 16, 128), 2, 1, 1),
    ("walk values, decode", "bkgst,bktd->bkgsd", (32, 8, 4, 1, 16),
     (32, 8, 16, 128), 1, 1, 1),
    ("walk values, prefill", "bkgst,bktd->bkgsd", (32, 8, 4, 128, 16),
     (32, 8, 16, 128), 1, 1, 1),
    ("sparse suffix values, prefill", "bkgst,bktd->bkgsd",
     (32, 8, 4, 128, 128), (32, 8, 128, 128), 1, 1, 1),
    ("sparse fresh values, decode", "bkgsu,bukd->bkgsd", (32, 8, 4, 1, 1),
     (32, 1, 8, 128), 1, 2, 1),
    ("masked verify scores", "bskgd,bktd->bkgst", (32, 5, 8, 4, 128),
     (32, 8, 2048, 128), 2, 1, 1),
    ("masked verify values", "bkgst,bktd->bskgd", (32, 8, 4, 5, 2048),
     (32, 8, 2048, 128), 1, 1, 2),
    ("verify diagonal scores", "bskgd,bskd->bkgs", (32, 5, 8, 4, 128),
     (32, 5, 8, 128), 2, 2, 1),
    ("masked verify diagonal values", "bkgs,bskd->bskgd", (32, 8, 4, 5),
     (32, 5, 8, 128), 1, 2, 2),
    ("verify suffix scores", "bskgd,bukd->bkgsu", (32, 5, 8, 4, 128),
     (32, 5, 8, 128), 2, 2, 1),
    ("verify suffix values", "bkgsu,bukd->bkgsd", (32, 8, 4, 5, 5),
     (32, 5, 8, 128), 1, 2, 1),
)
# 9l (e): TorchServer(tp=2)'s engine and its few greedy tokens.
TP_BUILD_SLOTS, TP_BUILD_SEQ = 4, 1024
TP_BUILD_REQUESTS, TP_BUILD_NEW = 3, 4
TP_BUILD_SLACK = 1.05  # on rank 0's peak: its shard + one f32 draw


def tp_gemm_slices(dev):
    """In-process: for each rank's column half of llama3-8b's sharded
    projections (K 4096; N 4096, 1024, 1024, 14336, 14336) at TP_GEMM_M
    rows, the outputs that differ from the same columns of the full
    product through the port's projection GEMM (``ops/lt_gemm.matmul``,
    the full width's pinned algorithm: the gate) and through
    ``torch.matmul`` (reported, with the kernels the profiler names for
    the full and the half product where any differ; ROADMAP.md C18);
    and each full product's ms per call by either route (CUDA events
    around TP_GEMM_REPS calls, host launch cost included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_tpu_torch.ops import lt_gemm

    def kernels(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            fn()
            torch.cuda.synchronize()
        return sorted({e.key for e in p.key_averages()
                       if e.device_time_total > 0 and "copy" not in e.key})

    def ms(fn):
        fn()
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(TP_GEMM_REPS):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / TP_GEMM_REPS

    g = torch.Generator(device=dev).manual_seed(0)
    out = {"differ": {}, "torch_differ": {}, "outputs": {}, "kernels": {},
           "algorithms": {}, "ms": {}}
    for M in TP_GEMM_M:
        x = (torch.randn(M, 4096, generator=g, device=dev) * 0.5).to(
            torch.bfloat16)
        for name, N in (("wq", 4096), ("wk", 1024), ("wv", 1024),
                        ("w_gate", 14336), ("w_up", 14336)):
            w = (torch.randn(4096, N, generator=g, device=dev) * 0.02).to(
                torch.bfloat16)
            out["algorithms"][f"{name} M={M}"] = lt_gemm.algorithm(
                M, 4096, N // 2, N)
            out["ms"][f"{name} M={M}"] = {
                "lt_gemm": ms(lambda: lt_gemm.matmul(x, w)),
                "torch": ms(lambda: torch.matmul(x, w))}
            for path, mm in (("differ", lt_gemm.matmul),
                             ("torch_differ", torch.matmul)):
                full = mm(x, w)
                for r in range(2):
                    cols = slice(r * N // 2, (r + 1) * N // 2)
                    part = w[:, cols].contiguous()
                    key = f"{name} M={M} rank {r}"
                    out["outputs"][key] = M * N // 2
                    half = (lt_gemm.matmul(x, part, N)
                            if path == "differ" else x @ part)
                    out[path][key] = int((half != full[:, cols]).sum())
                    if path == "torch_differ" and out[path][key]:
                        out["kernels"][key] = {
                            "full": kernels(lambda: x @ w),
                            "half": kernels(lambda: x @ part)}
    return out


TP_PAD_REPS = 20  # timed calls per attention product and form


def pad_measure(fn):
    """ms per call of ``fn`` (CUDA events around TP_PAD_REPS calls) and
    the peak bytes allocated beyond what was allocated before them."""
    import torch

    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(TP_PAD_REPS):
        fn()
    b.record()
    b.synchronize()
    return {"ms": a.elapsed_time(b) / TP_PAD_REPS,
            "peak_extra_bytes": torch.cuda.max_memory_allocated() - base}


def dp_pad_cost(cfg, dev):
    """What a dp = 2 replica's dense decode attention costs with its
    products batched over the slots padded to the whole batch (a
    report): ``gqa_attention_decode`` at phase 4's 32 slots x 2048
    positions with llama3-8b's heads, per call (``pad_measure``): the
    whole batch (dp = 1's call), a replica's 16 slots inside
    ``lt_gemm.row_share(16, 32)`` (padded, as served) and the same 16
    slots outside it (unpadded), and whether each form's rows equal the
    whole batch's; and for each of its four f32 products batched over
    the slots (the scores over the cache, the fresh column's scores, the
    weights over the cache's V, the fresh column's V), whether a dp = 2
    and a dp = 4 replica's rows equal the whole batch's, unpadded."""
    import torch

    from seldon_tpu_torch.models import transformer as tf
    from seldon_tpu_torch.ops import lt_gemm

    H, Hkv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    B, T, h = 32, 2048, 16
    g = torch.Generator(device=dev).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    args = (rnd(B, 1, H, Dh), rnd(B, Hkv, T, Dh), rnd(B, Hkv, T, Dh),
            rnd(B, 1, Hkv, Dh), rnd(B, 1, Hkv, Dh))
    pos = torch.randint(1, T, (B,), generator=g, device=dev)
    args += (torch.arange(T, device=dev)[None, None, :]
             < pos[:, None, None],)
    mine = tuple(t[:h] for t in args)

    def padded():
        with lt_gemm.row_share(h, B):
            return tf.gqa_attention_decode(*mine)

    forms = {"whole": lambda: tf.gqa_attention_decode(*args),
             "padded": padded,
             "unpadded": lambda: tf.gqa_attention_decode(*mine)}
    out = {tag: pad_measure(fn) for tag, fn in forms.items()}
    whole = forms["whole"]()[:h]
    for tag in ("padded", "unpadded"):
        out[tag]["rows_equal_whole"] = bool(torch.equal(forms[tag](), whole))
    G = H // Hkv
    q, ck, cv, kf, vf = (t.float() for t in args[:5])
    qr = q.reshape(B, 1, Hkv, G, Dh)
    w = torch.softmax(torch.randn(B, Hkv, G, 1, T, generator=g, device=dev),
                      -1)
    pf = torch.rand(B, Hkv, G, 1, 1, generator=g, device=dev)
    products = {"scores": ("bskgd,bktd->bkgst", qr, ck),
                "fresh_scores": ("bskgd,bukd->bkgsu", qr, kf),
                "weights_v": ("bkgst,bktd->bskgd", w, cv),
                "fresh_v": ("bkgsu,bukd->bskgd", pf, vf)}
    out["products_rows_equal_unpadded"] = {
        f"dp{B // m}": {name: bool(torch.equal(
            torch.einsum(eq, a, b)[:m], torch.einsum(eq, a[:m], b[:m])))
            for name, (eq, a, b) in products.items()}
        for m in (h, h // 2)}
    log(f"dp padding, a dp = 2 replica's dense decode attention at {B} "
        f"slots x {T}: " + ", ".join(
            f"{tag} {m['ms']:.4f} ms, peak +{m['peak_extra_bytes']} B"
            + (f", rows equal the whole batch's {m['rows_equal_whole']}"
               if "rows_equal_whole" in m else "")
            for tag, m in out.items() if tag in forms)
        + f"; each product's replica rows unpadded equal to the whole "
        f"batch's {out['products_rows_equal_unpadded']}; {card_line()}")
    return out


def tp_pad_cost(cfg, dev):
    """What running the attention at tp = 1's head count costs rank 0 of
    tp = 2 (a report): per call, ms (CUDA events around TP_PAD_REPS
    calls) and the peak bytes allocated beyond the inputs, with the
    padding (``TpHints.pad_heads``) and without it (the same call on the
    rank's heads alone), for the dense decode (``gqa_attention_decode``
    at 9l (d)'s 8 slots x 2048 positions) and the ragged wave's fresh
    scores and combine (``ragged_attention._fresh_scores`` /
    ``_combine_fresh`` at a 1527-row prefill wave cut into 12 rows of
    128 and at a 32-row decode wave)."""
    import types

    import torch

    from seldon_tpu_torch.models import ragged_attention, tp_sharding
    from seldon_tpu_torch.models import transformer as tf

    hints = tp_sharding.TpHints(group=types.SimpleNamespace(rank=0), tp=2)
    H, Hkv, Dh = cfg.n_heads // 2, cfg.n_kv_heads // 2, cfg.head_dim
    G = H // Hkv
    g = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    B, T = 8, 2048
    q, ck, cv = rnd(B, 1, H, Dh), rnd(B, Hkv, T, Dh), rnd(B, Hkv, T, Dh)
    kf, vf = rnd(B, 1, Hkv, Dh), rnd(B, 1, Hkv, Dh)
    lt = torch.ones(B, 1, T, dtype=torch.bool, device=dev)
    cases = {"dense decode B8 T2048": {
        tag: (lambda tp=tp: tf.gqa_attention_decode(q, ck, cv, kf, vf, lt,
                                                    tp=tp))
        for tag, tp in (("padded", hints), ("unpadded", None))}}
    for label, (Bw, S) in (("ragged prefill 12x128", (12, 128)),
                           ("ragged decode 32x1", (32, 1))):
        qr, k = rnd(Bw, S, Hkv, G, Dh), rnd(Bw, S, Hkv, Dh)
        parts = (rnd(Bw, Hkv, G, S, 1, dtype=torch.float32),
                 rnd(Bw, Hkv, G, S, 1, dtype=torch.float32).abs() + 1,
                 rnd(Bw, Hkv, G, S, Dh, dtype=torch.float32))
        vt = rnd(Bw, Hkv, S, Dh)
        eq = "bskgd,btkd->bkgst"

        def fresh(tp, qr=qr, k=k, parts=parts, vt=vt):
            s_f = ragged_attention._fresh_scores(eq, qr, k, tp)
            return ragged_attention._combine_fresh(parts, s_f, vt, tp)

        cases[label] = {"padded": lambda f=fresh: f(hints),
                        "unpadded": lambda f=fresh: f(None)}
    out = {}
    for label, forms in cases.items():
        out[label] = {tag: pad_measure(fn) for tag, fn in forms.items()}
        if not torch.equal(forms["padded"](), forms["unpadded"]()):
            out[label]["equal"] = False
        log(f"tp head padding, rank 0, {label}: "
            + ", ".join(f"{tag} {m['ms']:.4f} ms, peak +{m['peak_extra_bytes']} B"
                        for tag, m in out[label].items()
                        if isinstance(m, dict))
            + ("" if out[label].get("equal", True)
               else " (padded and unpadded results differ)"))
    return out


def tp_worker_tap(worker, n_layers):
    """Run on a worker rank: hold B1's launches on the checked layers to
    the plain version (KernelTap) until tp_worker_untap."""
    worker.tap = KernelTap(n_layers).__enter__()


def tp_worker_untap(worker):
    tap = worker.tap
    tap.__exit__(None, None, None)
    del worker.tap
    return {"checked": tap.checked, "errors": tap.errs}


def tp_worker_launches(worker, reset=False):
    """Run on a worker rank: its B1 launch count (then zeroed)."""
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    n = rpa.launches
    if reset:
        rpa.launches = 0
    return n


class WaveTap(LogitTap):
    """LogitTap that also records which sampling call (a wave leg) saw
    each row (counted on the host: at every replay of a captured wave)."""

    def __enter__(self):
        super().__enter__()
        self.wave_of = {}
        self.calls = 0
        tapped = self._mods[0].sample_per_row

        def counted(logits, seeds, positions, *rest):
            def record():
                for sd, ps in zip(seeds.tolist(), positions.tolist()):
                    if sd in self.seeds:
                        self.wave_of[(sd, ps)] = self.calls
                self.calls += 1
            on_host(record)
            return tapped(logits, seeds, positions, *rest)

        for mod in self._mods:
            mod.sample_per_row = counted
        return self


def tp_engine_burst(eng, reqs, to_sampling, tap=False, split=0):
    """Phase 9j's fixed schedule on ``eng``: every request queued before
    the first wave, the synchronous loop; with ``split`` the first
    ``split`` requests alone first (a prefix cache's primer). Returns
    (streams, WaveTap or None, wall seconds, stats)."""
    with (WaveTap([r["seed"] for r in reqs]) if tap
          else contextlib.nullcontext()) as wt:
        eng.start()
        try:
            t0 = time.perf_counter()
            results = [] if not split else submit_all(eng, reqs[:split],
                                                      to_sampling)
            results += submit_all(eng, reqs[split:], to_sampling)
            wall = time.perf_counter() - t0
            errs = [e for _, e in results if e]
            if errs:
                raise AssertionError(f"tp: error items {errs}")
            if hasattr(eng, "check_replicas"):
                eng.check_replicas()
            stats = eng.stats.snapshot()
        finally:
            eng.stop()
    return [t for t, _ in results], wt, wall, stats


def tp_wave_diffs(reqs, a, b):
    """Per wave leg of run ``b`` (tp=1): the share of bit-equal logits
    and the max |a - b| over the rows both runs sampled with the same
    context (every request's tokens up to and including its first
    divergence), and each wave's median row max |a - b|."""
    import torch

    (a_st, ta), (b_st, tb) = a, b
    waves = {}
    for i, req in enumerate(reqs):
        got, want = a_st[i], b_st[i]
        k = next((j for j, (x, y) in enumerate(zip(got, want)) if x != y),
                 min(len(got), len(want)))
        plen, seed = len(req["prompt_token_ids"]), req["seed"]
        for j in range(min(k + 1, len(got), len(want))):
            key = (seed, plen + j)
            ra, rb = ta.rows[key], tb.rows[key]
            w = waves.setdefault(tb.wave_of[key], [0, 0, []])
            w[0] += int((ra == rb).sum())
            w[1] += rb.numel()
            w[2].append(float((ra - rb).abs().max()))
    out = []
    for wave in sorted(waves):
        eq, n, d = waves[wave]
        out.append({"wave": wave, "rows": len(d), "bit_equal_share": eq / n,
                    "max_abs_diff": max(d),
                    "median_row_max_diff": float(torch.tensor(d).median())})
    return out


def phase_tp_tiny(group, dev):
    """9l (a): tiny on the two ranks, every engine family (the JAX
    package's MODES, ragged and spec on B1's kernel leg) plus int8 KV on
    the ragged wave and W8A8 on the dense slab: greedy streams at tp = 2
    equal to tp = 1's."""
    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.models.quantize import quantize_params
    from seldon_tpu_torch.models.sampling import SamplingParams
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine
    from seldon_tpu_torch.servers.mesh_engine import MeshEngine

    base = get_config("tiny")
    cases = [(m, base, kw) for m, kw in TP_TINY_MODES.items()]
    cases.append(("int8-kv", dataclasses.replace(base, kv_cache_dtype="int8"),
                  TP_TINY_MODES["ragged"]))
    cases.append(("w8a8", dataclasses.replace(base, weight_dtype="int8",
                                              act_dtype="int8"), {}))
    greedy = SamplingParams(temperature=0.0, max_new_tokens=8)
    out = {}
    for name, cfg, kw in cases:
        params = transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
        if cfg.weight_dtype == "int8":
            params = quantize_params(params)
        ekw = dict(max_slots=4, max_seq_len=64, async_fetch=False, **kw)
        ekw.setdefault("prompt_buckets", (8, 32))
        streams = []
        for tp in (1, 2):
            eng = (MeshEngine(params, cfg, EngineConfig(**ekw), tp=2,
                              group=group) if tp == 2 else
                   InferenceEngine(params, cfg, EngineConfig(**ekw), dev))
            reqs = [{"prompt_token_ids": p, "seed": i}
                    for i, p in enumerate(TP_TINY_PROMPTS)]
            streams.append(tp_engine_burst(eng, reqs,
                                           lambda r: greedy)[0])
        out[name] = streams[0] == streams[1]
        if not out[name]:
            raise AssertionError(f"tp tiny {name}: tp=2 streams "
                                 f"{streams[1]} != tp=1 {streams[0]}")
    log(f"tp (a) tiny, tp=2 streams equal to tp=1: {out}")
    return out


def phase_tp(params, cfg, ecfg, reqs, to_sampling, legs, ckpt, dev):
    """9l: exact tensor parallelism on the card, after ``del srv``. Rank 0
    is this process; one spawned worker shares the card
    (``build_tp_mesh(2, ["cuda:0", "cuda:0"])``: gloo, each all-gather
    staged through host buffers; the weights reach the worker as CUDA IPC
    handles). Every process reports its GEMM settings
    (``device.configure_gemms``: at this script's start, by each worker
    at spawn). First, in this process, each rank's half of every
    column-sharded llama3-8b projection against the full GEMM at
    TP_GEMM_M rows (``tp_gemm_slices``): every output bit-equal (gate);
    and what the head padding costs rank 0's attention
    (``tp_pad_cost``, a report).
    (a) tiny (``phase_tp_tiny``). (b) llama3-8b at full width, phase 4's
    weights cut to CUT_LAYERS layers and its engine configuration (the
    pool cut to the burst's need),
    phase 9j's fixed-schedule 8-request burst (at TP_MAX_NEW new tokens)
    on B1's kernel leg at tp = 1 and at tp = 2, each under LogitTap,
    tp = 2 also under KernelTap on both ranks. Gates: 8 of 8 greedy
    streams equal and every wave's logits bit-equal to tp = 1's (share
    1.0); every worker's per-slot state equal to rank 0's; B1 on each
    rank held to its plain version on that rank's own inputs (phase 6's
    tap and tolerances) and launched layers x wave legs on each.
    Reported: the weights per device, the gather's route,
    count and host ms per wave, and tokens/s of both bursts (taps on; no
    claim: the gather is staged through host memory because the ranks
    share a card). (d) the dense prefix cache (``phase_tp_prefix``).
    (c) the same ranks laid out as an 'sp' axis (``phase_tp_ring``). The group
    closes, then (e) ``TorchServer(tp=2)`` builds each rank's shard on
    its rank (``phase_tp_build``), and (g) four ranks serve JAX's other
    plans (``phase_tp_plans``) against (b)'s tp = 1 run."""
    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers import mesh_engine
    from seldon_tpu_torch.servers.engine import InferenceEngine

    problems = []  # raised once every part of the phase has run
    prefix_one = {}  # 9l (d)'s tp = 1 run, (g2)'s dense prefix reference
    gemm = tp_gemm_slices(dev)
    differ = {k: v for k, v in gemm["differ"].items() if v}
    log(f"tp sliced GEMMs: {len(gemm['differ'])} column halves; through "
        f"the port's projection GEMM (algorithms {gemm['algorithms']}) "
        f"outputs unequal to the full product's columns at "
        f"{differ or 'none'}; through torch.matmul (report) at "
        f"{ {k: v for k, v in gemm['torch_differ'].items() if v} or 'none'}"
        f", kernels {gemm['kernels']} (of {gemm['outputs']})")
    log(f"tp projection ms per call (pinned lt_gemm / torch.matmul): "
        f"{ {k: (round(v['lt_gemm'], 4), round(v['torch'], 4)) for k, v in gemm['ms'].items()} }")
    if differ:
        problems.append(f"sliced GEMMs differ from the full GEMM's columns "
                        f"through the port's projection GEMM: {differ}")
    pad = tp_pad_cost(cfg, dev)
    group = None
    try:
        t0 = time.perf_counter()
        group = mesh_engine.spawn_group(
            mesh_engine.build_tp_mesh(2, TP_DEVICES))
        out = {"spawn_s": time.perf_counter() - t0,
               "route": group.ranks.route, "gemm_bit_equal_share": gemm,
               "pad_cost": pad,
               "worker_gemm_settings": group.gemms}
        log(f"tp group: {group.describe()} spawned in "
            f"{out['spawn_s']:.1f} s; worker GEMM settings {group.gemms}")
        t0 = time.perf_counter()
        out["tiny"] = phase_tp_tiny(group, dev)
        out["tiny_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        reqs = [dict(r, max_new_tokens=TP_MAX_NEW) for r in reqs]
        nudge = legs["depths"][CUT_LAYERS]["nudged_vs_masked"]
        floor, spread = nudge["median_logit_diff"], nudge["max_logit_diff"]
        # The burst's blocks (phase 4's pool would hold 32 full windows
        # per engine): 8 windows.
        ecfg = dataclasses.replace(
            ecfg, async_fetch=False,
            kv_pool_blocks=8 * (ecfg.max_seq_len // ecfg.kv_block) + 1)
        # Phase 9a's cut: the gathers, staged through host memory, cost
        # ~3 s a wave at 32 layers; (e) gates the full depth's shards.
        pb, cb = shallow(params, cfg, CUT_LAYERS)
        one = tp_engine_burst(InferenceEngine(pb, cb, ecfg, dev), reqs,
                              to_sampling, tap=True)
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        eng = mesh_engine.MeshEngine(pb, cb, ecfg, tp=2, group=group)
        out["setup_s"] = time.perf_counter() - t1
        info = eng.mesh_info()
        group.run(f"{__name__}:tp_worker_tap", cb.n_layers)
        rpa.launches = 0
        group.run(f"{__name__}:tp_worker_launches", True)
        group.ranks.reset_counters()
        with KernelTap(cb.n_layers) as tap0:
            two = tp_engine_burst(eng, reqs, to_sampling, tap=True)
        launches = [rpa.launches,
                    group.run(f"{__name__}:tp_worker_launches")[0]]
        tap1 = group.run(f"{__name__}:tp_worker_untap")[0]
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        st = two[3]
        n_waves = st["decode_dispatches"]
        want = cb.n_layers * (n_waves + st["prefill_waves"])
        waves = tp_wave_diffs(reqs, two[:2], one[:2])
        cmp = compare_legs(reqs, "tp=2 vs tp=1", (two[0], two[1].rows),
                           (one[0], one[1].rows))
        r = group.ranks
        out["b"] = {
            "floor": floor, "spread": spread, "waves": waves,
            "compare": cmp, "streams_equal": two[0] == one[0],
            "streams_equal_count": sum(a == b for a, b in zip(two[0],
                                                              one[0])),
            "launches_per_rank": launches, "launches_expected": want,
            "tap_rank0": {"checked": tap0.checked, "errors": tap0.errs},
            "tap_rank1": tap1, "mesh_info": info, "waves_run": n_waves,
            "gathers": r.gathers, "gather_ms_per_wave": 1e3 * r.gather_s
            / n_waves, "wait_ms_per_wave": 1e3 * r.wait_s / n_waves,
            "tokens_per_s_tp2": sum(map(len, two[0])) / two[2],
            "tokens_per_s_tp1": sum(map(len, one[0])) / one[2],
        }
        b = out["b"]
        log(f"tp (b) {cb.n_layers} layers, tp=2 vs tp=1: "
            f"{b['streams_equal_count']}/{len(reqs)} streams equal; per wave "
            f"bit-equal share "
            f"{[round(w['bit_equal_share'], 6) for w in waves]}; max |dlogit| "
            f"{[round(w['max_abs_diff'], 5) for w in waves]}; (phase 6's "
            f"nudge floor at {CUT_LAYERS} layers {floor:.4g}, spread "
            f"{spread:.4g}, for scale)")
        log(f"tp (b) B1 launches per rank {launches} (expected {want} each); "
            f"tap rank0 {tap0.checked} {tap0.errs}; rank1 {tap1}; weights "
            f"per device {info['weight_bytes_per_device']}; route "
            f"{info['route']}")
        log(f"tp (b) gathers {r.gathers} over {n_waves} waves: "
            f"{b['gather_ms_per_wave']:.2f} ms gather + "
            f"{b['wait_ms_per_wave']:.2f} ms waiting for the card per wave; "
            f"tokens/s (taps on) tp=2 {b['tokens_per_s_tp2']:.1f} tp=1 "
            f"{b['tokens_per_s_tp1']:.1f} (reported, no claim)")
        n_before = len(problems)
        if not b["streams_equal"]:
            problems.append(f"{b['streams_equal_count']}/{len(reqs)} greedy "
                            f"streams equal")
        over = [w for w in waves if w["bit_equal_share"] != 1.0]
        if over:
            problems.append(f"waves whose logits are not bit-equal to "
                            f"tp = 1's: {over}")
        if launches != [want, want]:
            problems.append(f"B1 launches per rank {launches} != {want}")
        for name, t in (("rank 0", {"checked": tap0.checked,
                                    "errors": tap0.errs}), ("rank 1", tap1)):
            if min(t["checked"].values()) == 0:
                problems.append(f"{name}: a wave leg had no checked launch")
            bad = {leg: e for leg, e in t["errors"].items()
                   if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
            if bad:
                problems.append(f"{name}: B1 disagrees with its plain "
                                f"version {bad}")
        problems[n_before:] = ["(b) " + p for p in problems[n_before:]]
        # 9l (b)'s tp = 1 run is (g)'s reference too.
        del two, pb, cb
        out["b_s"] = time.perf_counter() - t0
        for part, fn in (("d", lambda: phase_tp_prefix(group, params, cfg,
                                                        dev, prefix_one)),
                         ("f", lambda: phase_tp_sparse_verify(
                             group, params, cfg, ecfg, reqs, to_sampling,
                             dev)),
                         ("c", lambda: phase_tp_ring(group, params, cfg,
                                                     dev))):
            t0 = time.perf_counter()
            out[part] = tp_part(fn, problems)
            out[f"{part}_s"] = time.perf_counter() - t0
    finally:
        if group is not None:
            group.close()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["e"] = tp_part(lambda: phase_tp_build(params, cfg, reqs, to_sampling,
                                              ckpt, dev), problems)
    out["e_s"] = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["g"] = tp_part(lambda: phase_tp_plans(params, cfg, ecfg, reqs,
                                              to_sampling, one, dev,
                                              prefix_one.get("dense")),
                       problems)
    out["g_s"] = time.perf_counter() - t0
    del one
    log(f"tp seconds: spawn {out['spawn_s']:.1f}, (a) {out['tiny_s']:.1f}, "
        f"(b) {out['b_s']:.1f}, (d) {out['d_s']:.1f}, (f) "
        f"{out['f_s']:.1f}, (c) {out['c_s']:.1f}, (e) {out['e_s']:.1f}, "
        f"(g) {out['g_s']:.1f}")
    if problems:
        raise AssertionError("tp: " + "; ".join(problems))
    return out


def tp_part(fn, problems):
    """Run one part of 9l; a failed gate is kept in ``problems`` (the
    phase raises them together once every part has run)."""
    try:
        return fn()
    except AssertionError as e:
        log(f"tp part failed: {e}")
        problems.append(str(e))
        return {"failed": str(e)}


def tp_prefix_traffic(cfg):
    """9l (d)'s traffic and dense engine: (requests, the primer first;
    their sampling; the engine configuration)."""
    from seldon_tpu_torch.servers.engine import EngineConfig

    prime, burst = prefix_requests(cfg.vocab_size, SHARED_LEN, PREFIX_SEED)
    reqs = [dict(r, max_new_tokens=TP_PREFIX_NEW) for r in [prime] + burst]
    block = EngineConfig.prefix_block
    node = 2 * TP_PREFIX_LAYERS * cfg.n_kv_heads * block * cfg.head_dim * 2
    ecfg = EngineConfig(max_slots=8, max_seq_len=2048,
                        prompt_buckets=(32, 128, 512, 1024, 2048),
                        prefix_cache=True, async_fetch=False,
                        prefix_cache_bytes=node * (SHARED_LEN // block + 8))
    return reqs, functools.partial(_tp_greedy, TP_PREFIX_NEW), ecfg


def phase_tp_prefix(group, params, cfg, dev, keep=None):
    """9l (d): the dense engine's prefix cache at tp = 2 against tp = 1:
    phase 4's weights cut to TP_PREFIX_LAYERS layers at full width, the
    dense slab (32 ... 2048 buckets, 8 slots, the synchronous loop), 9d's
    priming request alone and then its 8 requests at once behind the
    shared SHARED_LEN-token prompt, TP_PREFIX_NEW greedy tokens each,
    under a byte budget of the shared prompt's nodes and 8 more (so the
    priming request's own node is evicted). The trie lives on rank 0;
    the worker keeps its heads' spans by node id. Gates: streams equal,
    every wave's logits bit-equal, the trie's hits / tokens saved /
    evictions equal, and the worker's store equal to rank 0's trie
    (``check_replicas``). ``keep`` (a dict) takes the tp = 1 run as
    ``"dense"``: (g2)'s dense prefix run compares with it."""
    import torch

    from seldon_tpu_torch.servers.engine import InferenceEngine
    from seldon_tpu_torch.servers.mesh_engine import MeshEngine

    p4, c4 = shallow(params, cfg, TP_PREFIX_LAYERS)
    reqs, greedy, ecfg = tp_prefix_traffic(cfg)
    runs = {}
    for tp in (1, 2):
        eng = (InferenceEngine(p4, c4, ecfg, dev) if tp == 1
               else MeshEngine(p4, c4, ecfg, tp=2, group=group))
        t0 = time.perf_counter()
        with WaveTap([r["seed"] for r in reqs]) as wt:
            eng.start()
            try:
                got = submit_all(eng, reqs[:1], greedy)
                got += submit_all(eng, reqs[1:], greedy)
                if tp == 2:
                    eng.check_replicas()
                    nodes = len(eng._prefix.spans())
            finally:
                eng.stop()
        errs = [e for _, e in got if e]
        if errs:
            raise AssertionError(f"tp (d) tp={tp}: error items {errs}")
        runs[tp] = ([t for t, _ in got], wt, time.perf_counter() - t0,
                    eng.stats.snapshot())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    one, two = runs[1], runs[2]
    if keep is not None:
        keep["dense"] = one
    waves = tp_wave_diffs(reqs, two[:2], one[:2])
    out = {"layers": TP_PREFIX_LAYERS, "waves": waves, "nodes": nodes,
           "streams_equal": two[0] == one[0],
           "stats": {tp: {k: runs[tp][3][k] for k in TRIE_KEYS}
                     for tp in (1, 2)},
           "wall_s": {tp: runs[tp][2] for tp in (1, 2)}}
    log(f"tp (d) dense prefix cache, {TP_PREFIX_LAYERS} layers, tp=2 vs "
        f"tp=1: streams equal {out['streams_equal']}; per wave bit-equal "
        f"share {[round(w['bit_equal_share'], 6) for w in waves]}; trie "
        f"{out['stats'][2]} (tp=1 {out['stats'][1]}); the worker's store "
        f"equals the trie's {nodes} nodes; wall {one[2]:.1f} / "
        f"{two[2]:.1f} s")
    problems = []
    if not out["streams_equal"]:
        problems.append("streams differ")
    over = [w for w in waves if w["bit_equal_share"] != 1.0]
    if over:
        problems.append(f"waves not bit-equal: {over}")
    if out["stats"][1] != out["stats"][2] or not out["stats"][1][
            "prefix_hits"]:
        problems.append(f"trie counters {out['stats']}")
    if problems:
        raise AssertionError("tp (d): " + "; ".join(problems))
    return out


def tp_head_products(dev):
    """9l (f)'s report: for each product of TP_HEAD_PRODUCTS, on seeded
    bf16-rounded and f32 operands, the outputs of each tp = 2 rank's half
    of the heads, computed alone, that differ from the full product's
    (the unpadded form; the padded one is gated by 9l (f) and the card
    test)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, eq, sa, sb, ha, hb, ho in TP_HEAD_PRODUCTS:
        for dt in (torch.bfloat16, torch.float32):
            a = torch.randn(sa, generator=g, device=dev).to(dt).float()
            b = torch.randn(sb, generator=g, device=dev).to(dt).float()
            full = torch.einsum(eq, a, b)
            n = sa[ha] // 2
            out[f"{name} ({str(dt)[6:]} operands)"] = sum(
                int((torch.einsum(eq, a.narrow(ha, r * n, n),
                                  b.narrow(hb, r * n, n))
                     != full.narrow(ho, r * n, n)).sum())
                for r in range(2))
    log(f"tp (f) products, outputs of a rank's half of the heads unequal "
        f"to the full product's (unpadded): {out}")
    return out


def dp_products(dev, batches=(32, None)):
    """(g2)'s report, the dp twin of ``tp_head_products``: for each product
    of TP_HEAD_PRODUCTS, at its 32 slots and at TP_DP_SLOTS, on seeded
    bf16-rounded and f32 operands, the outputs of each dp = 2 replica's
    half of the batch (dim 0 narrowed, computed alone) that differ from
    the whole batch's, unpadded and padded with zero rows to the whole
    batch's count, and those of a dp = 2 x tp = 2 rank's half of the
    slots and of the heads, unpadded (the served form, padded on both,
    is gated by (g2) and the card test); and the same for RMS norm's mean
    over the features."""
    import torch

    g = torch.Generator(device=dev).manual_seed(0)
    out, padded, quarter = {}, {}, {}
    for B in (b or TP_DP_SLOTS for b in batches):
        for name, eq, sa, sb, ha, hb, ho in TP_HEAD_PRODUCTS:
            for dt in (torch.bfloat16, torch.float32):
                a = torch.randn((B,) + sa[1:], generator=g,
                                device=dev).to(dt).float()
                b = torch.randn((B,) + sb[1:], generator=g,
                                device=dev).to(dt).float()
                full = torch.einsum(eq, a, b)
                n = B // 2
                key = f"{name} ({str(dt)[6:]} operands, B {B})"
                out[key] = sum(
                    int((torch.einsum(eq, a[r * n:(r + 1) * n],
                                      b[r * n:(r + 1) * n])
                         != full[r * n:(r + 1) * n]).sum())
                    for r in range(2))
                padded[key] = sum(
                    int((torch.einsum(eq, *(torch.cat([t[r * n:(r + 1) * n],
                                                       torch.zeros_like(
                                                           t[n:])])
                                            for t in (a, b)))[:n]
                         != full[r * n:(r + 1) * n]).sum())
                    for r in range(2))
                h = sa[ha] // 2
                quarter[key] = sum(
                    int((torch.einsum(
                        eq, a[r * n:(r + 1) * n].narrow(ha, t * h, h),
                        b[r * n:(r + 1) * n].narrow(hb, t * h, h))
                         != full[r * n:(r + 1) * n].narrow(ho, t * h, h))
                        .sum())
                    for r in range(2) for t in range(2))
        # RMS norm's mean over llama3-8b's 4096 features, a row a slot.
        x = torch.randn(B, 4096, generator=g, device=dev)
        whole = (x * x).mean(-1)
        n = B // 2
        key = f"rms_norm's mean (float32 rows, B {B})"
        halves = [x[r * n:(r + 1) * n] for r in range(2)]
        out[key] = sum(int(((t * t).mean(-1) != whole[r * n:(r + 1) * n])
                           .sum()) for r, t in enumerate(halves))
        pads = [torch.cat([t, torch.zeros_like(t)]) for t in halves]
        padded[key] = sum(int(((t * t).mean(-1)[:n]
                               != whole[r * n:(r + 1) * n]).sum())
                          for r, t in enumerate(pads))
    cost = dp_pad_products(dev)
    ms = {k: tuple(round(v[f]["ms"], 5) for f in ("whole", "padded",
                                                  "unpadded"))
          for k, v in cost.items()}
    log(f"tp (g2) products, outputs of a dp = 2 replica's half of the "
        f"batch unequal to the whole batch's: unpadded "
        f"{ {k: v for k, v in out.items() if v} or 'none'} of {len(out)}; "
        f"padded to the whole batch "
        f"{ {k: v for k, v in padded.items() if v} or 'none'}; a dp = 2 x "
        f"tp = 2 rank's slots and heads, unpadded "
        f"{ {k: v for k, v in quarter.items() if v} or 'none'}; the served "
        f"padded products, ms per call (whole batch / a replica's half "
        f"padded / unpadded): "
        f"{ms}; "
        f"{card_line()}")
    return {"unpadded": out, "padded": padded, "dp2_tp2_unpadded": quarter,
            "pad_cost": cost}


def dp_pad_products(dev):
    """What padding the products that differ costs (C26; a report): the
    sparse walk's block scores (``rpa._block_scores``, decode, 32 slots,
    one block column) and the verify diagonal scores
    (``spec_decode._diag_scores``, spec_k 4, TP_DP_SLOTS slots), bf16
    operands at llama3-8b's heads, per call (``pad_measure``): the whole
    batch, a dp = 2 replica's half inside ``lt_gemm.row_share`` (padded,
    as served) and the same half outside it (unpadded)."""
    import torch

    from seldon_tpu_torch.models import spec_decode
    from seldon_tpu_torch.ops import lt_gemm
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    g = torch.Generator(device=dev).manual_seed(2)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    B = 32
    mask = torch.ones(B, 1, 16, dtype=torch.bool, device=dev)
    walk = (rnd(B, 1, 8, 4, 128), rnd(B, 8, 16, 128))
    diag = (rnd(TP_DP_SLOTS, 5, 8, 4, 128).float(),
            rnd(TP_DP_SLOTS, 5, 8, 128).float())
    out = {}
    for name, fn, (a, b) in (
            ("walk scores, decode",
             lambda a, b: rpa._block_scores(a, b, None, mask[:len(a)]),
             walk),
            ("verify diagonal scores", spec_decode._diag_scores, diag)):
        n, h = len(a), len(a) // 2

        def padded(fn=fn, a=a, b=b, n=n, h=h):
            with lt_gemm.row_share(h, n):
                return fn(a[:h], b[:h])

        out[name] = {tag: pad_measure(f) for tag, f in (
            ("whole", lambda fn=fn, a=a, b=b: fn(a, b)),
            ("padded", padded),
            ("unpadded", lambda fn=fn, a=a, b=b, h=h: fn(a[:h], b[:h])))}
    return out


def phase_tp_sparse_verify(group, params, cfg, ecfg, reqs, to_sampling,
                           dev):
    """9l (f), C18 (i): the products batched over the rank's heads that
    9l (b)'s padded products do not cover, at full width: phase 4's weights
    cut to TP_F_LAYERS layers, 9l (b)'s engine configuration and burst
    (TP_MAX_NEW new tokens, the synchronous loop) on each of TP_F_MODES
    (the ``"sparse"`` ragged leg: its two-pass walk's einsums; the spec
    engine, spec_k 4, paged, n-gram drafter: the masked verify body's
    einsums, and B1 in every verify wave beside the kernel verify body's
    own einsums), at tp = 2 against tp = 1. Gates: every wave's logits
    bit-equal to tp = 1's, the streams equal; on the kernel verify leg B1
    launched layers x verify waves on rank 0. Reported: each mode's wave
    count and wall seconds, and which products differ unpadded
    (``tp_head_products``)."""
    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.engine import InferenceEngine
    from seldon_tpu_torch.servers.mesh_engine import MeshEngine

    pf, cf = shallow(params, cfg, TP_F_LAYERS)
    out = {"layers": TP_F_LAYERS, "products": tp_head_products(dev)}
    problems = []
    for name, kw in TP_F_MODES:
        ek = dataclasses.replace(ecfg, **kw)
        runs = {}
        for tp in (1, 2):
            eng = (InferenceEngine(pf, cf, ek, dev) if tp == 1
                   else MeshEngine(pf, cf, ek, tp=2, group=group))
            n0 = rpa.launches
            t0 = time.perf_counter()
            res = tp_engine_burst(eng, reqs, to_sampling, tap=True)
            runs[tp] = res[:2] + (time.perf_counter() - t0, res[3],
                                  rpa.launches - n0)
            del eng
            gc.collect()
            torch.cuda.empty_cache()
        one, two = runs[1], runs[2]
        waves = tp_wave_diffs(reqs, two[:2], one[:2])
        st = two[3]
        n_waves = st["decode_dispatches"] + st.get("prefill_waves", 0)
        r = {"waves": len(waves), "decode_dispatches":
             st["decode_dispatches"], "streams_equal": two[0] == one[0],
             "bit_equal_share_min": min(w["bit_equal_share"]
                                        for w in waves),
             "max_abs_diff": max(w["max_abs_diff"] for w in waves),
             "waves_not_bit_equal": sum(w["bit_equal_share"] != 1.0
                                        for w in waves),
             "launches_b1_rank0": two[4],
             "wall_s": {tp: runs[tp][2] for tp in (1, 2)}}
        out[name] = r
        log(f"tp (f) {name}, {TP_F_LAYERS} layers, tp=2 vs tp=1: streams "
            f"equal {r['streams_equal']}; {r['waves_not_bit_equal']} of "
            f"{r['waves']} sampling calls not bit-equal (min share "
            f"{r['bit_equal_share_min']:.6f}, max |dlogit| "
            f"{r['max_abs_diff']:.4g}); B1 launches on rank 0 "
            f"{r['launches_b1_rank0']} over {n_waves} wave legs; wall "
            f"{runs[1][2]:.1f} / {runs[2][2]:.1f} s")
        if not r["streams_equal"]:
            problems.append(f"{name}: streams differ")
        if r["waves_not_bit_equal"]:
            over = [w for w in waves if w["bit_equal_share"] != 1.0]
            problems.append(f"{name}: waves not bit-equal: {over}")
        if name == "spec-kernel" and r["launches_b1_rank0"] != (
                cf.n_layers * st["decode_dispatches"]):
            problems.append(f"{name}: B1 launches {r['launches_b1_rank0']} "
                            f"!= layers x verify waves "
                            f"{st['decode_dispatches']}")
    if problems:
        raise AssertionError("tp (f): " + "; ".join(problems))
    return out


def _tp_greedy(n, r):
    """Request ``r`` greedy, ``n`` new tokens, under its own seed (the
    taps key rows by seed)."""
    from seldon_tpu_torch.models.sampling import SamplingParams

    return SamplingParams(temperature=0.0, max_new_tokens=n, seed=r["seed"])


def tp_worker_memory(worker):
    """Run on a worker rank: its card memory (peak and now)."""
    import torch

    if worker.device.type != "cuda":
        return {"max_allocated": 0, "allocated": 0, "reserved": 0}
    return {"max_allocated": torch.cuda.max_memory_allocated(),
            "allocated": torch.cuda.memory_allocated(),
            "reserved": torch.cuda.memory_reserved()}


def tp_cut_mismatches(whole, cfg, shard, rank, tp=2):
    """The leaves of ``shard`` that are not rank ``rank``'s cut of
    ``whole`` (the model's leaf, or its rank's part of the last dim),
    bit for bit; compared in place, no copy made."""
    import torch

    from seldon_tpu_torch.models import tp_sharding
    from seldon_tpu_torch.servers.mesh_engine import _leaf_table

    bad = []
    for path, name, spec, t in _leaf_table(cfg, shard, True):
        w = tp_sharding.leaf_of(whole, path, name)
        if spec is not None:
            n = w.shape[-1] // tp
            w = w.narrow(w.dim() - 1, rank * n, n)
        if t.shape != w.shape or t.dtype != w.dtype or not torch.equal(t, w):
            bad.append(f"{path}{name}")
    return bad


def tp_worker_cut(worker, leaves):
    """Run on a worker rank: its shard's leaves that are not its cut of
    ``leaves`` (the whole model's, {(path, name): tensor} as CUDA IPC
    handles on the shared card)."""
    from types import SimpleNamespace

    n = 1 + max((path[0] for path, _ in leaves if path), default=-1)
    whole = SimpleNamespace(blocks=[SimpleNamespace() for _ in range(n)])
    for (path, name), t in leaves.items():
        setattr(whole.blocks[path[0]] if path else whole, name, t)
    return tp_cut_mismatches(whole, worker.cfg, worker.params,
                             worker.ranks.rank)


def tp_build_round(name, srv, whole, cfg, reqs, dev):
    """One ``TorchServer(tp=2)`` (its ranks on the one card): load it,
    measure rank 0's card memory over the load (peak above what was
    allocated before) and both ranks' at ready, hold each rank's shard
    to its cut of ``whole`` bit for bit (rank 1 through CUDA IPC handles
    of ``whole``'s leaves), and serve TP_BUILD_REQUESTS greedy requests
    at once against an InferenceEngine at tp = 1 on ``whole``."""
    import torch

    from seldon_tpu_torch.servers import mesh_engine
    from seldon_tpu_torch.servers.engine import InferenceEngine

    # One card: both ranks on it (the staged route), as 9l's group.
    srv._serving_mesh = lambda c: mesh_engine.build_tp_mesh(2, TP_DEVICES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    try:
        srv.load()
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mem0 = {"peak_over_load": torch.cuda.max_memory_allocated() - base,
                "allocated_at_ready": torch.cuda.memory_allocated() - base,
                "reserved_at_ready": torch.cuda.memory_reserved()}
        mem1 = srv.group.run(f"{__name__}:tp_worker_memory")[0]
        bad0 = tp_cut_mismatches(whole, cfg, srv.params, 0)
        leaves = {(p, n): t for p, n, _, t in
                  mesh_engine._leaf_table(cfg, whole, False)}
        bad1 = srv.group.run(f"{__name__}:tp_worker_cut", leaves)[0]
        del leaves
        weight_bytes = srv.engine.mesh_info()["weight_bytes_per_device"]
        greedy = functools.partial(_tp_greedy, TP_BUILD_NEW)
        got = submit_all(srv.engine, reqs, greedy)
        srv.engine.check_replicas()
    finally:
        srv.stop()
    ecfg = dataclasses.replace(srv.engine.ecfg, tp=1)
    ref = InferenceEngine(whole, cfg, ecfg, dev)
    ref.start()
    try:
        want = submit_all(ref, reqs, greedy)
    finally:
        ref.stop()
    del ref
    gc.collect()
    torch.cuda.empty_cache()
    out = {"load_s": load_s, "rank0": mem0, "rank1": mem1,
           "weight_bytes_per_device": weight_bytes,
           "shard_mismatches": [bad0, bad1],
           "streams": [t for t, _ in got],
           "streams_equal": [t for t, _ in got] == [t for t, _ in want]}
    log(f"tp (e) {name}: TorchServer(tp=2) loaded in {load_s:.1f} s; "
        f"rank 0 peak over the load {mem0['peak_over_load']} B, at ready "
        f"{mem0['allocated_at_ready']} B allocated / "
        f"{mem0['reserved_at_ready']} B reserved; rank 1 peak "
        f"{mem1['max_allocated']} B, at ready {mem1['allocated']} / "
        f"{mem1['reserved']} B; weights per device {weight_bytes} B; "
        f"shard mismatches {bad0} / {bad1}; "
        f"{TP_BUILD_REQUESTS} greedy streams equal to tp=1: "
        f"{out['streams_equal']}")
    errs = [e for _, e in got + want if e]
    if errs or bad0 or bad1 or not out["streams_equal"]:
        raise AssertionError(f"tp (e) {name}: {errs} {out}")
    return out


def phase_tp_build(params, cfg, reqs, to_sampling, ckpt, dev):
    """9l (e): ``TorchServer(tp=2)`` building each rank's shard on that
    rank, never the whole model: seeded as phase 4 (llama3-8b, seed 0,
    full depth), then from 9d's LOAD_LAYERS-layer HF checkpoint under
    build/. Gates (``tp_build_round``): every rank's shard bit-equal to
    its cut of phase 4's weights (of their LOAD_LAYERS-layer cut for the
    checkpoint); TP_BUILD_REQUESTS greedy requests equal to tp = 1's;
    for the seeded build, rank 0's peak over the load at most
    TP_BUILD_SLACK x (its shard TP_WEIGHT_BYTES + the largest leaf's f32
    draw, the embedding's) and below the whole model's bytes, and its
    weights per device (``mesh_info``, from the shard shapes) =
    TP_WEIGHT_BYTES. Rank 1's peak and both ranks' memory at ready are
    reported."""
    from seldon_tpu_torch.servers.torchserver import TorchServer

    greedy = [dict(r, max_new_tokens=TP_BUILD_NEW) for r in reqs
              if r.get("temperature") == 0.0][:TP_BUILD_REQUESTS]
    kw = dict(tp=2, max_slots=TP_BUILD_SLOTS, max_seq_len=TP_BUILD_SEQ,
              ragged=1, ragged_kernel="pallas", device=dev)
    out = {"seeded": tp_build_round(
        "seeded", TorchServer(preset="llama3-8b", init_seed=0, **kw), params,
        cfg, greedy, dev)}
    draw = cfg.vocab_size * cfg.d_model * 4
    limit = TP_BUILD_SLACK * (TP_WEIGHT_BYTES + draw)
    whole = param_bytes(params)
    peak = out["seeded"]["rank0"]["peak_over_load"]
    out.update(peak_limit=limit, whole_model_bytes=whole, f32_draw=draw)
    log(f"tp (e) seeded: rank 0's peak over the load {peak} B against "
        f"{TP_BUILD_SLACK} x (shard {TP_WEIGHT_BYTES} + f32 draw {draw}) = "
        f"{limit:.0f} B; the whole model {whole} B")
    if not peak <= limit or not peak < whole:
        raise AssertionError(f"tp (e): rank 0's peak {peak} B over "
                             f"{limit:.0f} or the whole model {whole}")
    if out["seeded"]["weight_bytes_per_device"] != TP_WEIGHT_BYTES:
        raise AssertionError(f"tp (e): weights per device "
                             f"{out['seeded']['weight_bytes_per_device']} "
                             f"!= {TP_WEIGHT_BYTES}")
    p_cut, cfg_cut = shallow(params, cfg, LOAD_LAYERS)
    out["hf"] = tp_build_round(
        "HF checkpoint", TorchServer(model_uri=ckpt, **kw), p_cut, cfg_cut,
        greedy, dev)
    return out


def phase_tp_ring(group, params, cfg, dev):
    """9l (c): the group laid out as an 'sp' axis (``MeshPlan(sp=2)``):
    ring vs xla at B 1 x S 4096."""
    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.parallel.mesh import MeshPlan
    from seldon_tpu_torch.servers import mesh_engine

    ring = dataclasses.replace(cfg, attn_impl="ring")
    xla = dataclasses.replace(cfg, attn_impl="xla")
    group.replan(MeshPlan(sp=2))
    t0 = time.perf_counter()
    mesh_engine.send_weights(group, ring, params, shard=False)
    send_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, cfg.vocab_size, (1, RING_S), generator=gen,
                         device=dev)
    lx = transformer.forward(params, toks, xla)
    with EmbedNudge():
        ln = transformer.forward(params, toks, xla)
    d_nudge = per_position_max_diff(ln, lx)
    del ln
    group.ranks.reset_counters()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lr = group.score(toks.cpu().numpy(), lambda: transformer.forward(
        params, toks, ring, ring=group.sp_ranks))
    torch.cuda.synchronize()
    ring_s = time.perf_counter() - t0
    d_ring = per_position_max_diff(lr, lx)
    finite = bool(torch.isfinite(lr).all())
    del lr, lx
    group.release()
    gc.collect()
    torch.cuda.empty_cache()
    med_r, med_n = d_ring.median().item(), d_nudge.median().item()
    out = {"S": RING_S, "send_s": send_s, "ring_s": ring_s,
           "exchanges": group.ranks.gathers, "finite": finite,
           "median_logit_diff_ring_vs_xla": med_r,
           "median_logit_diff_nudged_vs_xla": med_n,
           "max_logit_diff_ring_vs_xla": d_ring.max().item(),
           "drift_ratio": med_r / max(med_n, 1e-30)}
    log(f"tp (c) ring sp=2 B=1 S={RING_S}: median |dlogit| ring vs xla "
        f"{med_r:.4g}, nudged vs xla {med_n:.4g} (ratio "
        f"{out['drift_ratio']:.3f}, max {RING_DRIFT_MAX}); ring call "
        f"{ring_s:.2f} s with {out['exchanges']} transfers; full "
        f"weights to the worker in {send_s:.1f} s")
    if not finite or out["drift_ratio"] > RING_DRIFT_MAX:
        raise AssertionError(f"tp (c): ring logits {out}")
    return out


# 9l (g)'s runs that launch B1 (per rank, in the kernels line).
TP_PLAN_B1_RUNS = ("g1", "g2", "g2 spec-kernel", "g2 prefix paged")
# 9l (g2): the trie's counters held to tp = 1's.
TRIE_KEYS = ("prefix_hits", "prefix_tokens_saved", "zero_copy_admissions",
             "cow_copies", "prefix_evictions", "prefix_seed_copies")
# 9l (g): the serving plans of four ranks sharing the one card.
TP_PLAN_DEVICES = ("cuda:0",) * 4
# (g2)'s slots: the engine hands out free slots from the top, so at 32
# slots the burst's 8 requests would all sit on replica 1; at 8 each
# replica serves 4.
TP_DP_SLOTS = 8
# (g3): the dense engine's context-parallel admission of one prompt (in
# the 512 bucket: it splits over the two sp ranks), in a window of
# TP_RING_SEQ.
TP_RING_PROMPT = 500
TP_RING_SEQ = 1024


def tp_worker_logits(worker, seeds=None):
    """Run on a worker: with ``seeds``, keep the logits rows its samplers
    see (WaveTap); without, stop and return them if this rank leads its
    dp replica (tp and sp coordinate 0), else nothing."""
    if seeds is not None:
        worker.logit_tap = WaveTap(seeds).__enter__()
        return None
    tap = worker.logit_tap
    tap.__exit__(None, None, None)
    del worker.logit_tap
    lead = (worker.axes.group("tp").rank == 0
            and worker.axes.group("sp").rank == 0)
    return tap.rows if lead else {}


def plan_burst(name, group, pb, cb, ecfg, reqs, to_sampling, one, split=0):
    """9l (b)'s burst on ``group``'s plan (``split``: ``tp_engine_burst``'s
    primer first): every rank under KernelTap, every replica leader's
    logits kept, the streams and every wave's logits held to tp = 1's run
    ``one`` (9l (b)'s, or the same traffic's). Returns the report
    (streams, per-wave bit-equal share, launches per rank against
    layers x each replica's kernel legs: ragged wave legs and verify
    waves on B1, the taps, weights per device, route, collectives per
    wave; with a prefix cache the trie's counters beside ``one``'s and
    every rank's transfers between replicas)."""
    import types

    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers import dp_replicas, mesh_engine

    dp, B = group.dp, ecfg.max_slots
    legs = [0] * dp
    real_cut = dp_replicas.cut

    def counted(fam, args, kw, lo, hi, active):
        c = real_cut(fam, args, kw, lo, hi, active)
        if c is not None and c.kw.get("kernel") == "pallas":
            if fam == "ragged_wave":
                legs[lo // (B // dp)] += 1 + int(bool(c.kw.get(
                    "has_prefill")))
            elif fam == "_verify_impl":
                legs[lo // (B // dp)] += 1
        return c

    t0 = time.perf_counter()
    eng = mesh_engine.MeshEngine(pb, cb, ecfg, group=group)
    setup_s = time.perf_counter() - t0
    info = eng.mesh_info()
    group.run(f"{__name__}:tp_worker_tap", cb.n_layers)
    group.run(f"{__name__}:tp_worker_logits", [r["seed"] for r in reqs])
    rpa.launches = 0
    group.run(f"{__name__}:tp_worker_launches", True)
    group.reset_counters()
    group.transfers(reset=True)
    dp_replicas.cut = counted
    try:
        with KernelTap(cb.n_layers) as tap0:
            streams, wt, wall, st = tp_engine_burst(
                eng, reqs, to_sampling, tap=True, split=split)
    finally:
        dp_replicas.cut = real_cut
    moved = [dataclasses.asdict(t) for t in group.transfers()]
    launches = ([rpa.launches]
                + group.run(f"{__name__}:tp_worker_launches"))
    taps = ([{"checked": tap0.checked, "errors": tap0.errs}]
            + group.run(f"{__name__}:tp_worker_untap"))
    rows = dict(wt.rows)
    for theirs in group.run(f"{__name__}:tp_worker_logits"):
        rows.update(theirs)
    counters = group.counters()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    n_waves = st["decode_dispatches"]
    if dp == 1:
        legs = [n_waves + st["prefill_waves"]]
    want = [cb.n_layers * legs[group.coord(r)["dp"]]
            for r in range(group.world)]
    waves = tp_wave_diffs(reqs, (streams, types.SimpleNamespace(rows=rows)),
                          one[:2])
    cmp = compare_legs(reqs, f"tp {name} vs tp=1",
                       (streams, rows), (one[0], one[1].rows))
    out = {
        "plan": dict(group.mesh.shape), "setup_s": setup_s,
        "streams_equal_count": sum(a == b for a, b in zip(streams, one[0])),
        "streams_equal": streams == one[0], "waves": waves, "compare": cmp,
        "bit_equal_share": (sum(w["bit_equal_share"] * w["rows"]
                                for w in waves)
                            / max(1, sum(w["rows"] for w in waves))),
        "launches_per_rank": launches, "launches_expected": want,
        "legs_per_replica": legs, "taps": taps, "mesh_info": info,
        "waves_run": n_waves, "collectives": counters["gathers"],
        "collective_ms_per_wave": 1e3 * counters["gather_s"] / n_waves,
        "wait_ms_per_wave": 1e3 * counters["wait_s"] / n_waves,
        "tokens_per_s": sum(map(len, streams)) / wall,
    }
    if ecfg.prefix_cache:
        out["trie"] = {k: st[k] for k in TRIE_KEYS}
        out["trie_tp1"] = {k: one[3][k] for k in TRIE_KEYS}
        out["transfers"] = moved
        log(f"tp {name} trie {out['trie']} (tp=1 {out['trie_tp1']}); "
            f"transfers per rank {moved}")
    log(f"tp {name} {dict(group.mesh.shape)} {cb.n_layers} layers: "
        f"{out['streams_equal_count']}/{len(reqs)} streams equal to tp=1; "
        f"per wave bit-equal share "
        f"{[round(w['bit_equal_share'], 6) for w in waves]} (rows "
        f"{out['bit_equal_share']:.6f}); max |dlogit| "
        f"{[round(w['max_abs_diff'], 5) for w in waves]}; B1 launches per "
        f"rank {launches} (expected {want}, legs per replica {legs}); "
        f"weights per device {info['weight_bytes_per_device']} B; route "
        f"{info['route']}; {counters['gathers']} collectives, "
        f"{out['collective_ms_per_wave']:.2f} ms + "
        f"{out['wait_ms_per_wave']:.2f} ms waiting per wave over {n_waves} "
        f"waves; {out['tokens_per_s']:.1f} tokens/s with taps on (no "
        f"claim: staged through host memory); {card_line()}")
    return out


def plan_problems(name, out, n_reqs, kernel=True):
    """The gates of a plan burst: 8 / 8 streams; every wave bit-equal;
    launches per rank; on B1's leg (``kernel``) a checked launch on
    every rank, and B1 within phase 6's tolerances on every rank; with a
    prefix cache the trie's counters equal to tp = 1's (hits among them)
    and KV moved between the replicas."""
    problems = []
    if not out["streams_equal"]:
        problems.append(f"{out['streams_equal_count']}/{n_reqs} greedy "
                        f"streams equal")
    over = [w for w in out["waves"] if w["bit_equal_share"] != 1.0]
    if over:
        problems.append(f"waves whose logits are not bit-equal to tp = "
                        f"1's: {over}")
    if out["launches_per_rank"] != out["launches_expected"]:
        problems.append(f"B1 launches per rank {out['launches_per_rank']} "
                        f"!= {out['launches_expected']}")
    if "trie" in out and (out["trie"] != out["trie_tp1"]
                          or not out["trie"]["prefix_hits"]):
        problems.append(f"trie counters {out['trie']} against tp = 1's "
                        f"{out['trie_tp1']}")
    if "trie" in out and not sum(t["bytes_in"] for t in out["transfers"]):
        problems.append("no KV moved between the replicas")
    for r, t in enumerate(out["taps"]):
        if kernel and sum(t["checked"].values()) == 0:
            problems.append(f"rank {r}: no checked B1 launch")
        bad = {leg: e for leg, e in t["errors"].items()
               if e[0] > TOL_M or e[1] > TOL_L or e[2] > TOL_ACC}
        if bad:
            problems.append(f"rank {r}: B1 disagrees with its plain version "
                            f"{bad}")
    return [f"({name}) {p}" for p in problems]


def plan_ring(group, pb, cb, reqs, to_sampling, dev):
    """(g3): sp2 x tp2 with the ring config: the ring score at B 1 x S
    RING_S against "xla" on one device, gated at RING_DRIFT_MAX x the
    nudge floor on the same tokens (9l (c)'s gate); one context-parallel
    admission on the dense engine, its first token (and stream) against
    the one-device admission's."""
    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.parallel import ring_attention as ra
    from seldon_tpu_torch.servers import mesh_engine
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

    ring = dataclasses.replace(cb, attn_impl="ring")
    xla = dataclasses.replace(cb, attn_impl="xla")
    gen = torch.Generator(device=dev).manual_seed(11)
    toks = torch.randint(0, cb.vocab_size, (1, RING_S), generator=gen,
                         device=dev)
    lx = transformer.forward(pb, toks, xla)
    with EmbedNudge():
        ln = transformer.forward(pb, toks, xla)
    d_nudge = per_position_max_diff(ln, lx)
    del ln
    prompt = dict(reqs[0], prompt_token_ids=toks[0, :TP_RING_PROMPT].tolist(),
                  max_new_tokens=TP_MAX_NEW)
    ecfg = EngineConfig(max_slots=4, max_seq_len=TP_RING_SEQ,
                        async_fetch=False,
                        prompt_buckets=(TP_RING_SEQ // 2, TP_RING_SEQ))
    ref = InferenceEngine(pb, xla, ecfg, dev)
    ref.start()
    try:
        want = submit_all(ref, [prompt], to_sampling)
    finally:
        ref.stop()
    del ref
    t0 = time.perf_counter()
    eng = mesh_engine.MeshEngine(pb, ring, ecfg, group=group)
    setup_s = time.perf_counter() - t0
    info = eng.mesh_info()
    calls = []
    real = ra.ring_attention
    ra.ring_attention = lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        group.reset_counters()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lr = group.score(toks.cpu().numpy(), lambda: transformer.forward(
            eng.params, toks, ring, ring=group.sp_ranks, tp=group.hints(2)))
        torch.cuda.synchronize()
        ring_s = time.perf_counter() - t0
        score = group.counters()
        n_score = len(calls)
        eng.start()
        try:
            got = submit_all(eng, [prompt], to_sampling)
            eng.check_replicas()
        finally:
            eng.stop()
        n_admit = len(calls) - n_score
    finally:
        ra.ring_attention = real
    del eng
    d_ring = per_position_max_diff(lr, lx)
    finite = bool(torch.isfinite(lr).all())
    del lr, lx
    gc.collect()
    torch.cuda.empty_cache()
    med_r, med_n = d_ring.median().item(), d_nudge.median().item()
    out = {"plan": dict(group.mesh.shape), "S": RING_S, "setup_s": setup_s,
           "ring_s": ring_s, "collectives": score["gathers"],
           "collective_ms": 1e3 * score["gather_s"],
           "wait_ms": 1e3 * score["wait_s"], "finite": finite,
           "ring_calls_score": n_score, "ring_calls_admission": n_admit,
           "median_logit_diff_ring_vs_xla": med_r,
           "median_logit_diff_nudged_vs_xla": med_n,
           "max_logit_diff_ring_vs_xla": d_ring.max().item(),
           "drift_ratio": med_r / max(med_n, 1e-30),
           "first_token": [got[0][0][:1], want[0][0][:1]],
           "stream_equal": got[0][0] == want[0][0],
           "weight_bytes_per_device": info["weight_bytes_per_device"],
           "route": info["route"]}
    log(f"tp (g3) {out['plan']} ring score B=1 S={RING_S} at "
        f"{cb.n_layers} layers: median |dlogit| ring vs xla {med_r:.4g}, "
        f"nudged vs xla {med_n:.4g} (ratio {out['drift_ratio']:.3f}, max "
        f"{RING_DRIFT_MAX}); {ring_s:.2f} s with {score['gathers']} "
        f"collectives ({out['collective_ms']:.1f} ms, "
        f"{out['wait_ms']:.1f} ms waiting); ring calls score {n_score}, "
        f"admission {n_admit}; a {TP_RING_PROMPT}-token context-parallel "
        f"admission's first token {got[0][0][:1]} vs one device's "
        f"{want[0][0][:1]}, stream equal {out['stream_equal']}; weights "
        f"per device {out['weight_bytes_per_device']} B; {card_line()}")
    errs = [e for _, e in got + want if e]
    if (errs or not finite or out["drift_ratio"] > RING_DRIFT_MAX
            or got[0][0][:1] != want[0][0][:1]
            or n_score != cb.n_layers or n_admit != cb.n_layers):
        raise AssertionError(f"tp (g3): {errs} {out}")
    return out


def plan_dp_legs(group, pb, cb, ecfg2, reqs, to_sampling, dev, out,
                 problems):
    """(g2)'s legs beyond the kernel leg: the products report
    (``dp_products``), then each of TP_F_MODES (the sparse ragged leg,
    the spec engine's masked and kernel verify legs) at TP_DP_SLOTS slots
    against tp = 1 at as many (``plan_burst``: every wave bit-equal, 8 /
    8 streams; B1 launched layers x each replica's verify waves on the
    kernel verify leg, nowhere on the others)."""
    import torch

    from seldon_tpu_torch.servers.engine import InferenceEngine

    out["g2_products"] = dp_products(dev)
    for name, kw in TP_F_MODES:
        t0 = time.perf_counter()
        ek = dataclasses.replace(ecfg2, **kw)
        ref = tp_engine_burst(InferenceEngine(pb, cb, ek, dev), reqs,
                              to_sampling, tap=True)
        tag = f"g2 {name}"
        out[tag] = plan_burst(f"({tag})", group, pb, cb, ek, reqs,
                              to_sampling, ref)
        problems += plan_problems(tag, out[tag], len(reqs),
                                  kernel=kw["ragged_kernel"] == "pallas")
        out[f"{tag}_s"] = time.perf_counter() - t0
        del ref
        gc.collect()
        torch.cuda.empty_cache()


def plan_dp_prefix(group, pb, cb, ecfg2, dev, dense_one, out, problems):
    """(g2)'s prefix caches on 9l (d)'s traffic (the primer alone, then 8
    requests behind its SHARED_LEN-token prompt, TP_PREFIX_NEW greedy
    tokens; the primer runs on replica 1, the burst on both): paged on
    B1's kernel leg (the (g2) engine with the cache on) against tp = 1 at
    as many slots, and the dense slab of 9l (d) against (d)'s own tp = 1
    run ``dense_one`` (the same slots, depth and requests; run here when
    (d) failed). ``plan_burst``'s gates, the trie's counters equal to
    tp = 1's and KV moved between the replicas (``check_replicas`` holds
    every worker's prefix store)."""
    import torch

    from seldon_tpu_torch.servers.engine import InferenceEngine

    reqs, greedy, dense = tp_prefix_traffic(cb)
    paged = dataclasses.replace(ecfg2, prefix_cache=True)
    for tag, ek, ref in (("g2 prefix paged", paged, None),
                         ("g2 prefix dense", dense, dense_one)):
        t0 = time.perf_counter()
        if ref is None:
            ref = tp_engine_burst(InferenceEngine(pb, cb, ek, dev), reqs,
                                  greedy, tap=True, split=1)
        out[tag] = plan_burst(f"({tag})", group, pb, cb, ek, reqs, greedy,
                              ref, split=1)
        problems += plan_problems(tag, out[tag], len(reqs),
                                  kernel=ek.ragged_kernel == "pallas"
                                  and ek.ragged)
        out[f"{tag}_s"] = time.perf_counter() - t0
        del ref
        gc.collect()
        torch.cuda.empty_cache()


def phase_tp_plans(params, cfg, ecfg, reqs, to_sampling, one, dev,
                   dense_prefix_one=None):
    """9l (g): JAX's serving plans on four ranks sharing the one card
    (``TP_PLAN_DEVICES``: gloo staged through host memory), llama3-8b at
    full width on phase 4's weights cut to CUT_LAYERS layers, one spawned
    group laid out on each plan in turn (``MeshGroup.replan``).
    (g1) the auto plan: ``TorchServer``'s own ``_serving_mesh`` over the
    four devices (``MeshPlan.auto(4, llama3-8b)`` = tp 4): 9l (b)'s
    burst, 8 / 8 streams and every wave's logits bit-equal to tp = 1's
    (9l (b)'s run ``one``), B1 on each rank (2 of 8 KV heads) held to
    its plain version and launched layers x wave legs.
    (g2) ``MeshPlan(dp=2, tp=2)`` given to the engine, at TP_DP_SLOTS
    slots (against tp = 1 at as many): 8 / 8 streams and every wave's
    logits bit-equal, every worker's slots equal to rank 0's, B1 as in
    (g1) with each replica's own legs; the sparse ragged leg and both
    verify legs (``plan_dp_legs``); both prefix caches
    (``plan_dp_prefix``, the dense one against 9l (d)'s tp = 1 run
    ``dense_prefix_one``); then the same plan on the dense
    default engine (its decode chunks and admissions cut by slot, their
    batched attention products padded to the whole batch) against tp = 1
    dense at as many slots: 8 / 8 streams, every wave bit-equal, B1
    launched nowhere; and what that padding costs (``dp_pad_cost``).
    (g3) ``TorchServer(mesh_sp=2)``'s ``_mesh_for`` with the ring config
    (sp 2 x tp gcd(2, 8) = 2): ``plan_ring``."""
    import torch

    from seldon_tpu_torch.parallel.mesh import MeshPlan
    from seldon_tpu_torch.servers import mesh_engine, torchserver
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

    devices = [torch.device(d) for d in TP_PLAN_DEVICES]
    real_devices = torchserver.serving_devices
    torchserver.serving_devices = lambda device: devices
    try:
        pb, cb = shallow(params, cfg, CUT_LAYERS)
        srv = torchserver.TorchServer(preset="llama3-8b", device=dev)
        auto = srv._serving_mesh(cb)
        ring_srv = torchserver.TorchServer(preset="llama3-8b", mesh_sp=2,
                                           device=dev)
        sp_mesh = ring_srv._serving_mesh(
            dataclasses.replace(cb, attn_impl="ring"))
    finally:
        torchserver.serving_devices = real_devices
    problems, out, group = [], {}, None
    try:
        t0 = time.perf_counter()
        group = mesh_engine.spawn_group(auto)
        out["spawn_s"] = time.perf_counter() - t0
        out["plans"] = {"g1": dict(auto.shape), "g3": dict(sp_mesh.shape)}
        if auto.shape["tp"] != 4 or auto.devices.size != 4:
            problems.append(f"(g1) the auto plan of 4 devices is "
                            f"{auto.shape}")
        t0 = time.perf_counter()
        out["g1"] = plan_burst("(g1)", group, pb, cb, ecfg, reqs,
                               to_sampling, one)
        problems += plan_problems("g1", out["g1"], len(reqs))
        out["g1_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ecfg2 = dataclasses.replace(ecfg, max_slots=TP_DP_SLOTS)
        one2 = tp_engine_burst(InferenceEngine(pb, cb, ecfg2, dev), reqs,
                               to_sampling, tap=True)
        group.replan(MeshPlan(dp=2, tp=2))
        out["g2"] = plan_burst("(g2)", group, pb, cb, ecfg2, reqs,
                               to_sampling, one2)
        problems += plan_problems("g2", out["g2"], len(reqs))
        del one2
        out["g2_s"] = time.perf_counter() - t0
        plan_dp_legs(group, pb, cb, ecfg2, reqs, to_sampling, dev, out,
                     problems)
        plan_dp_prefix(group, pb, cb, ecfg2, dev, dense_prefix_one, out,
                       problems)
        t0 = time.perf_counter()
        dense = EngineConfig(max_slots=TP_DP_SLOTS,
                             max_seq_len=ecfg.max_seq_len, async_fetch=False)
        one2 = tp_engine_burst(InferenceEngine(pb, cb, dense, dev), reqs,
                               to_sampling, tap=True)
        out["g2_dense"] = plan_burst("(g2) dense", group, pb, cb, dense,
                                     reqs, to_sampling, one2)
        problems += plan_problems("g2 dense", out["g2_dense"], len(reqs),
                                  kernel=False)
        del one2
        out["g2_dense"]["pad_cost"] = dp_pad_cost(cfg, dev)
        out["g2_dense_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        group.replan(MeshPlan(**{a: n for a, n in sp_mesh.shape.items()
                                 if n > 1}))
        out["g3"] = tp_part(lambda: plan_ring(group, pb, cb, reqs,
                                              to_sampling, dev), problems)
        out["g3_s"] = time.perf_counter() - t0
    finally:
        if group is not None:
            group.close()
        gc.collect()
        torch.cuda.empty_cache()
    log(f"tp (g) seconds: spawn {out.get('spawn_s', 0):.1f}, (g1) "
        f"{out.get('g1_s', 0):.1f}, (g2) {out.get('g2_s', 0):.1f}, (g2) "
        + ", ".join(f"{k[3:-2]} {v:.1f}" for k, v in out.items()
                    if k.startswith("g2 ") and k.endswith("_s"))
        + f", (g2) dense {out.get('g2_dense_s', 0):.1f}, (g3) "
        f"{out.get('g3_s', 0):.1f}; {card_line()}")
    if problems:
        raise AssertionError("tp (g): " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# Phase 9n: training (models/train.py)
# ---------------------------------------------------------------------------

TRAIN_SEED = 0
TRAIN_8B_B, TRAIN_8B_S = 1, 512  # one repeated batch of seeded tokens
TRAIN_STEPS = 3
TRAIN_TINY_B, TRAIN_TINY_S = 4, 32
# The CPU tests' tolerances (tests/test_torch_train.py): against JAX and
# between layouts.
TRAIN_LOSS_ATOL = 2e-3
TRAIN_NORM_RTOL = 5e-3
TRAIN_PARAM_ATOL = 2e-3
# First-step gradients (tests/test_torch_train.py check_grads): element
# by element within JAX's rtol 5e-2 and an atol of 5e-2 x the leaf's
# largest |g| (at most JAX's 5e-3), and the norm of the difference
# within 5e-2 of the leaf's norm.
TRAIN_GRAD_RTOL, TRAIN_GRAD_ATOL = 5e-2, 5e-3
# Step 2 of (a): |du| <= 1.0004 for Adam's direction at count 2 (b1 0.9,
# b2 0.95), plus the per-operation bf16 rounding of the update.
TRAIN_STEP_SLACK = 1.05
# (name, preset, mesh plan, attn_impl) of the two-rank layouts of (c).
TRAIN_LAYOUTS = (("dp2", "tiny", dict(dp=2), "xla"),
                 ("tp2", "tiny", dict(tp=2), "xla"),
                 ("sp2-ring", "tiny", dict(sp=2), "ring"),
                 ("sp2-xla", "tiny", dict(sp=2), "xla"),
                 ("ep2", "tiny-moe", dict(ep=2), "xla"),
                 ("pp2", "tiny", dict(pp=2), "xla"))
TRAIN_DEVICES = ("cuda:0", "cuda:0")  # two ranks sharing the one card
# 9n (e1): llama3-8b at full width in float32, depth cut to fit one card:
# 16 B a parameter (f32 weights, gradients, mu, nu) x 2.796e9 at 8 layers
# = 44.7e9 B before activations (the full 32 layers would need 128e9 B).
TRAIN_F32_LAYERS = 8
TRAIN_F32_PEAK_MAX = 60e9
# 9n (e2), (e3): float32 tolerances (tests/test_torch_f32_train.py and
# test_torch_train.F32_LAYOUT): sums in other orders only.
TRAIN_F32_TOL = dict(loss_atol=1e-5, norm_rtol=1e-5, grad_rtol=1e-4,
                     param_atol=2e-5)


def train_batch(vocab, B, S, seed=1):
    import numpy as np

    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[: B // 2, :5] = 0.0
    return tokens, mask


def leaf_digests(params):
    """(sum, sum of squares) of every leaf's raw bits, by leaf: equal
    digests before and after an update with lr 0 say it changed no bit
    (a sum over 16-bit words in int64 chunks; no copy of the weights)."""
    import torch

    from seldon_tpu_torch.models.train import _chunks
    from seldon_tpu_torch.parallel.sharding import leaves

    out = {}
    for path, name, t in leaves(params):
        bits = t.detach().view(torch.int16 if t.element_size() == 2
                               else torch.int32)
        s1 = s2 = 0
        for c in _chunks(bits):
            c = c.long()
            s1 += int(c.sum())
            s2 += int((c * c).sum())
        out[f"{path}{name}"] = (s1, s2)
    return out


def update_probe(train, stats):
    """Wraps ``train._adamw_chunk`` for one update: every element's move
    |dp| against the most the step's learning rate allows, lr x
    (TRAIN_STEP_SLACK + wd |p|) + half an ulp of the parameter's dtype
    at max(|p|, |p_new|); the elements moved (bf16 apart); and sum(g x
    dp), the loss change the update predicts to first order. Returns
    the real function, to put back."""
    import torch

    real = train._adamw_chunk
    mant = {torch.bfloat16: 8, torch.float32: 24}

    def probed(p, g, mu, nu, c, norm, clip, decay):
        before = p.to(torch.float32, copy=True)  # f32 leaves: not an alias
        real(p, g, mu, nu, c, norm, clip, decay)
        d = p.float() - before
        _, e = torch.frexp(torch.maximum(before.abs(), (before + d).abs()))
        half_ulp = torch.ldexp(torch.ones_like(d), e - mant[p.dtype] - 1)
        wd = float(c["wd"]) if decay else 0.0
        allowed = abs(float(c["step"])) * (TRAIN_STEP_SLACK
                                           + wd * before.abs()) + half_ulp
        k = "bf16" if p.dtype == torch.bfloat16 else "f32"
        stats[f"n_{k}"] += d.numel()
        stats[f"moved_{k}"] += int((d != 0).sum())
        stats[f"first_order_{k}"] += float((g.float() * d).sum())
        stats["max_abs_dp"] = max(stats["max_abs_dp"], float(d.abs().max()))
        stats["over_allowed"] += int((d.abs() > allowed).sum())
        stats["lr"] = abs(float(c["step"]))

    train._adamw_chunk = probed
    return real


def train_8b_run(dev, warmup, cfg=None):
    """llama3-8b at full width (``cfg``: its full depth in bf16 by
    default), remat on: the seeded init and TRAIN_STEPS steps on one
    repeated batch, each step's optimizer update timed (synchronized on
    both sides)."""
    import torch

    from seldon_tpu_torch.models import train
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.parallel import mesh
    from seldon_tpu_torch.parallel.sharding import leaves

    cfg = cfg or get_config("llama3-8b")
    opt = train.make_optimizer(total_steps=10, warmup=warmup)
    real_update, update_s = opt.update, []

    def timed_update(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = real_update(*a, **kw)
        torch.cuda.synchronize()
        update_s.append(time.perf_counter() - t0)
        return res

    opt.update = timed_update
    init_fn, step_fn = train.make_sharded_train_step(
        mesh.make_mesh(mesh.MeshPlan(), [dev]), cfg, opt, device=dev)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_fn(TRAIN_SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    gc.collect()
    torch.cuda.empty_cache()
    ready = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tokens, mask = train_batch(cfg.vocab_size, TRAIN_8B_B, TRAIN_8B_S)
    before = leaf_digests(state.params)
    losses, norms, step_s = [], [], []
    unchanged = None
    step2 = {"n_bf16": 0, "n_f32": 0, "moved_bf16": 0, "moved_f32": 0,
             "first_order_bf16": 0.0, "first_order_f32": 0.0,
             "max_abs_dp": 0.0, "over_allowed": 0, "lr": None}
    for i in range(TRAIN_STEPS):
        real = update_probe(train, step2) if i == 1 else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            state, m = step_fn(state, tokens, mask)
            torch.cuda.synchronize()
        finally:
            if real is not None:
                train._adamw_chunk = real
        step_s.append(time.perf_counter() - t0)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
        log(f"train-8b warmup={warmup} step {i + 1}: loss {m['loss']} "
            f"grad_norm {m['grad_norm']} {step_s[-1]:.3f} s")
        if i == 0:
            unchanged = leaf_digests(state.params) == before
    peak = torch.cuda.max_memory_allocated()
    step2["measured_dloss"] = losses[2] - losses[1]
    step2["first_order_dloss"] = (step2["first_order_bf16"]
                                  + step2["first_order_f32"])
    log(f"train-8b warmup={warmup} step 2's update (probed): {step2}")
    opt.update = real_update
    n_params = sum(t.numel() for *_, t in leaves(state.params))
    steady = sum(step_s[2:]) / len(step_s[2:])  # step 2 ran the probe
    return {"warmup": warmup, "layers": cfg.n_layers, "dtype": cfg.dtype,
            "n_params": n_params, "optimizer_s": update_s,
            "B": TRAIN_8B_B, "S": TRAIN_8B_S, "losses": losses,
            "grad_norms": norms, "step_s": step_s, "init_s": init_s,
            "init_peak_bytes": init_peak, "ready_bytes": ready,
            "peak_bytes": peak, "steady_step_s": steady,
            "step2_update": step2,
            "tokens_per_s": TRAIN_8B_B * TRAIN_8B_S / steady,
            "step1_bit_equal": unchanged}


def train_8b(dev):
    """9n (a) and (e1), in a fresh process (``chip_smoke.py --train-8b``):
    the run with JAX's test optimizer (``make_optimizer(total_steps=10)``,
    warm-up 100); when its loss does not descend (a warm-up-sized step
    below what bf16 weights resolve), the numbers are kept and the run is
    made again with warmup=1. Then, every tensor of (a) freed, (e1)
    (``train_f32_8b``)."""
    import math

    import torch

    runs = [train_8b_run(dev, 100)]
    if not runs[0]["losses"][-1] < runs[0]["losses"][0]:
        log("train-8b: the warm-up-sized steps did not move the loss; "
            "again with warmup=1")
        gc.collect()
        torch.cuda.empty_cache()
        runs.append(train_8b_run(dev, 1))
    for r in runs:
        if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
            raise AssertionError(f"train-8b: non-finite {r}")
        if not r["step1_bit_equal"]:
            raise AssertionError("train-8b: step 1 (lr 0) changed a weight")
        if r["step2_update"]["over_allowed"]:
            raise AssertionError(f"train-8b: step 2 moved weights further "
                                 f"than its lr allows: {r['step2_update']}")
    if not runs[-1]["losses"][-1] < runs[-1]["losses"][0]:
        raise AssertionError(f"train-8b: loss did not descend: "
                             f"{runs[-1]['losses']}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    f32 = train_f32_8b(dev)
    f32["seconds"] = time.perf_counter() - t0
    return {"runs": runs, "f32": f32}


def train_f32_8b(dev):
    """9n (e1), in (a)'s process once (a)'s tensors are freed:
    llama3-8b at full width and TRAIN_F32_LAYERS layers in float32, one
    rank, remat, B 1 x S 512, JAX's test optimizer. Gates: TF32 off for
    f32 products (PyTorch's flag and the f32 matmul precision); step 1
    (lr 0) leaves every weight's bits; step 2 moves no element further
    than its lr allows; the losses finite and descending; the peak at
    most TRAIN_F32_PEAK_MAX."""
    import math

    import torch

    from seldon_tpu_torch.models.config import get_config

    tf32 = {"allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "float32_matmul_precision": torch.get_float32_matmul_precision()}
    if tf32 != {"allow_tf32": False, "float32_matmul_precision": "highest"}:
        raise AssertionError(f"train f32 8b: TF32 on for f32 products {tf32}")
    cfg = dataclasses.replace(get_config("llama3-8b"),
                              n_layers=TRAIN_F32_LAYERS, dtype="float32")
    r = train_8b_run(dev, 100, cfg)
    r["tf32"] = tf32
    if not all(math.isfinite(x) for x in r["losses"] + r["grad_norms"]):
        raise AssertionError(f"train f32 8b: non-finite {r}")
    if not r["step1_bit_equal"]:
        raise AssertionError("train f32 8b: step 1 (lr 0) changed a weight")
    if r["step2_update"]["over_allowed"]:
        raise AssertionError(f"train f32 8b: step 2 moved weights further "
                             f"than its lr allows: {r['step2_update']}")
    if not r["losses"][-1] < r["losses"][0]:
        raise AssertionError(f"train f32 8b: losses not descending "
                             f"{r['losses']}")
    if r["peak_bytes"] > TRAIN_F32_PEAK_MAX:
        raise AssertionError(f"train f32 8b: peak {r['peak_bytes']} B over "
                             f"{TRAIN_F32_PEAK_MAX:.3g}")
    return r


def train_tiny_steps(cfg, tree, dev, tokens, mask):
    """TRAIN_STEPS one-rank steps on ``dev`` from the numpy state ``tree``
    (``train.spmd_steps`` on a group of one)."""
    import types

    from seldon_tpu_torch.models import train
    from seldon_tpu_torch.parallel.distributed import RankGroup

    return train.spmd_steps(types.SimpleNamespace(ranks=RankGroup.solo(dev)),
                            {}, cfg, tree, tokens, mask, TRAIN_STEPS,
                            dict(total_steps=10, warmup=1))


def bf16_f32(a):
    import numpy as np
    import torch

    if a.dtype in (np.int16, np.uint16):
        return torch.from_numpy(a.view(np.int16)).view(
            torch.bfloat16).float().numpy()
    return a


def train_close(name, got, ref, cut=None, loss_atol=TRAIN_LOSS_ATOL,
                norm_rtol=TRAIN_NORM_RTOL, grad_rtol=TRAIN_GRAD_RTOL,
                param_atol=TRAIN_PARAM_ATOL):
    """``got`` (a run or one rank's) against ``ref`` within the CPU
    tests' tolerances (bf16's by default); ``cut(key, whole)`` gives the
    rank's part of a reference leaf. Returns the largest differences."""
    import numpy as np

    dl = max(abs(a - b) for a, b in zip(got["losses"], ref["losses"]))
    dn = max(abs(a - b) / b for a, b in zip(got["grad_norms"],
                                           ref["grad_norms"]))
    dp = 0.0
    for key, mine in got["params"].items():
        want = ref["params"][key] if cut is None else cut(key, ref["params"][
            key])
        dp = max(dp, float(np.max(np.abs(bf16_f32(mine) - bf16_f32(want)))))
    dg = over = 0.0
    for key, mine in got["grads"].items():
        want = ref["grads"][key] if cut is None else cut(key, ref["grads"][
            key])
        atol = min(TRAIN_GRAD_ATOL, grad_rtol * float(np.abs(want).max()))
        over = max(over, float(np.max(np.abs(mine - want) - atol
                                      - grad_rtol * np.abs(want))))
        dg = max(dg, float(np.linalg.norm(mine - want)
                           / max(np.linalg.norm(want), 1e-30)))
    if (dl > loss_atol or dn > norm_rtol or dp > param_atol
            or over > 0 or dg > grad_rtol
            or got["grads"].keys() != got["params"].keys()):
        raise AssertionError(f"train {name}: loss diff {dl}, grad-norm "
                             f"rel diff {dn}, param diff {dp}, gradient "
                             f"rel diff {dg} (elementwise excess {over})")
    return {"max_loss_diff": dl, "max_norm_rel_diff": dn,
            "max_param_diff": dp, "max_grad_rel_diff": dg}


def train_tiny_card_vs_cpu(dev, dtype="bfloat16"):
    """9n (b) (and (e2) in float32): tiny and tiny-moe on the card against
    the port on the CPU from one carried state (the seeded init made on
    the CPU)."""
    import torch

    from seldon_tpu_torch.models import train
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.parallel import mesh

    tol = TRAIN_F32_TOL if dtype == "float32" else {}
    out, refs = {}, {}
    for preset in ("tiny", "tiny-moe"):
        cfg = dataclasses.replace(get_config(preset), dtype=dtype)
        init_fn, _ = train.make_sharded_train_step(
            mesh.make_mesh(mesh.MeshPlan(), ["cpu"]), cfg,
            train.make_optimizer(), device="cpu")
        tree = train.state_tree(init_fn(TRAIN_SEED))
        tokens, mask = train_batch(cfg.vocab_size, TRAIN_TINY_B,
                                   TRAIN_TINY_S)
        card = train_tiny_steps(cfg, tree, dev, tokens, mask)
        cpu = train_tiny_steps(cfg, tree, torch.device("cpu"), tokens, mask)
        out[preset] = dict(train_close(f"{dtype} {preset} card vs CPU",
                                       card, cpu, **tol),
                           losses=card["losses"])
        if not card["losses"][-1] < card["losses"][0]:
            raise AssertionError(f"train {preset}: loss did not descend "
                                 f"{card['losses']}")
        refs[preset] = (tree, tokens, mask, card)
    log(f"train {'(e2)' if tol else '(b)'} {dtype} card vs CPU: {out}")
    return out, refs


def train_layouts(refs_by_dtype, dev):
    """9n (c) and (e3): two ranks sharing the card (gloo, staged through
    host buffers), one group for both; each layout in bf16 held to (b)'s
    one-rank step on the card and in float32 to (e2)'s; every leaf a
    layout replicates bit-equal on the two ranks. Returns the results by
    dtype."""
    import numpy as np

    from seldon_tpu_torch.models import train
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.parallel import mesh, pipeline, sharding
    from seldon_tpu_torch.servers import mesh_engine

    group = mesh_engine.spawn_group(
        mesh.make_mesh(mesh.MeshPlan(dp=2), list(TRAIN_DEVICES)))
    out = {dtype: {} for dtype in refs_by_dtype}
    try:
        for (dtype, refs), (name, preset, plan, impl) in itertools.product(
                refs_by_dtype.items(), TRAIN_LAYOUTS):
            tol = TRAIN_F32_TOL if dtype == "float32" else {}
            cfg = dataclasses.replace(get_config(preset), attn_impl=impl,
                                      dtype=dtype)
            tree, tokens, mask, ref = refs[preset]
            pp = plan.get("pp", 1)
            t0 = time.perf_counter()
            ranks = group.spmd("seldon_tpu_torch.models.train:spmd_steps",
                               plan, cfg, tree, tokens, mask, TRAIN_STEPS,
                               dict(total_steps=10, warmup=1), pp == 1, 2)
            wall = time.perf_counter() - t0
            specs = (pipeline.pp_param_pspecs(cfg) if pp > 1
                     else sharding.param_pspecs(cfg))
            sizes = {a: plan.get(a, 1) for a in mesh.AXES}
            res = {"wall_s": wall}
            for r in ranks:
                def cut(key, whole, coord=r["coord"]):
                    import torch

                    spec = sharding.leaf_spec(specs, *key)
                    return sharding.cut(torch.from_numpy(whole),
                                        spec[1:] if key[0] else spec, coord,
                                        sizes).numpy()

                res[f"rank{r['coord']}"] = train_close(
                    f"{dtype} {name} rank {r['coord']}", r, ref, cut, **tol)
            replicated = 0
            for kind in ("params", "mu", "nu"):
                for key in set(ranks[0][kind]) & set(ranks[1][kind]):
                    spec = sharding.leaf_spec(specs, *key)
                    axes = {a for part in spec if part
                            for a in ((part,) if isinstance(part, str)
                                      else part)}
                    if any(ranks[0]["coord"][a] != ranks[1]["coord"][a]
                           for a in axes):
                        continue  # two shards, not two replicas
                    if not np.array_equal(ranks[0][kind][key],
                                          ranks[1][kind][key]):
                        raise AssertionError(f"train {name}: replicated "
                                             f"{kind} {key} differs")
                    replicated += 1
            res["replicated_leaves_bit_equal"] = replicated
            out[dtype][name] = res
            log(f"train {'(e3)' if tol else '(c)'} {dtype} {name}: {res}")
    finally:
        group.close()
    return out


def train_flash_raises(dev):
    """9n (d): no fallback — the training route under attn_impl="flash"
    on the card raises, naming the missing backward kernel."""
    import numpy as np

    from seldon_tpu_torch.models import train
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.parallel import mesh

    cfg = dataclasses.replace(get_config("tiny"), attn_impl="flash")
    init_fn, step_fn = train.make_sharded_train_step(
        mesh.make_mesh(mesh.MeshPlan(), [dev]), cfg, train.make_optimizer(),
        device=dev)
    state = init_fn(TRAIN_SEED)
    try:
        step_fn(state, np.zeros((1, 128), np.int32),
                np.ones((1, 128), np.float32))
    except NotImplementedError as e:
        if "backward" not in str(e):
            raise
        log(f"train (d) flash raises: {e}")
        return str(e)
    raise AssertionError("train (d): flash training on the card did not "
                         "raise")


def phase_train(dev):
    """9n: training (``models/train.py``), before phase 4 loads a model.
    (a) llama3-8b, 32 layers, bf16, one rank, remat, in a fresh process
    (``--train-8b``): step 1 (lr 0) leaves every weight's bits, losses
    finite and descending; peak memory, step seconds and tokens/s
    reported. (b) tiny and tiny-moe on the card against the CPU from one
    carried state. (c) the two-rank layouts of TRAIN_LAYOUTS on the one
    card, each against (b). (d) flash training raises. (e) float32: (e1)
    llama3-8b at TRAIN_F32_LAYERS layers in (a)'s process after (a); (e2)
    tiny and tiny-moe on the card against the CPU; (e3) the layouts
    against (e2), in (c)'s group."""
    import torch

    free, total = torch.cuda.mem_get_info()
    log(f"train: card memory free {free / 2**30:.2f} GiB of "
        f"{total / 2**30:.2f} GiB before (a)")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--train-8b"], capture_output=True, text=True,
                          timeout=600)
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"train-8b failed: {proc.stderr[-3000:]}")
    a = json.loads(proc.stdout.splitlines()[-1])
    a["process_s"] = time.perf_counter() - t0
    a["free_bytes_before"] = free
    for r in a["runs"]:
        log(f"train (a) llama3-8b warmup={r['warmup']}: losses {r['losses']}"
            f", peak {r['peak_bytes'] / 1e9:.2f} GB (init peak "
            f"{r['init_peak_bytes'] / 1e9:.2f} GB, ready "
            f"{r['ready_bytes'] / 1e9:.2f} GB), steady step "
            f"{r['steady_step_s']:.3f} s, {r['tokens_per_s']:.1f} tokens/s")
    e1 = a.pop("f32")
    log(f"train (e1) llama3-8b f32 {e1['layers']} layers, "
        f"{e1['n_params']} parameters: losses {e1['losses']}, peak "
        f"{e1['peak_bytes']} B (init peak {e1['init_peak_bytes']} B, ready "
        f"{e1['ready_bytes']} B), steps {[round(x, 3) for x in e1['step_s']]}"
        f" s, optimizer {[round(x, 3) for x in e1['optimizer_s']]} s, "
        f"{e1['tokens_per_s']:.1f} tokens/s, TF32 {e1['tf32']}; "
        f"{e1['seconds']:.1f} s; {card_line()}")
    b, refs = train_tiny_card_vs_cpu(dev)
    t0 = time.perf_counter()
    e2, refs32 = train_tiny_card_vs_cpu(dev, "float32")
    e2_s = time.perf_counter() - t0
    layouts = train_layouts({"bfloat16": refs, "float32": refs32}, dev)
    d = train_flash_raises(dev)
    e = {"e1": e1, "e2": e2, "e3": layouts["float32"],
         "seconds": {"e1": e1["seconds"], "e2": e2_s}}
    return {"a": a, "b": b, "c": layouts["bfloat16"], "d": d, "e": e}


# ---------------------------------------------------------------------------
# Phase f32: a float32 llama3-8b (A30) and the layer-by-layer int8 init
# (A16), in a fresh process
# ---------------------------------------------------------------------------

A16_SLACK = 1.05  # A16's peak over the int8 tree plus its largest f32 draw
F32_SCORE_S = 2048  # the f32 score call: B 1 x S 2048
F32_LEG_LAYERS = 2  # depth of the f32 legs' comparison
# The f32 kernel leg's median |logit diff| to the masked leg, at most this
# many times the f32 nudge floor (the masked leg against itself with one
# embedding value moved by one f32 ulp): phase 6's rule for bf16.
F32_DRIFT_MAX = 2.0


def a16_init(dev):
    """A16: ``quantize.init_params_int8`` builds llama3-8b's int8 tree on
    the card leaf by leaf. Gates: the peak allocated memory over the build
    is at most A16_SLACK x (the tree's bytes + the embedding's f32 draw,
    its largest single draw); a forward on 16 tokens is finite."""
    import torch

    from seldon_tpu_torch.models import quantize, transformer
    from seldon_tpu_torch.models.config import get_config

    cfg = get_config("llama3-8b")
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = quantize.init_params_int8(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    tree = param_bytes(params)
    draw = cfg.vocab_size * cfg.d_model * 4
    logits = transformer.forward(params, torch.arange(3, 19, device=dev)[None],
                                 cfg)
    finite = bool(torch.isfinite(logits).all())
    del params, logits
    gc.collect()
    torch.cuda.empty_cache()
    out = {"build_s": build_s, "peak_bytes": peak, "tree_bytes": tree,
           "largest_draw_bytes": draw,
           "limit_bytes": A16_SLACK * (tree + draw),
           "peak_over_tree_and_draw": peak / (tree + draw),
           "forward_finite": finite}
    log(f"f32 A16: init_params_int8 llama3-8b in {build_s:.1f} s, peak "
        f"{peak} B against the int8 tree {tree} B + the embedding's f32 "
        f"draw {draw} B (ratio {out['peak_over_tree_and_draw']:.4f}, limit "
        f"{A16_SLACK}); forward finite {finite}")
    if peak > out["limit_bytes"] or not finite:
        raise AssertionError(f"A16's int8 init: {out}")
    return out


def f32_burst(eng, reqs, to_sampling):
    """Phase 4's requests at once through ``eng``: (results, wall s, the
    engine's waves and prefill waves in the burst)."""
    before = eng.stats.snapshot()
    results, wall = run_concurrent(
        lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                        to_sampling(r)), reqs, timeout_s=600)
    wait_idle(eng)
    snap = eng.stats.snapshot()
    return results, wall, {k: snap[k] - before[k] for k in (
        "decode_dispatches", "prefill_waves", "completed")}, snap


def f32_score_launch(cfg, dev):
    """One B2 f32 launch at the f32 score call's shape (B 1 x S
    F32_SCORE_S, llama3-8b heads, causal), seeded: its time (mean of 20
    launches) beside its two bounds and f32 SDPA's time (the yardstick;
    the port never calls it), held to its plain version."""
    import torch
    import torch.nn.functional as F

    from seldon_tpu_torch.ops import flash_attention as fa

    H, Hkv, Dh, G = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv
    S = F32_SCORE_S
    gen = torch.Generator(device=dev).manual_seed(300)
    q, k, v = (torch.randn((n, S, Dh), generator=gen, device=dev)
               for n in (H, Hkv, Hkv))
    got = fa.flash_kernel(q, k, v, True, 0, q_per_kv=G)
    out = compare_flash(got, fa.flash_blockwise(q, k, v, True, 0,
                                                q_per_kv=G))
    ms = cuda_time_ms(lambda: fa.flash_kernel(q, k, v, True, 0, q_per_kv=G),
                      reps=20, warmup=3)
    q4, k4, v4 = (t.view(1, -1, S, Dh) for t in (q, k, v))
    sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), reps=20, warmup=3)
    nbytes, ops = flash_work(q, k, True, 0)
    row = dict(out, B=1, S=S, H=H, Hkv=Hkv, Dh=Dh, ms=ms, library_ms=sdpa_ms,
               bytes=nbytes, ops=ops,
               **f32_bounds(nbytes / HBM_BYTES_PER_S * 1e3, ops, "f32"))
    row["bound_ms"] = row["bound_3xtf32_ms"]
    row["bound_by"] = row["bound_3xtf32_by"]
    row["card"] = card_line()
    log(f"f32 (b) one B2 f32 launch at B 1 x S {S} (H {H}, Hkv {Hkv}, Dh "
        f"{Dh}, causal): max_abs={out['max_abs_err']:.3g} (tol "
        f"{TOL_FLASH_F32}) sdpa_f32_ms={sdpa_ms:.4f} "
        + f32_bounds_text(row, ms))
    if not out["ok"]:
        raise AssertionError(f"B2 f32 at the score shape: {row}")
    del q, k, v, got
    torch.cuda.empty_cache()
    return row


def f32_8b(dev):
    """The float32 llama3-8b, seeded, at full depth (32.1 GB of f32
    weights and a 32-slot x 2048-position f32 pool, 17.2 GB), in this
    process alone. A16 first (``a16_init``), before the f32 model loads.
    (a) Burst: phase 4's 8 requests through ``InferenceEngine(ragged,
    paged, chunked, ragged_kernel="pallas")``: B1's f32 route launched
    exactly layers x wave legs, the bf16 route never; tokens/s, TTFT,
    weight bytes and peak memory reported; then the same burst again with
    every B1 launch held to its plain version on its own inputs (f32
    tolerances). (b) Score: one ``forward`` at B 1 x S 2048 under
    ``attn_impl="flash"``: B2's f32 route launched once per layer, each
    launch held to its plain version. (c) The legs on the weights cut to
    F32_LEG_LAYERS layers (``run_legs``): the kernel leg's median logit
    difference to the masked leg at most F32_DRIFT_MAX times the f32
    nudge floor; greedy streams of kernel and masked legs reported
    (ROADMAP.md C1, asked in f32)."""
    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.ops import flash_attention as fa
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.engine import InferenceEngine
    from seldon_tpu_torch.servers.torchserver import TorchServer, score_nll

    start = time.perf_counter()
    secs = {}  # seconds of each part, reported
    out = {"a16": a16_init(dev), "part_s": secs}
    secs["a16"] = time.perf_counter() - start
    cfg = dataclasses.replace(get_config("llama3-8b"), dtype="float32")
    ecfg = serve_server(dev)._engine_config(cfg)  # phase 4's engine knobs
    to_sampling = functools.partial(TorchServer._to_sampling, None)
    f32, bf16 = torch.float32, torch.bfloat16
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = transformer.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize()
    a = {"load_s": time.perf_counter() - t0,
         "weight_bytes": param_bytes(params),
         "load_peak_bytes": torch.cuda.max_memory_allocated()}
    reqs = requests(cfg.vocab_size)

    # (a) the burst, timed and counted; then again under the tap.
    eng = InferenceEngine(params, cfg, ecfg, dev)
    eng.start()
    try:
        rpa.launches = 0
        rpa.entry_launches.update({f32: 0, bf16: 0})
        results, wall, legs, snap = f32_burst(eng, reqs, to_sampling)
        launches = dict(rpa.entry_launches)
        expected = cfg.n_layers * (legs["decode_dispatches"]
                                   + legs["prefill_waves"])
        toks = [r["token_ids"] for r in results]
        n_tok = sum(len(t) for t in toks)
        a.update(waves=legs["decode_dispatches"],
                 prefill_waves=legs["prefill_waves"],
                 launches_f32=launches[f32], launches_bf16=launches[bf16],
                 expected_launches=expected, tokens=n_tok, wall_s=wall,
                 tokens_per_s=n_tok / wall,
                 mean_ttft_ms=snap["mean_ttft_ms"],
                 peak_bytes=torch.cuda.max_memory_allocated())
        secs["load_and_burst"] = (time.perf_counter() - start
                                  - secs["a16"])
        t1 = time.perf_counter()
        tap = KernelTap(cfg.n_layers, every=True)
        with tap:
            legs2 = f32_burst(eng, reqs, to_sampling)[2]
        secs["tapped_burst"] = time.perf_counter() - t1
    finally:
        eng.stop()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    a["tap"] = {"checked": tap.checked, "errors": tap.errs,
                "calls": tap.launched, "expected": cfg.n_layers * (
                    legs2["decode_dispatches"] + legs2["prefill_waves"])}
    out["a"] = a
    log(f"f32 (a) llama3-8b f32: weights {a['weight_bytes']} B (load "
        f"{a['load_s']:.1f} s, peak {a['load_peak_bytes']} B); burst of "
        f"{len(reqs)} requests: waves {a['waves']} prefill waves "
        f"{a['prefill_waves']}, B1 f32 launches {a['launches_f32']} "
        f"(expected {expected}), bf16 {a['launches_bf16']}; tokens "
        f"{n_tok} in {wall:.3f} s = {a['tokens_per_s']:.1f} tokens/s, mean "
        f"TTFT {a['mean_ttft_ms']:.1f} ms, peak {a['peak_bytes']} B")
    for leg, e in sorted(tap.errs.items()):
        log(f"f32 (a) B1 f32 route on the burst's own inputs, {leg} leg: "
            f"{tap.checked[leg]} launches checked (every layer), err "
            f"m_rel={e[0]:.3g} l_rel={e[1]:.3g} acc/l={e[2]:.3g}")
    if (a["launches_f32"], a["launches_bf16"]) != (expected, 0):
        raise AssertionError(f"f32 burst: B1 launches {launches} != layers "
                             f"x wave legs {expected} on the f32 route")
    if any(not t for t in toks) or any(not 0 <= x < cfg.vocab_size
                                       for t in toks for x in t):
        raise AssertionError("f32 burst: a request returned no tokens or "
                             "a token outside the vocabulary")
    if tap.launched != a["tap"]["expected"] or min(
            tap.checked.values()) == 0 or not all(
            f32_partials_ok(e) for e in tap.errs.values()):
        raise AssertionError(f"f32 burst: B1's f32 route against its plain "
                             f"version: {a['tap']}")

    # (b) one score call under flash: B2's f32 route, every layer checked.
    t1 = time.perf_counter()
    flash = dataclasses.replace(cfg, attn_impl="flash")
    score_toks = torch.randint(0, cfg.vocab_size, (1, F32_SCORE_S),
                               generator=torch.Generator(
                                   device=dev).manual_seed(7), device=dev)
    ftap = FlashTap(cfg.n_layers, every=True)
    fa.reset_launches()
    with ftap:
        nll = score_nll(params, score_toks, flash)
    torch.cuda.synchronize()
    b_launches = dict(fa.entry_launches)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    score_nll(params, score_toks, flash)
    end.record()
    end.synchronize()
    b = {"B": 1, "S": F32_SCORE_S, "nll": nll.tolist(),
         "launches_f32": b_launches["flash_attention_f32_fwd"],
         "launches_bf16": b_launches["flash_attention_bf16_fwd"],
         "checked": len(ftap.checks),
         "max_abs_err": max(c["max_abs_err"] for c in ftap.checks),
         "call_ms": start.elapsed_time(end)}
    out["b"] = b
    log(f"f32 (b) score B 1 x S {F32_SCORE_S} flash: B2 f32 launches "
        f"{b['launches_f32']} (expected {cfg.n_layers}), bf16 "
        f"{b['launches_bf16']}; every launch checked ({b['checked']}), max "
        f"|err| {b['max_abs_err']:.3g} (tol {TOL_FLASH_F32}); nll "
        f"{[round(x, 5) for x in b['nll']]}, call {b['call_ms']:.1f} ms")
    if ((b["launches_f32"], b["launches_bf16"]) != (cfg.n_layers, 0)
            or b["checked"] != cfg.n_layers
            or not all(c["ok"] for c in ftap.checks)
            or not all(map(math.isfinite, b["nll"]))):
        raise AssertionError(f"f32 score: {b}")
    b["timed"] = f32_score_launch(cfg, dev)

    # (c) the legs at F32_LEG_LAYERS layers.
    secs["score"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    greedy = reqs[:N_GREEDY]
    p_n, cfg_n = shallow(params, cfg, F32_LEG_LAYERS)
    legs_n, _ = run_legs(p_n, cfg_n, ecfg, dev, greedy, to_sampling)
    secs["legs"] = time.perf_counter() - t1
    floor = legs_n["nudged_vs_masked"]["median_logit_diff"]
    drift = legs_n["kernel_vs_masked"]["median_logit_diff"]
    c = {"layers": F32_LEG_LAYERS, "legs": legs_n,
         "kernel_vs_masked_over_floor": drift / max(floor, 1e-30),
         "streams_equal_at_2": legs_n["kernel_vs_masked"]["equal"],
         "of": len(greedy)}
    out["c"] = c
    log(f"f32 (c) {F32_LEG_LAYERS} layers: kernel vs masked median |dlogit| "
        f"{drift:.4g}, f32 nudge floor {floor:.4g} (ratio "
        f"{c['kernel_vs_masked_over_floor']:.3f}, max {F32_DRIFT_MAX}); "
        f"greedy streams kernel == masked: {c['streams_equal_at_2']}/"
        f"{len(greedy)} at {F32_LEG_LAYERS} layers (reported)")
    log("f32 seconds by part: " + ", ".join(f"{k} {v:.1f}"
                                            for k, v in secs.items()))
    if drift > F32_DRIFT_MAX * floor:
        raise AssertionError(f"f32 kernel leg beyond {F32_DRIFT_MAX}x the "
                             f"nudge floor: {drift} vs {floor}")
    return out


def phase_f32(dev):
    """The f32 phase in a fresh process (``--f32-8b``): phase 4's model
    in f32 needs ~50 GB, beside which this process holds little yet."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--f32-8b"], capture_output=True, text=True,
                          timeout=900)
    for line in proc.stdout.splitlines()[:-1]:
        log(f"  {line}")
    if proc.returncode != 0:
        raise AssertionError(f"f32-8b failed: {proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.splitlines()[-1])
    out["process_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 9m: the control plane — a SeldonDeployment reconciled into pods
# ---------------------------------------------------------------------------

OP_KV_POOL_MB = 512  # each pod's KV pool: 256 blocks of 16 positions
OP_READY_S = 240.0  # a pod that is not serving by then fails the phase
OP_MEM_SLACK = 512 << 20  # bytes of free card memory a teardown may lose
OP_UNIT = "model"  # the single-model template's unit
OP_PRESET = "llama3-8b"  # the pods' preset, seeded as phase 4's
OP_PROBE = "local/chip_smoke_unit.B1ProbeServer:1"
OP_TORCHSERVER = "local/seldon_tpu_torch.servers.torchserver.TorchServer:1"


def op_parameters(**extra):
    """A unit's parameters: phase 4's engine configuration with a small
    KV pool (two pods and the kept weights share the card)."""
    params = dict(max_slots=32, max_seq_len=2048, ragged=1,
                  ragged_kernel="pallas", kv_pool_mb=OP_KV_POOL_MB, **extra)
    types = {str: "STRING", int: "INT"}
    return [{"name": k, "value": str(v), "type": types[type(v)]}
            for k, v in params.items()]


def op_free():
    import torch

    return torch.cuda.mem_get_info()[0]


@contextlib.contextmanager
def pod_logs(path):
    """Pods spawned inside the block write their stdout and stderr to
    ``path`` (the store lets them inherit this process's descriptors when
    SELDON_TPU_LOCALSTORE_DEBUG=1); this script's own output is back on
    its descriptors after the block."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = (os.dup(1), os.dup(2))
    old = os.environ.get("SELDON_TPU_LOCALSTORE_DEBUG")
    os.environ["SELDON_TPU_LOCALSTORE_DEBUG"] = "1"
    with open(path, "ab") as f:
        os.dup2(f.fileno(), 1)
        os.dup2(f.fileno(), 2)
    try:
        yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        os.close(saved[0])
        os.close(saved[1])
        if old is None:
            os.environ.pop("SELDON_TPU_LOCALSTORE_DEBUG", None)
        else:
            os.environ["SELDON_TPU_LOCALSTORE_DEBUG"] = old


def op_wait(cond, timeout_s, what):
    deadline = time.perf_counter() + timeout_s
    while not cond():
        if time.perf_counter() > deadline:
            raise AssertionError(f"operator: {what} not within {timeout_s} s")
        time.sleep(0.1)


def op_reconcile(rec, store, sdep, log_path):
    """Reconcile until Available (the controller loop's resync,
    compressed); seconds from the first apply to Available."""
    t0 = time.perf_counter()
    while True:
        with pod_logs(log_path):
            status = rec.reconcile(sdep)
        if status.state == "Available":
            return time.perf_counter() - t0
        if status.state == "Failed":
            raise AssertionError(f"operator: reconcile failed: {status}")
        if time.perf_counter() - t0 > OP_READY_S:
            raise AssertionError(f"operator: {sdep.name} not Available in "
                                 f"{OP_READY_S} s")
        for name, pod in store.pods.items():
            if not pod.alive():
                raise AssertionError(f"operator: pod {name} exited "
                                     f"(its log: {log_path})")
        time.sleep(0.25)


def op_predict(port, grpc_port, X, stub_cache):
    """NLLs (f32) and the response meta, over the engine pod's REST and
    gRPC, of one predict on token ids ``X``."""
    import grpc
    import numpy as np

    from seldon_tpu_torch.core import payloads
    from seldon_tpu_torch.proto import prediction_grpc

    status, raw = http_post(port, "/api/v0.1/predictions",
                            {"data": {"ndarray": X.tolist()}})
    if status != 200:
        raise AssertionError(f"operator: engine answered {status}: "
                             f"{raw[:500]!r}")
    body = json.loads(raw)
    rest = np.asarray(payloads.get_data_from_message(
        payloads.dict_to_message(body)), np.float32)
    if grpc_port not in stub_cache:
        ch = grpc.insecure_channel(f"127.0.0.1:{grpc_port}")
        stub_cache[grpc_port] = (ch, prediction_grpc.STUBS["Seldon"](ch))
    resp = stub_cache[grpc_port][1].Predict(
        payloads.build_message(X.astype(np.float64)), timeout=600)
    grpc_out = np.asarray(payloads.get_data_from_message(resp), np.float32)
    metrics = {m.key: m.value for m in resp.meta.metrics}
    return {"rest": rest, "grpc": grpc_out,
            "path": dict(resp.meta.requestPath),
            "rest_path": body["meta"].get("requestPath", {}),
            "metrics": metrics}


def op_check_predicts(where, port, grpc_port, X1, X2, want1, want2, cache):
    """(b): both shapes over both transports bit-equal to in-process;
    ``requestPath`` names the unit. Returns the last answer's metrics."""
    import numpy as np

    last = None
    for X, want in ((X1, want1), (X2, want2)):
        got = op_predict(port, grpc_port, X, cache)
        for t in ("rest", "grpc"):
            if got[t].shape != want.shape or not np.array_equal(
                    got[t].view(np.uint32), want.view(np.uint32)):
                raise AssertionError(f"operator {where}: {t} predict "
                                     f"{got[t]} != in-process {want}")
        if OP_UNIT not in got["path"] or OP_UNIT not in got["rest_path"]:
            raise AssertionError(f"operator {where}: requestPath "
                                 f"{got['path']} names no {OP_UNIT!r}")
        last = got
    return last


def op_generate(port, greedy):
    """(c): the greedy prompts one at a time to the unit pod's own gRPC
    ``Generate``."""
    import grpc

    from seldon_tpu_torch.proto import prediction_grpc
    from seldon_tpu_torch.proto import prediction_pb2 as pb

    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        stub = prediction_grpc.TextGenStub(ch)
        return [list(stub.Generate(pb.GenerateRequest(
            prompt_token_ids=r["prompt_token_ids"],
            max_new_tokens=r["max_new_tokens"],
            temperature=r["temperature"], seed=r["seed"]),
            timeout=600).token_ids) for r in greedy]


def op_check_probe(probe, n_layers):
    """B1 inside the generation-2 pod (``chip_smoke_unit``): launched
    layers x wave legs, and held to its plain version on the pod's own
    inputs within phase 3's tolerances."""
    expected = probe["layers"] * probe["wave_legs"]
    if probe["launches"] != expected or probe["layers"] != n_layers:
        raise AssertionError(f"operator gen2: B1 launches in the pod "
                             f"{probe['launches']} != layers x legs "
                             f"{expected}")
    if (probe["checked"] == 0 or probe["err_m"] > TOL_M
            or probe["err_l_rel"] > TOL_L or probe["err_acc"] > TOL_ACC):
        raise AssertionError(f"operator gen2: B1 against its plain "
                             f"version in the pod: {probe}")


def op_in_process(params, cfg, greedy, dev, X1=None, X2=None):
    """The in-process answers: a TorchServer of the pods' configuration
    on the kept weights (assigned before ``load()``), the greedy prompts
    one at a time (the pods' schedule), and predicts when asked."""
    from seldon_tpu_torch.runtime.microservice import parse_parameters
    from seldon_tpu_torch.servers.torchserver import TorchServer

    srv = TorchServer(**dict(parse_parameters(json.dumps(op_parameters())),
                             device=dev))
    srv.params, srv.cfg = params, cfg
    try:
        out = {}
        if X1 is not None:
            out["predict"] = (srv.predict(X1, names=[]),
                              srv.predict(X2, names=[]))
        srv.load()
        out["streams"] = [srv.generate(r)["token_ids"] for r in greedy]
        return out
    finally:
        srv.stop()


def phase_operator(params, cfg, reqs, ckpt, dev):
    """The control plane on the card (``seldon_tpu_torch/operator``):
    SeldonDeployments rendered by the port's ``render_template``,
    defaulted and validated by its webhook and reconciled by its
    ``Reconciler`` into its ``LocalProcessStore``, which spawns the port's
    unit and engine processes; they serve llama3-8b at full width on the
    card with phase 4's weights (the pods seed them from phase 4's
    ``init_seed``; this process keeps them for the in-process answers).

    (a) Deploy: the template's JAX_SERVER unit without a modelUri is
    refused, as in the JAX package ("requires modelUri"); the unit is
    named by image as the port's TorchServer with phase 4's engine
    configuration and a small KV pool, defaulted, validated and reconciled
    to Available. (b) Predict: [1, 512] and [2, 512] token ids through the
    engine pod over REST and gRPC, bit-equal to an in-process
    ``TorchServer.predict`` on the kept weights (the preset's "xla"
    attention, no kernel), ``requestPath`` naming the unit. (c) Generate:
    phase 4's first three greedy prompts one at a time to the unit pod's
    gRPC ``Generate`` on the port the store recorded, equal to an
    in-process run of the same configuration and schedule. (d) Rolling
    update: generation 2 renames the predictor and runs
    ``chip_smoke_unit.B1ProbeServer`` (the same server plus a tap); while
    it rolls out both generations' pods are alive and the old engine
    still answers bit-equal; after it the stale pods have exited and
    their card memory is back; generation 2 answers (c) and (b) equal,
    and its ``meta.metrics`` show B1 launched layers x wave legs inside
    the pod and held to its plain version there (phase 3's tolerances).
    (e) Model initializer (its pod spawned beside generation 2): the
    prepackaged JAX_SERVER route with a ``file://`` modelUri at phase
    9d's 2-layer HF checkpoint, streams equal to the same cut served in
    process. (f) Teardown:
    after ``delete_all`` no pod process is left and the memory is back.
    Free card memory (``torch.cuda.mem_get_info``) and spawn-to-ready
    seconds are reported at each step; pods log to
    chiprun_out/operator_pods.log. The store is closed in a ``finally``."""
    import gc

    import numpy as np
    import torch

    from seldon_tpu_torch.operator import (InMemoryStore, Reconciler,
                                           SeldonDeployment,
                                           default_deployment,
                                           validate_deployment)
    from seldon_tpu_torch.operator.localstore import LocalProcessStore
    from seldon_tpu_torch.packaging import render_template

    greedy = reqs[:WIRE_PROMPTS]
    rng = np.random.default_rng(9)
    X1 = rng.integers(0, cfg.vocab_size, (1, GRAPH_S))
    X2 = rng.integers(0, cfg.vocab_size, (2, GRAPH_S))
    os.makedirs(OUT_DIR, exist_ok=True)
    log_path = os.path.join(OUT_DIR, "operator_pods.log")
    out = {"card": card_line(), "kv_pool_mb": OP_KV_POOL_MB, "mem": {},
           "seconds": {}}
    mem, secs = out["mem"], out["seconds"]

    # The in-process answers first, so that no allocation of this process
    # moves the free memory the pods are measured by.
    t0 = time.perf_counter()
    ref = op_in_process(params, cfg, greedy, dev, X1, X2)
    want1, want2 = ref["predict"]
    p_cut, cfg_cut = shallow(params, cfg, LOAD_LAYERS)
    ref_cut = op_in_process(p_cut, cfg_cut, greedy, dev)
    del p_cut
    gc.collect()
    torch.cuda.empty_cache()
    secs["in_process"] = time.perf_counter() - t0

    def cr(name, generation, pred_name, graph_update, model_uri=""):
        d = render_template("single-model", name=name,
                            implementation="JAX_SERVER", model_uri=model_uri)
        d["metadata"]["generation"] = generation
        pred = d["spec"]["predictors"][0]
        pred["name"] = pred_name
        pred["graph"].update(graph_update)
        return d

    # (a) the template's JAX_SERVER unit with no modelUri: refused.
    bare = cr("op", 1, "default", {})
    refused = Reconciler(InMemoryStore()).reconcile(
        SeldonDeployment.from_dict(bare))
    if refused.state != "Failed" or "requires modelUri" not in \
            refused.description:
        raise AssertionError(f"operator: a JAX_SERVER unit without modelUri "
                             f"was not refused: {refused}")
    out["refused"] = refused.description
    params1 = op_parameters(preset=OP_PRESET, init_seed=0)
    gen1 = cr("op", 1, "main", {"image": OP_TORCHSERVER,
                                "parameters": params1})
    del gen1["spec"]["predictors"][0]["graph"]["implementation"]
    sdep1 = SeldonDeployment.from_dict(gen1)
    default_deployment(sdep1)
    problems = validate_deployment(sdep1)
    if problems:
        raise AssertionError(f"operator: validation: {problems}")

    store = LocalProcessStore(repo_root=os.getcwd())
    rec = Reconciler(store, istio_enabled=False)
    stubs = {}
    try:
        mem["before"] = op_free()
        secs["gen1_spawn_to_ready"] = op_reconcile(rec, store, sdep1,
                                                   log_path)
        mem["gen1"] = op_free()
        dep1 = next(iter(store.pods))
        pod1 = store.pods[dep1]
        out["pod_ports"] = dict(pod1.ports)
        out["gen1_footprint"] = mem["before"] - mem["gen1"]
        log(f"operator (a) {dep1}: Available in "
            f"{secs['gen1_spawn_to_ready']:.1f} s from spawn; free card "
            f"memory {mem['before'] / 2**30:.2f} -> {mem['gen1'] / 2**30:.2f}"
            f" GiB ({len(pod1.procs)} processes); refused without modelUri: "
            f"{refused.description!r}")

        # (b) and (c) on generation 1.
        t0 = time.perf_counter()
        e_http, e_grpc = pod1.ports["engine-http"], pod1.ports["engine-grpc"]
        op_check_predicts("gen1", e_http, e_grpc, X1, X2, want1, want2,
                          stubs)
        streams1 = op_generate(pod1.ports[OP_UNIT], greedy)
        if streams1 != ref["streams"]:
            raise AssertionError(f"operator gen1: pod streams {streams1} != "
                                 f"in-process {ref['streams']}")
        secs["gen1_b_c"] = time.perf_counter() - t0
        out["nll"] = [want1.tolist(), want2.tolist()]
        out["tokens"] = ref["streams"]
        log(f"operator (b)+(c) gen1: predicts [1, {GRAPH_S}] and [2, "
            f"{GRAPH_S}] over REST and gRPC bit-equal to in-process "
            f"(nll {want1.tolist()}); {len(greedy)} pod gRPC Generate "
            f"streams equal to in-process ({secs['gen1_b_c']:.1f} s)")

        # (d) the rolling update to generation 2.
        gen2 = cr("op", 2, "canary", {"image": OP_PROBE,
                                      "parameters": params1})
        del gen2["spec"]["predictors"][0]["graph"]["implementation"]
        sdep2 = SeldonDeployment.from_dict(gen2)
        t0 = time.perf_counter()
        with pod_logs(log_path):
            state = rec.reconcile(sdep2).state
        if state != "Creating":
            raise AssertionError(f"operator (d): generation 2 is {state} "
                                 "before its pod started")
        dep2 = next(n for n in store.pods if n != dep1)
        # (e)'s pod starts beside generation 2: a file:// modelUri (9d's
        # checkpoint) through the prepackaged JAX_SERVER route and the
        # model initializer.
        uri = "file://" + os.path.abspath(ckpt)
        sdep_u = SeldonDeployment.from_dict(cr(
            "op-uri", 1, "main", {"parameters": op_parameters()},
            model_uri=uri))
        with pod_logs(log_path):
            rec.reconcile(sdep_u)
        dep_u = next(n for n in store.pods if n not in (dep1, dep2))
        old_procs = list(pod1.procs)
        during = op_predict(e_http, e_grpc, X1, stubs)
        if not np.array_equal(during["rest"].view(np.uint32),
                              want1.view(np.uint32)):
            raise AssertionError("operator (d): the old engine's answer "
                                 "changed during the rollout")
        op_wait(lambda: store.is_ready("Deployment", "default", dep2),
                OP_READY_S, "generation 2 ready")
        secs["gen2_spawn_to_ready"] = time.perf_counter() - t0
        op_wait(lambda: store.is_ready("Deployment", "default", dep_u),
                OP_READY_S, "the modelUri pod ready")
        secs["uri_spawn_to_ready"] = time.perf_counter() - t0
        mem["both"] = op_free()
        if not (pod1.alive() and store.pods[dep2].alive()):
            raise AssertionError("operator (d): a generation's pod is down "
                                 "during the rollout")
        during = op_predict(e_http, e_grpc, X1, stubs)
        if not np.array_equal(during["grpc"].view(np.uint32),
                              want1.view(np.uint32)):
            raise AssertionError("operator (d): the old engine's answer "
                                 "changed with both generations up")
        with pod_logs(log_path):
            state = rec.reconcile(sdep2).state
        if state != "Available" or set(store.pods) != {dep2, dep_u}:
            raise AssertionError(f"operator (d): after the rollout {state}, "
                                 f"pods {sorted(store.pods)}")
        if any(p.poll() is None for p in old_procs):
            raise AssertionError("operator (d): a stale pod process lives")
        freed = lambda: op_free() - mem["both"] >= 0.9 * out[  # noqa: E731
            "gen1_footprint"]
        op_wait(freed, 30.0, "the stale pods' card memory back")
        mem["gen2"] = op_free()
        secs["rollout"] = time.perf_counter() - t0
        log(f"operator (d) {dep1} -> {dep2}: generation 2 ready in "
            f"{secs['gen2_spawn_to_ready']:.1f} s with both generations and "
            f"(e)'s pod serving (free {mem['both'] / 2**30:.2f} GiB), the "
            f"old engine bit-equal throughout; stale pods exited, free back to "
            f"{mem['gen2'] / 2**30:.2f} GiB; rollout {secs['rollout']:.1f} s")

        pod2 = store.pods[dep2]
        t0 = time.perf_counter()
        streams2 = op_generate(pod2.ports[OP_UNIT], greedy)
        if streams2 != ref["streams"]:
            raise AssertionError(f"operator gen2: pod streams {streams2} != "
                                 f"in-process {ref['streams']}")
        last = op_check_predicts("gen2", pod2.ports["engine-http"],
                                 pod2.ports["engine-grpc"], X1, X2, want1,
                                 want2, stubs)
        probe = {k[len("b1_"):]: v for k, v in last["metrics"].items()
                 if k.startswith("b1_")}
        secs["gen2_b_c"] = time.perf_counter() - t0
        if len(probe) != 7:
            raise AssertionError(f"operator gen2: meta.metrics carry no B1 "
                                 f"probe: {sorted(last['metrics'])}")
        op_check_probe(probe, cfg.n_layers)
        out["b1_in_pod"] = probe
        out["b1_launches"] = int(probe["launches"])
        out["pod_memory_at_ready"] = {
            k: int(last["metrics"][k]) for k in (
                "card_allocated_at_ready", "card_reserved_at_ready")}
        log(f"operator gen2: the probe pod at ready holds "
            f"{out['pod_memory_at_ready']['card_allocated_at_ready']} B "
            f"allocated, "
            f"{out['pod_memory_at_ready']['card_reserved_at_ready']} B "
            f"reserved")
        log(f"operator (c)+(b) gen2 (B1 probe): streams and predicts equal; "
            f"B1 in the pod {int(probe['launches'])} launches = "
            f"{int(probe['layers'])} layers x {int(probe['wave_legs'])} wave "
            f"legs; {int(probe['checked'])} checked launches within "
            f"{probe['err_m']:.3g} / {probe['err_l_rel']:.3g} / "
            f"{probe['err_acc']:.3g} (m, l rel, acc) of the plain version")

        # (e) the model initializer.
        op_reconcile(rec, store, sdep_u, log_path)
        manifest = store.manifests[("Deployment", "default", dep_u)]
        pod_spec = manifest["spec"]["template"]["spec"]
        unit_c = next(c for c in pod_spec["containers"]
                      if c["name"] == OP_UNIT)
        if (pod_spec["initContainers"][0]["command"][-1]
                != "seldon_tpu_torch.servers.storage"
                or unit_c["command"][-1]
                != "seldon_tpu_torch.servers.torchserver.TorchServer"):
            raise AssertionError(f"operator (e): manifest {pod_spec}")
        streams_u = op_generate(store.pods[dep_u].ports[OP_UNIT], greedy)
        if streams_u != ref_cut["streams"]:
            raise AssertionError(f"operator (e): pod streams {streams_u} != "
                                 f"the cut in process {ref_cut['streams']}")
        log(f"operator (e) {dep_u}: {LOAD_LAYERS}-layer checkpoint through "
            f"the model initializer ({uri}), ready in "
            f"{secs['uri_spawn_to_ready']:.1f} s (spawned beside generation "
            f"2); streams equal to the cut in process")

        # (f) teardown.
        t0 = time.perf_counter()
        procs = [p for pod in store.pods.values() for p in pod.procs]
        n = rec.delete_all("op", "default") + rec.delete_all("op-uri",
                                                             "default")
        if store.pods or any(p.poll() is None for p in procs):
            raise AssertionError("operator (f): pods outlived delete_all")
        op_wait(lambda: op_free() >= mem["before"] - OP_MEM_SLACK, 30.0,
                "the card memory back after teardown")
        mem["after"] = op_free()
        secs["teardown"] = time.perf_counter() - t0
        log(f"operator (f): delete_all removed {n} objects, "
            f"{len(procs)} pod processes exited; free "
            f"{mem['after'] / 2**30:.2f} GiB (before the pods "
            f"{mem['before'] / 2**30:.2f})")
        return out
    finally:
        for ch, _ in stubs.values():
            ch.close()
        store.close()


NOISE_SEEDS = NOISE_POSITIONS = 64


def phase_noise(cfg, dev):
    """The engine's sampling noise on the card against the CPU: threefry
    bits (``models/prng.py``) of every (seed, position) of a 64 x 64 grid
    at the full vocabulary, bit for bit, and the Gumbel values made of
    them within two f32 ulps at the noise's scale ``max(|g|, 1)`` (two
    logs, each rounded by another library on the card and on the CPU).
    Also the card's time for one sampler's noise, [32, V]."""
    import torch

    from seldon_tpu_torch.models import prng
    from seldon_tpu_torch.models.sampling import gumbel_noise

    V = cfg.vocab_size
    seeds = (torch.arange(NOISE_SEEDS, dtype=torch.int64) * 2654435761
             + 12345) % 2 ** 32
    positions = torch.arange(NOISE_POSITIONS, dtype=torch.int64) * 31
    n_equal, n_total, worst = 0, 0, 0.0
    for s in seeds:
        keys = prng.fold_in(prng.key(s.repeat(NOISE_POSITIONS)), positions)
        bits_card = prng.random_bits(keys.to(dev), (V,))
        g_card = prng.gumbel_from_bits(bits_card).cpu()
        bits_cpu = prng.random_bits(keys, (V,))
        if not torch.equal(bits_card.cpu(), bits_cpu):
            raise AssertionError(f"threefry bits differ between the card "
                                 f"and the CPU (seed {int(s)})")
        g_cpu = prng.gumbel_from_bits(bits_cpu)
        if not torch.isfinite(g_card).all():
            raise AssertionError("non-finite Gumbel noise on the card")
        scale = torch.maximum(g_cpu.abs(), torch.ones_like(g_cpu))
        # One ulp of the scale, taken toward +inf: the gate covers every
        # value (toward 2.0 the step is negative above 2 and 0 at 2).
        ulp = torch.nextafter(scale, torch.full_like(scale, math.inf)) \
            - scale
        worst = max(worst, float(((g_card - g_cpu).abs() / ulp).max()))
        n_equal += int((g_card == g_cpu).sum())
        n_total += g_cpu.numel()
    if worst > 2.0:
        raise AssertionError(f"Gumbel noise on the card differs from the "
                             f"CPU's by {worst} ulps at its scale")
    seeds_b = torch.arange(32, device=dev)
    pos_b = torch.arange(32, device=dev) + 100
    ms = cuda_time_ms(lambda: gumbel_noise(seeds_b, pos_b, V), reps=10,
                      warmup=2)
    out = {"grid": [NOISE_SEEDS, NOISE_POSITIONS], "vocab": V,
           "bits_equal": True, "gumbel_equal_share": n_equal / n_total,
           "gumbel_max_ulps_at_scale": worst, "sampler_noise_ms_32xV": ms}
    log(f"noise: threefry bits equal on the card and the CPU over "
        f"{NOISE_SEEDS}x{NOISE_POSITIONS} (seed, position) x V={V}; Gumbel "
        f"values equal {n_equal / n_total:.6f}, max {worst:.3g} ulps at "
        f"max(|g|, 1); one sampler's noise [32, V] {ms:.3f} ms on the card")
    return out


MOE_PROMPT_LENS = (5, 12, 20, 31, 40, 52, 64, 77)
MOE_NEW = 16


def phase_moe(dev):
    """``tiny-moe`` (4 experts, top-2) on the card: seeded weights, an
    engine burst of 8 requests (6 greedy, 2 sampled) on the kernel leg
    with B1's launches counted, and the same burst through the port on
    the CPU (where the kernel's plain version runs). Gates: B1 launches =
    layers x wave legs; every logits row both runs share (each request up
    to its first differing token) within RAGGED_LOGITS_ATOL. Streams are
    reported."""
    import copy

    import numpy as np
    import torch

    from seldon_tpu_torch.models import transformer
    from seldon_tpu_torch.models.config import get_config
    from seldon_tpu_torch.models.sampling import SamplingParams
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.ops.ragged_paged_attention import (
        RAGGED_LOGITS_ATOL)
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

    cfg = get_config("tiny-moe")
    p_cpu = transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    p_dev = copy.deepcopy(p_cpu).to(dev)
    ecfg = EngineConfig(max_slots=8, max_seq_len=128,
                        prompt_buckets=(32, 64, 128), paged_kv=True,
                        kv_block=16, chunked_prefill=True, prefill_chunk=32,
                        ragged=True, ragged_kernel="pallas")
    rng = np.random.default_rng(5)
    reqs = [{"prompt_token_ids": rng.integers(2, cfg.vocab_size,
                                              n).tolist(),
             "seed": 200 + i, "max_new_tokens": MOE_NEW,
             "temperature": 0.0 if i < N_GREEDY else 0.8}
            for i, n in enumerate(MOE_PROMPT_LENS)]

    def sampling(r):
        return SamplingParams(temperature=r["temperature"],
                              max_new_tokens=r["max_new_tokens"],
                              seed=r["seed"])

    rpa.launches = 0
    eng_stats = {}
    st_dev, rows_dev, wall = run_engine(p_dev, cfg, ecfg, dev, reqs,
                                        sampling, stats=eng_stats)
    launches = rpa.launches
    legs = eng_stats["decode_dispatches"] + eng_stats["prefill_waves"]
    if launches != cfg.n_layers * legs or launches == 0:
        raise AssertionError(f"tiny-moe: B1 launches {launches} != layers x "
                             f"legs {cfg.n_layers * legs}")
    st_cpu, rows_cpu, _ = run_engine(p_cpu, cfg, ecfg, torch.device("cpu"),
                                     reqs, sampling)
    cmp = compare_legs(reqs, "tiny-moe card vs CPU", (st_dev, rows_dev),
                       (st_cpu, rows_cpu))
    if cmp["max_logit_diff"] > RAGGED_LOGITS_ATOL:
        raise AssertionError(f"tiny-moe logits on the card differ from the "
                             f"CPU's by {cmp['max_logit_diff']}")
    log(f"tiny-moe: {len(reqs)} requests, B1 launches {launches} "
        f"(layers x legs {cfg.n_layers * legs}), wall_s={wall:.3f}")
    return {"launches": launches, "legs": legs, "wall_s": wall,
            "card_vs_cpu": cmp}


def phase_build():
    """Build every kernel from the checkout, one nvcc per source, all in
    parallel."""
    import re

    import torch

    from seldon_tpu_torch.ops import _build
    from seldon_tpu_torch.ops import flash_attention as fa
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    binders = {"ragged_paged_attention":
               lambda: rpa._kernel_lib(torch.bfloat16),
               "ragged_paged_attention_f32":
               lambda: rpa._kernel_lib(torch.float32),
               "flash_attention": lambda: fa._kernel_fn(torch.bfloat16),
               "flash_attention_f32": lambda: fa._kernel_fn(torch.float32)}
    errors = {}

    def build(name):
        try:
            binders[name]()
        except BaseException as e:  # re-raised below, never swallowed
            errors[name] = e

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=(n,)) for n in binders]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise RuntimeError(f"kernel build failed: {errors}")
    out = {"seconds": wall, "by_source": {}}
    for name in binders:
        text = _build.build_log.get(name, "")
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", text)]
        spills = [int(x) for x in
                  re.findall(r"(\d+) bytes spill stores", text)]
        out["by_source"][name] = {
            "nvcc_s": _build.build_seconds.get(name, 0.0),
            "registers": regs, "spill_store_bytes": spills,
            "ptxas": [ln.strip() for ln in text.splitlines()
                      if "registers" in ln or "spill" in ln]}
        log(f"build {name}.cu: nvcc {_build.build_seconds.get(name, 0):.1f}"
            f" s; ptxas registers per instance {regs}, spill store bytes "
            f"{spills}")
    out["tensor_core_f32"] = tc_f32_instances()
    log(f"build: {len(binders)} sources in {wall:.1f} s")
    return out


def tc_f32_instances():
    """ptxas (-Xptxas -v) on the f32 routes' tensor-core (3xTF32)
    instances: registers and spill bytes per instance, beside the dynamic
    shared memory each launch asks for (the kernels' own geometry, read
    through their C helpers)."""
    import ctypes
    import re

    from seldon_tpu_torch.ops import _build

    smem = {"rpa_f32_tc_kernel": lambda dh, q8: _build.load(
                "ragged_paged_attention_f32").rpa_f32_tc_smem_bytes(
                    ctypes.c_int(dh), ctypes.c_int(q8)),
            "flash_fwd_tf32": lambda dh, q8: _build.load(
                "flash_attention_f32").flash_attention_f32_smem_bytes(
                    ctypes.c_int(dh))}
    rows = []
    want = {"ragged_paged_attention_f32": 6, "flash_attention_f32": 3}
    for name in want:
        if name not in _build.build_log:  # loaded from build/kernels
            log(f"build ptxas {name}.cu: library loaded from the build "
                f"cache, no ptxas report in this process")
            want[name] = 0
            continue
        current = None
        for line in _build.build_log[name].splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                k = re.search(r"(rpa_f32_tc_kernel|flash_fwd_tf32)"
                              r"ILi(\d+)E([fa]?)E", m.group(1))
                current = None
                if k:
                    current = {"kernel": k.group(1), "Dh": int(k.group(2)),
                               "pool": {"f": "f32", "a": "int8"}.get(
                                   k.group(3), "-")}
                    rows.append(current)
                continue
            if current is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                current["spill_store_bytes"] = int(m.group(1))
                current["spill_load_bytes"] = int(m.group(2))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                current["registers"] = int(m.group(1))
                current["dynamic_smem_bytes"] = smem[current["kernel"]](
                    current["Dh"], int(current["pool"] == "int8"))
                current = None
    for r in rows:
        log(f"build ptxas {r['kernel']}<Dh {r['Dh']}, pool {r['pool']}>: "
            f"{r.get('registers')} registers, spill stores "
            f"{r.get('spill_store_bytes')} B, loads "
            f"{r.get('spill_load_bytes')} B, dynamic shared memory "
            f"{r.get('dynamic_smem_bytes')} B")
    spilled = [r for r in rows if r.get("spill_store_bytes", 1)
               or r.get("spill_load_bytes", 1)]
    if len(rows) != sum(want.values()) or spilled:
        raise AssertionError(f"the f32 tensor-core instances spill or are "
                             f"missing from ptxas' report: {rows}")
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    from seldon_tpu_torch.device import configure_gemms

    # The GEMM settings every engine process reports (read, not set).
    gemms = configure_gemms()
    # Full f32 for the plain versions' and the masked leg's f32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if sys.argv[1:] == ["--train-8b"]:  # phase 9n's subprocess
        print(json.dumps(train_8b(torch.device("cuda", 0))))
        return 0
    if sys.argv[1:] == ["--f32-8b"]:  # phase f32's subprocess
        print(json.dumps(f32_8b(torch.device("cuda", 0))))
        return 0

    from seldon_tpu_torch.models.config import get_config

    global _log_file
    os.makedirs(OUT_DIR, exist_ok=True)
    _log_file = open(os.path.join(OUT_DIR, "chip_smoke.log"), "w")
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "gemm_settings": gemms}
    log(f"GEMM settings: {gemms}")
    seconds = report["phase_seconds"] = {}

    memory = report["phase_memory"] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        # This process's card memory after the phase (the later phases'
        # pods and rank groups share the card with it).
        gc.collect()
        memory[name] = {"allocated": torch.cuda.memory_allocated(dev),
                        "reserved": torch.cuda.memory_reserved(dev),
                        "free": torch.cuda.mem_get_info(dev)[0]}
        log(f"phase {name} seconds={seconds[name]:.1f} card memory "
            f"allocated={memory[name]['allocated']} reserved="
            f"{memory[name]['reserved']} free={memory[name]['free']}")
        return out

    report["build"] = timed("build", phase_build)

    cfg = get_config("llama3-8b")
    report["kernel"] = timed("kernel", phase_kernel, cfg, dev)
    report["flash_kernel"] = timed("flash_kernel", phase_flash_kernel, cfg,
                                   dev)
    report["flash_f32"] = timed("flash_f32", phase_flash_f32, cfg, dev)
    report["train"] = timed("train", phase_train, dev)
    report["f32"] = timed("f32", phase_f32, dev)
    gc.collect()
    torch.cuda.empty_cache()
    srv, reqs, toks, report["serve"] = timed("serve", phase_serve, dev)
    report["burst_kernel"] = timed("burst_kernel", phase_burst_kernel, srv,
                                   reqs, dev)
    report["profile"] = report["burst_kernel"]["profile"]
    report["captured"] = timed("captured", phase_captured, srv, reqs, dev)
    report["legs"], cut_kernel, bf16_kernel = timed(
        "legs", phase_legs, srv, reqs, toks, dev)
    report["score"] = timed("score", phase_score, srv, dev)
    report["generate"] = timed("generate", phase_generate, srv, dev)
    report["predict"] = timed("predict", phase_predict, srv)
    # From here to 9g the weights are cut to CUT_LAYERS layers (9l (b)
    # cuts its own); int8, 9l (c) and (e) and the operator serve 32.
    csrv, ctoks, report["cut"] = timed("cut", cut_server, srv, reqs, dev)
    report["captured_cut"] = timed("captured_cut", captured_cut, csrv, reqs,
                                   dev)
    report["captured_families"] = timed("captured_families",
                                        phase_captured_families, csrv, reqs,
                                        dev)
    report["wire"] = timed("wire", phase_wire, csrv, reqs, ctoks,
                           report["cut"], dev)
    report["graph"] = timed("graph", phase_graph, csrv)
    report["load"] = timed("load", phase_load, csrv, reqs, dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["heal"] = timed("heal", phase_heal, csrv, reqs, dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["sanitize"] = timed("sanitize", phase_sanitize, csrv, reqs,
                               ctoks, dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["prepackaged"] = timed("prepackaged", phase_prepackaged, dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["prefix"] = timed("prefix", phase_prefix, csrv, report["legs"],
                             dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["bucketed"] = timed("bucketed", phase_bucketed, csrv, reqs,
                               ctoks, report["legs"], cut_kernel, dev)
    report["spec"] = timed("spec", phase_spec, csrv, reqs, report["legs"],
                           dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["observatory"] = timed("observatory", phase_observatory, csrv,
                                  reqs, ctoks, dev)
    del csrv, ctoks, cut_kernel
    gc.collect()
    torch.cuda.empty_cache()
    report["int8"] = timed("int8", phase_int8, srv, reqs, bf16_kernel, dev)
    tp_args = (srv.params, srv.cfg, srv._engine_config(srv.cfg), reqs,
               functools.partial(type(srv)._to_sampling, None),
               report["legs"])
    del srv, bf16_kernel
    gc.collect()
    torch.cuda.empty_cache()
    report["tp"] = timed("tp", phase_tp, *tp_args,
                         report["prefix"]["load"]["path"], dev)
    op_args = (tp_args[0], tp_args[1], reqs, report["prefix"]["load"]["path"])
    del tp_args
    gc.collect()
    torch.cuda.empty_cache()
    try:
        report["operator"] = timed("operator", phase_operator, *op_args, dev)
    finally:
        import shutil

        shutil.rmtree(op_args[3], ignore_errors=True)
    del op_args
    gc.collect()
    torch.cuda.empty_cache()
    report["noise"] = timed("noise", phase_noise, cfg, dev)
    report["moe"] = timed("moe", phase_moe, dev)

    b1_bf16 = [r for r in report["kernel"] if r["dtype"] == "bf16"]
    b1_f32 = [r for r in report["kernel"] if r["dtype"] == "f32"]
    head = b1_bf16[0]  # the decode shape, bf16 pool
    f32_b1 = b1_f32[0]  # the decode shape, f32 q and pool
    f32_phase = report["f32"]
    burst = report["burst_kernel"]["legs"]
    flash = report["flash_kernel"]
    tc_head = flash[0]  # the score shape (a), bf16
    f32_head = next(r for r in flash if r["dtype"] == "f32")  # (c), f32
    by_shape = [{k: r.get(k) for k in (
        "shape", "dtype", "B", "Sq", "Skv", "q_offset", "causal", "ms",
        "plain_ms", "library_ms", "bound_ms", "bound_by", "tflops",
        "bound_share", "max_abs_err", "differ_share", "beyond_ulp",
        "f32sum_beyond_ulp", "f32sum_differ_share", "bound_f32_ms",
        "bound_3xtf32_ms")} for r in flash]
    kernels = {"kernels": [{
        "name": "ragged_paged_attention_partials",
        "route": "cuda",
        "source": "seldon_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "seldon_tpu/ops/ragged_paged_attention.py:373",
        "launches": report["serve"]["launches"],
        "launches_prefix": report["prefix"]["prefix"]["launches"],
        "launches_spec": report["spec"]["launches"],
        "launches_captured_families": report["captured_families"][
            "launches_b1"],
        "launches_observatory": report["observatory"]["launches_b1"],
        "launches_load": report["load"]["launches"],
        "launches_orbax": report["prefix"]["orbax"]["launches"],
        "launches_orbax_fixtures": {
            k: v["launches"] for k, v in
            report["prefix"]["orbax"]["fixtures"].items()},
        "launches_heal": (report["heal"]["tiny"]["launches"]
                          + report["heal"]["full"]["launches"]),
        "launches_sanitize": report["sanitize"]["launches"],
        "launches_tp": report["tp"]["b"]["launches_per_rank"],
        "launches_tp_plans": {p: report["tp"]["g"][p]["launches_per_rank"]
                              for p in TP_PLAN_B1_RUNS},
        "launches_tp_spec_verify": report["tp"]["f"]["spec-kernel"][
            "launches_b1_rank0"],
        "launches_budget": report["burst_kernel"]["budget"]["launches"],
        "launches_operator_pod": report["operator"]["b1_launches"],
        "verify": {k: report["captured_families"]["turns"]["spec_ngram"][
            1][k] for k in ("b1_launches", "b1_ms_per_launch",
                            "b1_bound_ms_per_launch")},
        "max_abs_err": max([max(r["err_m"], r["err_acc"])
                            for r in b1_bf16]
                           + [max(e[0], e[2]) for e in
                              report["legs"]["tap"]["errors"].values()]
                           + [max(e[0], e[2]) for e in report["prefix"][
                               "cow"]["shared_tap"]["errors"].values()]
                           + [max(e[0], e[2]) for e in report[
                               "burst_kernel"]["budget"]["tap"][
                                   "errors"].values()]
                           + [max(report["spec"]["ngram"]["b1_errors"][0],
                                  report["spec"]["ngram"]["b1_errors"][2])]
                           + [max(e[0], e[2]) for e in report[
                               "observatory"]["ragged"][
                                   "b1_errors"].values()]
                           + [max(report["heal"]["full"][
                               "b1_replay_errors"][0], report["heal"][
                                   "full"]["b1_replay_errors"][2])]
                           + [max(e[0], e[2]) for t in (
                               report["tp"]["b"]["tap_rank0"],
                               report["tp"]["b"]["tap_rank1"],
                               *(t for p in TP_PLAN_B1_RUNS
                                 for t in report["tp"]["g"][p]["taps"]))
                              for e in t["errors"].values()]
                           + [max(report["operator"]["b1_in_pod"]["err_m"],
                                  report["operator"]["b1_in_pod"][
                                      "err_acc"])]),
        "ms": head["ms"],
        "timed_by": "CUDA-graph replay of 20 calls",
        "wrapper_ms": head["wrapper_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": None,
        "by_shape": [{k: r[k] for k in ("shape", "kv", "route", "n_split",
                                        "ms", "wrapper_ms", "plain_ms",
                                        "bound_ms", "bound_by", "err_m",
                                        "err_l_rel", "err_acc")}
                     for r in b1_bf16],
        "burst": {leg: {k: d[k] for k in ("launches", "ms_per_launch",
                                          "bound_ms_per_launch")}
                  for leg, d in burst.items()},
        "burst_route": "captured: launches and device ms from the replays",
        "burst_host_us_per_call": report["burst_kernel"]["host_us_per_call"],
        "burst_host_us_route": report["burst_kernel"]["host_us_route"],
    }, {
        "name": "ragged_paged_attention_partials_f32",
        "route": "cuda",
        "source": "seldon_tpu_torch/csrc/ragged_paged_attention_f32.cu",
        "replaces": "seldon_tpu/ops/ragged_paged_attention.py:373",
        "launches": f32_phase["a"]["launches_f32"],
        "launches_on": "the f32 llama3-8b burst (phase f32 (a)): layers x "
                       "wave legs",
        "max_abs_err": max([max(r["err_m"], r["err_acc"]) for r in b1_f32]
                           + [max(e[0], e[2]) for e in f32_phase["a"][
                               "tap"]["errors"].values()]),
        "err_m_is": "relative to max(|m|, 1)",
        "ms": f32_b1["ms"],
        "timed_by": "CUDA-graph replay of 20 calls",
        "wrapper_ms": f32_b1["wrapper_ms"],
        "plain_ms": f32_b1["plain_ms"],
        "bound_ms": f32_b1["bound_ms"],
        "bound_by": f32_b1["bound_by"],
        "library_ms": None,
        "by_shape": [{k: r[k] for k in ("shape", "kv", "route", "n_split",
                                        "ms", "wrapper_ms", "plain_ms",
                                        "bound_ms", "bound_by",
                                        "bound_f32_ms", "bound_3xtf32_ms",
                                        "share_3xtf32", "err_m",
                                        "err_l_rel", "err_acc")}
                     for r in b1_f32],
    }, {
        "name": "flash_attention_bf16_fwd",
        "route": "cuda",
        "source": "seldon_tpu_torch/csrc/flash_attention.cu",
        "replaces": "seldon_tpu/ops/flash_attention.py:61",
        "launches": report["score"]["launches"],
        "launches_generate": report["generate"]["flash_first"]["launches"],
        "launches_bucketed": report["bucketed"]["launches"],
        "launches_captured_families": report["captured_families"][
            "launches_b2"],
        "launches_observatory": report["observatory"]["launches_b2"],
        "bucketed": {k: report["captured_families"]["turns"]["a_paged"][
            1][k] for k in ("b2_launches", "b2_ms_per_launch",
                            "b2_bound_ms_per_launch")},
        "max_abs_err": max([r["max_abs_err"] for r in flash
                            if r["dtype"] == "bf16"]
                           + [c["max_abs_err"]
                              for c in report["score"]["tap"]]
                           + [report["bucketed"]["b2_max_abs_err"],
                              report["observatory"]["bucketed"][
                                  "b2_max_abs_err"]]),
        "ms": tc_head["ms"],
        "plain_ms": tc_head["plain_ms"],
        "bound_ms": tc_head["bound_ms"],
        "bound_by": tc_head["bound_by"],
        "library_ms": tc_head["library_ms"],
        "by_shape": [r for r in by_shape if r["dtype"] == "bf16"],
    }, {
        "name": "flash_attention_f32_fwd",
        "route": "cuda",
        "source": "seldon_tpu_torch/csrc/flash_attention_f32.cu",
        "replaces": "seldon_tpu/ops/flash_attention.py:61",
        "launches": f32_phase["b"]["launches_f32"],
        "launches_on": "the f32 llama3-8b score call (phase f32 (b)): one "
                       "per layer",
        "launches_dispatch": report["flash_f32"]["launches"],
        "max_abs_err": max(f32_head["max_abs_err"],
                           report["flash_f32"]["max_abs_err"],
                           f32_phase["b"]["max_abs_err"]),
        "ms": f32_head["ms"],
        "plain_ms": f32_head["plain_ms"],
        "bound_ms": f32_head["bound_ms"],
        "bound_by": f32_head["bound_by"],
        "library_ms": f32_head["library_ms"],
        "by_shape": [r for r in by_shape if r["dtype"] == "f32"],
        "score_shape": f32_phase["b"]["timed"],
    }]}
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(report, kernels=kernels["kernels"]), f, indent=1)
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
