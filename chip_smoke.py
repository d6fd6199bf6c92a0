#!/usr/bin/env python3
"""Chip smoke of seldon_tpu_torch, the PyTorch/CUDA port, on one NVIDIA
card: serves Llama-3-8B generation through the ragged wave on the
hand-written CUDA ragged-paged-attention kernel (B1) with bf16 weights,
int8 weights and W8A8, and scores and generates with the whole-batch
path on the hand-written CUDA flash-attention kernel (B2).

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero and
prints no result):
 1. the card: ``nvidia-smi --query-gpu=name,power.limit``;
 2. build: nvcc compiles ``seldon_tpu_torch/csrc/ragged_paged_attention.cu``,
    ``flash_attention.cu`` (B2's bf16 route, tensor cores) and
    ``flash_attention_f32.cu`` (B2's f32 route, CUDA cores) for sm_90a from
    the checkout, all in parallel (nvcc seconds and ptxas' registers and
    spills printed);
 3. B1 versus its plain version: ``partials_kernel`` against the plain
    ``partials_sparse`` on the card at the two llama3-8b shapes of the
    serving path (decode R = 4 rows on the split-KV decode route, prefill
    R = 512 rows on the tensor-core route; 32 slots, Dh 128, block 16,
    128-block tables), bf16 and int8 pools, ragged bounds with a bound = 0
    slot and table tails at the trash block 0. The kernel is timed by
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
    ``flash_attention`` on f32 tensors at the generate-prefill shape (the
    port's models are bf16, so this is the route's path) launches the
    CUDA-core kernel once and agrees with the plain version;
 4. serve: ``TorchServer(preset="llama3-8b", ragged=1,
    ragged_kernel="pallas")`` at full width (32 layers, random weights
    from a seeded generator) answers 8 concurrent ``generate`` requests
    (prompts of 16-400 tokens, 32 new tokens, 6 greedy, 2 sampled); the
    kernel's launch counter must rise by exactly one launch per layer per
    wave leg that ran;
 5. where the time goes: the burst of phase 4 once more under
    ``torch.profiler`` (device busy time and idle share, the kernels and
    host operations that take the most time; see ``phase_profile``);
 5b. B1 on the burst's own inputs: the burst once more under
    ``torch.profiler``; B1's device time by wave leg from the profiler's
    kernel records (the decode route's merge included), its host time per
    wrapper call, and its bound computed from its inputs (see
    ``phase_burst_kernel``);
 6. legs on the same weights: the 6 greedy requests again through the
    masked leg, the masked leg with a one-ulp nudge, the kernel leg, the
    reference leg (the kernel leg's one-pass math through the plain
    full-width oracle) and the sparse leg (the masked-matched walk), with
    the weights cut to 2, 4, 8 and 16 layers and at full depth. Streams
    and logits of every pair are reported; at every depth the kernel leg
    must stay closer to the reference leg, and the sparse leg to the
    masked leg, than the one-ulp nudge moves the masked leg; at full
    depth the kernel is held to its plain version on the kernel leg's own
    inputs (see ``phase_legs``);
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
 10. int8: the same seeded weights quantized on the card by
    ``TorchServer(weight_dtype="int8")``, the 8 requests of phase 4
    served weight-only and then W8A8 (``torch._int_mm``) on B1's kernel
    leg: launches counted, layer 0's codes held to the CPU's and its W8A8
    products to an int64 product bit for bit, each burst profiled, and B1
    held to its plain version on the path's own inputs (see
    ``phase_int8``);
 11. noise: the engine's threefry bits on the card equal the CPU's over
    a 64 x 64 (seed, position) grid at the full vocabulary; Gumbel values
    within two ulps at their scale (see ``phase_noise``);
 12. MoE: ``tiny-moe`` served on the card on the kernel leg, B1 launches
    counted, logits held to the port on the CPU (see ``phase_moe``);
 13. the kernels line, then the last line
    ``{"ok": true, "device": {"platform": "gpu", ...}}``. Every phase
    prints its seconds.

Details of every phase go to ``chiprun_out/chip_smoke.json``.
"""

import contextlib
import dataclasses
import gc
import json
import os
import subprocess
import sys
import threading
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
BF16_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
F32_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
# Kernel vs plain version: both sum in f32, in another order, which moves
# results by a few f32 ulps (|acc / l| is ~0.05-0.3 here). 1e-4 is far
# above that and below what a kernel rounding p or acc to bf16 would give.
TOL_M = 1e-4  # absolute, on the running max m
TOL_L = 1e-4  # relative, on the exp-sum l
TOL_ACC = 1e-4  # absolute, on the normalised output acc / l
OUT_DIR = "chiprun_out"


def log(msg: str) -> None:
    print(msg, flush=True)


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


def compare_partials(got, want, bound):
    """Max errors (m abs, l rel, acc/l abs) on live rows; dead rows
    (bound = 0) must be exactly (NEG_INF, 0, 0)."""
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

    err_m = worst(gm - wm)
    err_l = worst((gl - wl) / wl.clamp(min=1e-30))
    err_acc = worst(ga / gl.clamp(min=1e-30) - wa / wl.clamp(min=1e-30))
    return err_m, err_l, err_acc


def phase_kernel(cfg, dev):
    import torch

    from seldon_tpu_torch.ops import ragged_paged_attention as rpa

    B, block, nbs = 32, 16, 2048 // 16
    rows = []
    for kind in ("decode", "prefill"):
        for kv_dtype in ("bf16", "int8"):
            q, layer, table, bound = kernel_inputs(
                cfg, kind, kv_dtype, B, nbs, block, dev,
                seed=len(rows) + 1)
            got = rpa.partials_kernel(q, layer, table, bound)
            torch.cuda.synchronize()
            want = rpa.partials_sparse(q, layer, table, bound)
            err_m, err_l, err_acc = compare_partials(got, want, bound)
            ok = err_m <= TOL_M and err_l <= TOL_L and err_acc <= TOL_ACC
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
            t_ops = ops / BF16_OPS_PER_S * 1e3
            R = q.shape[1] * q.shape[3]
            row = {
                "shape": kind, "kv": kv_dtype,
                "q": list(q.shape), "rows_per_kv_head": R,
                "route": "decode" if R < rpa.PREFILL_ROWS else "prefill",
                "n_split": (rpa.decode_split(nbs, block)[0]
                            if R < rpa.PREFILL_ROWS else 1),
                "live_positions": int(bound[:, 0].sum()),
                "err_m": err_m, "err_l_rel": err_l, "err_acc": err_acc,
                "ok": ok, "ms": ms, "wrapper_ms": wrapper_ms,
                "plain_ms": plain_ms,
                "bytes": nbytes, "ops": ops,
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            }
            rows.append(row)
            log(f"kernel {kind:7s} {kv_dtype:4s} R={R} route={row['route']} "
                f"n_split={row['n_split']} err m={err_m:.3g} (tol {TOL_M}) "
                f"l_rel={err_l:.3g} (tol {TOL_L}) acc/l={err_acc:.3g} (tol "
                f"{TOL_ACC}) kernel_ms={ms:.4f} (graph replay) wrapper_ms="
                f"{wrapper_ms:.4f} plain_ms={plain_ms:.3f} "
                f"bound_ms={row['bound_ms']:.4f} ({row['bound_by']}) "
                f"{'ok' if ok else 'FAIL'}")
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
# (name, B, Sq, Skv, q_offset, causal, dtype, timed against SDPA); heads
# are llama3-8b's.
FLASH_SHAPES = (
    ("a_score", 2, 4096, 4096, 0, True, "bf16", True),
    ("b_long", 1, 8192, 8192, 0, True, "bf16", True),
    ("c_prefill", 8, 512, 512, 0, True, "bf16", True),
    ("c_prefill", 8, 512, 512, 0, True, "f32", True),
    ("d_tail", 1, 200, 1000, 800, True, "bf16", False),
    ("d_full", 1, 1000, 1000, 0, False, "bf16", False),
    ("e_edge", 1, 129, 1000, 127, True, "bf16", False),
    ("e_edge", 1, 1, 129, 128, True, "bf16", False),
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
    """(bytes, operations) of one flash call: q, k, v read once and the
    output written once; QK and PV products (4 Dh operations) over every
    (query, key) pair the mask lets through (exact causal count)."""
    import torch

    BH, Sq, Dh = q.shape
    Skv = k.shape[1]
    if causal:
        i = torch.arange(Sq, dtype=torch.int64)
        pairs = int(torch.clamp(q_offset + i + 1, max=Skv).sum())
    else:
        pairs = Sq * Skv
    return (2 * q.numel() + 2 * k.numel()) * q.element_size(), \
        4 * Dh * pairs * BH


def phase_flash_kernel(cfg, dev):
    import torch
    import torch.nn.functional as F

    from seldon_tpu_torch.ops import flash_attention as fa

    H, Hkv, Dh, G = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.q_per_kv
    rows = []
    for i, (name, B, Sq, Skv, off, causal, dt, timed) in enumerate(
            FLASH_SHAPES):
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
        row["library_ms"] = None
        if timed:  # SDPA on [B, H, S, Dh] views: the library yardstick
            q4, k4, v4 = (t.view(B, -1, t.shape[1], Dh) for t in (q, k, v))

            def sdpa():
                return F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=True)

            row["library_ms"] = cuda_time_ms(sdpa, reps=20, warmup=3)
            lib = sdpa().reshape(q.shape).float()
            row["library_max_abs_vs_plain"] = (
                lib - want.float()).abs().max().item()
            del lib
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / (BF16_OPS_PER_S if dt == "bf16" else F32_OPS_PER_S) \
            * 1e3
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
        del q, k, v, got, want
        torch.cuda.empty_cache()
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"B2 disagrees with its plain version: {bad}")
    return rows


def phase_flash_f32(cfg, dev):
    """B2's f32 route through its entry point: the dispatch
    ``flash_attention`` on f32 tensors at the generate-prefill shape (B 8,
    S 512, llama3-8b heads) launches the CUDA-core kernel once, the
    tensor-core one never, and agrees with the plain version."""
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


def phase_serve(dev):
    from seldon_tpu_torch.ops import ragged_paged_attention as rpa
    from seldon_tpu_torch.servers.torchserver import TorchServer

    srv = TorchServer(preset="llama3-8b", max_slots=32, max_seq_len=2048,
                      ragged=1, ragged_kernel="pallas", init_seed=0,
                      device=dev)
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


class LogitTap:
    """Instrumentation of this script: while active, records the f32
    logits row that the ragged wave's sampler sees for every row whose
    seed is in `seeds`, keyed by (seed, position). A request's token j
    (0-based) is sampled at position len(prompt) + j, so the key names
    one token of one request. Waits for the device at every sampling
    call; used only on the comparison runs, never on the timed one."""

    def __init__(self, seeds):
        self.seeds = set(seeds)
        self.rows = {}

    def __enter__(self):
        from seldon_tpu_torch.models import ragged_attention

        self._mod = ragged_attention
        self._orig = ragged_attention.sample_per_row

        def tapped(logits, seeds, positions, *rest):
            for i, (sd, ps) in enumerate(zip(seeds.tolist(),
                                             positions.tolist())):
                if sd in self.seeds:
                    self.rows[(sd, ps)] = logits[i].float().cpu()
            return self._orig(logits, seeds, positions, *rest)

        ragged_attention.sample_per_row = tapped
        return self

    def __exit__(self, *exc):
        self._mod.sample_per_row = self._orig


class EmbedNudge:
    """Instrumentation of this script: while active, the first element
    of every embedded row moves by one bf16 ulp (its bit pattern plus
    one), one value in 4096 per token and smaller than any rounding in
    which the legs differ. Run on the masked leg it shows how far the
    model's depth grows a one-ulp difference."""

    def __enter__(self):
        import torch

        from seldon_tpu_torch.models import transformer

        self._mod, self._orig = transformer, transformer._embed_rows

        def nudged(params, tokens):
            x = self._orig(params, tokens).clone()
            bits = x[..., 0].contiguous().view(torch.int16) + 1
            x[..., 0] = bits.view(torch.bfloat16)
            return x

        transformer._embed_rows = nudged
        return self

    def __exit__(self, *exc):
        self._mod._embed_rows = self._orig


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
    a checked layer (first, middle, last) is followed by the plain version
    on the same inputs, on the card, and the errors are kept by wave leg
    (decode: one query row per slot; prefill: a chunk). The wave calls the
    kernel once per layer in layer order, so the launch count modulo the
    depth is the layer. Waits for the device at every checked launch;
    used only on a comparison run, never on the timed one."""

    def __init__(self, n_layers):
        self.n_layers = n_layers
        self.layers = {0, n_layers // 2, n_layers - 1}
        self.calls = 0
        self.checked = {"decode": 0, "prefill": 0}
        self.errs = {}  # leg -> (m abs, l rel, acc/l abs)

    def __enter__(self):
        from seldon_tpu_torch.ops import ragged_paged_attention as rpa

        self._rpa, self._orig = rpa, rpa.partials_kernel

        def tapped(q, layer, table, bound):
            got = self._orig(q, layer, table, bound)
            if self.calls % self.n_layers in self.layers:
                want = rpa.partials_sparse(q, layer, table, bound)
                leg = "decode" if q.shape[1] == 1 else "prefill"
                err = compare_partials(got, want, bound)
                prev = self.errs.get(leg, (0.0, 0.0, 0.0))
                self.errs[leg] = tuple(map(max, prev, err))
                self.checked[leg] += 1
            self.calls += 1
            return got

        rpa.partials_kernel = tapped
        return self

    def __exit__(self, *exc):
        self._rpa.partials_kernel = self._orig


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
# Depths of the sweep, the same weights cut to their first layers; the
# full depth runs last.
DEPTHS = (2, 4, 8, 16)
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
    of DEPTHS and then at full depth, through the four legs of
    ``run_legs``.

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
       tolerances."""
    import torch

    params, cfg = srv.params, srv.cfg
    greedy = reqs[:N_GREEDY]
    ecfg = srv.engine.ecfg
    srv.engine = None  # free the serving engine's pool first
    gc.collect()
    torch.cuda.empty_cache()
    out = {}
    for n in DEPTHS:
        p_n, cfg_n = shallow(params, cfg, n)
        out[n], _ = run_legs(p_n, cfg_n, ecfg, dev, greedy,
                             srv._to_sampling)
    tap = KernelTap(cfg.n_layers)
    out[cfg.n_layers], legs = run_legs(
        params, cfg, ecfg, dev, greedy, srv._to_sampling, tap)
    streams = {name: st for name, (st, _) in legs.items()}
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
    if streams["kernel"] != toks[:N_GREEDY]:
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
    return {"depths": out, "tap": {"checked": tap.checked,
                                   "errors": tap.errs}}, legs["kernel"]


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


def phase_profile(srv, reqs, dev):
    """The 8-request burst again, through a fresh kernel-leg engine on the
    same weights, under ``torch.profiler``.
    Reports the device's busy time (the union of its kernels' and copies'
    intervals), its idle share of the burst's wall time, and the kernels
    and host operations that take the most time. The profiler's own cost
    is inside the wall time, so tokens/s here is not phase 4's."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from seldon_tpu_torch.servers.engine import InferenceEngine

    eng = InferenceEngine(srv.params, srv.cfg, srv.engine.ecfg, dev)
    eng.start()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            _, wall = run_concurrent(
                lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                                srv._to_sampling(r)),
                reqs, timeout_s=600)
            torch.cuda.synchronize()
    finally:
        eng.stop()
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
    """Instrumentation of this script: while active, the host clock
    brackets each B1 wrapper call (its host time: the wrapper does not
    wait for the device), and the data-dependent terms of its bound (live
    pool blocks, sum of the bounds) are summed on the device, so nothing
    waits for the device until ``bounds_by_leg`` reads them once. (The
    profiler does not record ranges opened on the engine's thread.)"""

    def __enter__(self):
        import torch

        from seldon_tpu_torch.ops import ragged_paged_attention as rpa

        self._rpa, self._orig = rpa, rpa.partials_kernel
        self.calls = []
        self.host_s = 0.0

        def tapped(q, layer, table, bound):
            block = layer["k"].shape[2]
            t0 = time.perf_counter()
            out = self._orig(q, layer, table, bound)
            self.host_s += time.perf_counter() - t0
            counts = torch.stack([
                ((bound.amax(dim=1) + block - 1) // block).sum(),
                bound.to(torch.int64).sum()])
            self.calls.append((
                "decode" if q.shape[1] == 1 else "prefill",
                (tuple(q.shape), q.element_size(), bound.numel(), block,
                 layer["k"].element_size(), "k_scale" in layer), counts))
            return out

        rpa.partials_kernel = tapped
        return self

    def __exit__(self, *exc):
        self._rpa.partials_kernel = self._orig

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
    under BurstTap and ``torch.profiler``: B1's device time by wave leg
    from the profiler's kernel records (grouped by ``b1_leg`` on the
    kernel's name), its host time per wrapper call (BurstTap's host
    clock), and its bound on the serving path's own inputs (the order
    of queue B in ROADMAP.md rests on it). Also the profiler's count and
    host time of ``cudaFuncSetAttribute`` calls in the burst."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from seldon_tpu_torch.servers.engine import InferenceEngine

    eng = InferenceEngine(srv.params, srv.cfg, srv.engine.ecfg, dev)
    eng.start()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with BurstTap() as tap:
                run_concurrent(
                    lambda r: eng.generate_blocking(r["prompt_token_ids"],
                                                    srv._to_sampling(r)),
                    reqs, timeout_s=600)
            torch.cuda.synchronize()
    finally:
        eng.stop()
    out = tap.bounds_by_leg()
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
    calls = len(tap.calls)
    attr = [e for e in prof.key_averages() if e.key == "cudaFuncSetAttribute"]
    for leg, d in out.items():
        if not d.get("device_ms") or not d["launches"]:
            raise AssertionError(f"no B1 kernel record for the {leg} leg: "
                                 f"{kernels}")
        d["ms_per_launch"] = d["device_ms"] / d["launches"]
        d["bound_ms_per_launch"] = d["bound_ms"] / d["launches"]
        d["over_bound_ms"] = d["device_ms"] - d["bound_ms"]
    res = {"legs": out, "kernel_records": kernels,
           "host_us_per_call": tap.host_s / calls * 1e6,
           "cudaFuncSetAttribute": {
               "calls": sum(e.count for e in attr),
               "host_ms": sum(e.cpu_time_total for e in attr) / 1e3},
           "wrapper_calls": calls}
    for leg, d in sorted(out.items()):
        log(f"burst B1 {leg:7s} launches={d['launches']} device_ms="
            f"{d['device_ms']:.3f} ({d['ms_per_launch']:.4f} per launch) "
            f"bound_ms={d['bound_ms']:.3f} ({d['bound_ms_per_launch']:.4f} "
            f"per launch) over_bound_ms={d['over_bound_ms']:.3f}")
    log(f"burst B1 host time per wrapper call "
        f"{res['host_us_per_call']:.1f} us over {calls} calls "
        f"(cudaFuncSetAttribute: {res['cudaFuncSetAttribute']['calls']} "
        f"calls in the burst); kernels "
        + "; ".join(f"{n}x {k[:70]}" for k, n in sorted(kernels.items())))
    return res


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
    checked layer (first, middle, last) is followed by the plain version
    on the same inputs, on the card, and the comparison is kept. A
    forward calls the kernel once per layer in layer order, so the
    launch count modulo the depth is the layer. Waits for the device at
    every checked launch; never active on a timed run."""

    def __init__(self, n_layers):
        self.n_layers = n_layers
        self.layers = {0, n_layers // 2, n_layers - 1}
        self.calls = 0
        self.checks = []

    def __enter__(self):
        from seldon_tpu_torch.ops import flash_attention as fa

        self._fa, self._orig = fa, fa.flash_kernel

        def tapped(q, k, v, causal, q_offset, block_q, block_k, q_per_kv):
            out = self._orig(q, k, v, causal, q_offset, block_q, block_k,
                             q_per_kv)
            if self.calls % self.n_layers in self.layers:
                want = fa.flash_blockwise(q, k, v, causal, q_offset,
                                          block_k, q_per_kv)
                self.checks.append(dict(compare_flash(out, want),
                                        layer=self.calls % self.n_layers))
            self.calls += 1
            return out

        fa.flash_kernel = tapped
        return self

    def __exit__(self, *exc):
        self._fa.flash_kernel = self._orig


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
        gen = torch.Generator(device=dev).manual_seed(0)
        fa.reset_launches()  # count only this generate call's launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lens = generate(params, tokens, plens, gen, *knobs, c, GEN_NEW)
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
    """{library: version or None} of the transport libraries here."""
    import importlib
    import importlib.util

    out = {}
    for name in ("aiohttp", "grpc", "google.protobuf", "prometheus_client"):
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
            f"(phase 4 in-process {serve['tokens_per_s']:.1f}) "
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
    order). Copies on the card wait for nothing."""

    def __init__(self, n_layers):
        leg = QDOTS_PER_LAYER * n_layers
        self.want = (set(range(QDOTS_PER_LAYER))
                     | set(range(leg, leg + QDOTS_PER_LAYER)))
        self.calls = 0
        self.kept = []

    def __enter__(self):
        from seldon_tpu_torch.models import transformer

        self._mod, self._orig = transformer, transformer._int_mm

        def tapped(xq, w):
            y = self._orig(xq, w)
            if self.calls in self.want:
                self.kept.append((xq.clone(), w, y.clone()))
            self.calls += 1
            return y

        transformer._int_mm = tapped
        return self

    def __exit__(self, *exc):
        self._mod._int_mm = self._orig

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
    and ``_int_mm`` launches, the burst once more under the profiler
    (device idle share, top kernels), and the 6 greedy requests once
    more under LogitTap and KernelTap.

    Gates: B1 launches = layers x wave legs and ``_int_mm`` launches =
    7 x layers x wave legs (W8A8; 0 weight-only); layer 0's codes and
    scales quantized on the card equal the CPU's bit for bit; the kept
    W8A8 products of layer 0 equal the int64 numpy product bit for bit;
    on the greedy run, B1 agrees with its plain version on this path's
    own inputs within the phase-3 tolerances. Reported only: the median
    |logit diff| against the bf16 kernel leg at full depth (phase 6)."""
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
        imm = IntMmTap(cfg.n_layers)
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
        res["profile"] = phase_profile(q, reqs, dev)
        ecfg = q.engine.ecfg
        q.engine = None
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
        ulp = torch.nextafter(scale, torch.full_like(scale, 2.0)) - scale
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

    binders = {"ragged_paged_attention": rpa._kernel_lib,
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
    log(f"build: {len(binders)} sources in {wall:.1f} s")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    # Full f32 for the plain versions' and the masked leg's f32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from seldon_tpu_torch.models.config import get_config

    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}
    seconds = report["phase_seconds"] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        log(f"phase {name} seconds={seconds[name]:.1f}")
        return out

    report["build"] = timed("build", phase_build)

    cfg = get_config("llama3-8b")
    report["kernel"] = timed("kernel", phase_kernel, cfg, dev)
    report["flash_kernel"] = timed("flash_kernel", phase_flash_kernel, cfg,
                                   dev)
    report["flash_f32"] = timed("flash_f32", phase_flash_f32, cfg, dev)
    srv, reqs, toks, report["serve"] = timed("serve", phase_serve, dev)
    report["profile"] = timed("profile", phase_profile, srv, reqs, dev)
    report["burst_kernel"] = timed("burst_kernel", phase_burst_kernel, srv,
                                   reqs, dev)
    report["legs"], bf16_kernel = timed("legs", phase_legs, srv, reqs, toks,
                                        dev)
    report["score"] = timed("score", phase_score, srv, dev)
    report["generate"] = timed("generate", phase_generate, srv, dev)
    report["predict"] = timed("predict", phase_predict, srv)
    report["wire"] = timed("wire", phase_wire, srv, reqs, toks,
                           report["serve"], dev)
    gc.collect()
    torch.cuda.empty_cache()
    report["int8"] = timed("int8", phase_int8, srv, reqs, bf16_kernel, dev)
    del srv, bf16_kernel
    gc.collect()
    torch.cuda.empty_cache()
    report["noise"] = timed("noise", phase_noise, cfg, dev)
    report["moe"] = timed("moe", phase_moe, dev)

    head = report["kernel"][0]  # the decode shape, bf16 pool
    burst = report["burst_kernel"]["legs"]
    flash = report["flash_kernel"]
    tc_head = flash[0]  # the score shape (a), bf16
    f32_head = next(r for r in flash if r["dtype"] == "f32")  # (c), f32
    by_shape = [{k: r.get(k) for k in (
        "shape", "dtype", "B", "Sq", "Skv", "q_offset", "causal", "ms",
        "plain_ms", "library_ms", "bound_ms", "bound_by", "tflops",
        "bound_share", "max_abs_err", "differ_share", "beyond_ulp",
        "f32sum_beyond_ulp", "f32sum_differ_share")} for r in flash]
    kernels = {"kernels": [{
        "name": "ragged_paged_attention_partials",
        "route": "cuda",
        "source": "seldon_tpu_torch/csrc/ragged_paged_attention.cu",
        "replaces": "seldon_tpu/ops/ragged_paged_attention.py:373",
        "launches": report["serve"]["launches"],
        "max_abs_err": max([max(r["err_m"], r["err_acc"])
                            for r in report["kernel"]]
                           + [max(e[0], e[2]) for e in
                              report["legs"]["tap"]["errors"].values()]),
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
                     for r in report["kernel"]],
        "burst": {leg: {k: d[k] for k in ("launches", "ms_per_launch",
                                          "bound_ms_per_launch")}
                  for leg, d in burst.items()},
        "burst_host_us_per_call": report["burst_kernel"]["host_us_per_call"],
    }, {
        "name": "flash_attention_bf16_fwd",
        "route": "cuda",
        "source": "seldon_tpu_torch/csrc/flash_attention.cu",
        "replaces": "seldon_tpu/ops/flash_attention.py:61",
        "launches": report["score"]["launches"],
        "launches_generate": report["generate"]["flash_first"]["launches"],
        "max_abs_err": max([r["max_abs_err"] for r in flash
                            if r["dtype"] == "bf16"]
                           + [c["max_abs_err"]
                              for c in report["score"]["tap"]]),
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
        "launches": report["flash_f32"]["launches"],
        "launches_on": "ops.flash_attention.flash_attention, f32 (the "
                       "port's models are bf16)",
        "max_abs_err": max(f32_head["max_abs_err"],
                           report["flash_f32"]["max_abs_err"]),
        "ms": f32_head["ms"],
        "plain_ms": f32_head["plain_ms"],
        "bound_ms": f32_head["bound_ms"],
        "bound_by": f32_head["bound_by"],
        "library_ms": f32_head["library_ms"],
        "by_shape": [r for r in by_shape if r["dtype"] == "f32"],
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
