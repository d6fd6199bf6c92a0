"""Load tester — port of ``seldon_tpu/loadtester.py``.

One asyncio process with N closed-loop clients drives an engine or a
unit over REST, gRPC or the LLM routes:

  python -m seldon_tpu_torch.loadtester http://host:8000 \
      --clients 64 --seconds 30 --transport rest \
      [--payload '{"data":{"ndarray":[[1.0]]}}'] [--grpc-host host:5001]

  python -m seldon_tpu_torch.loadtester http://host:9000 \
      --transport generate --clients 8 --seconds 20 --max-new-tokens 32 \
      [--cancel-frac 0.25] [--deadline-ms 500 --deadline-frac 0.25]

Prints one JSON line: req/s, error count, p50/p90/p99 latency — the same
shape bench_orchestrator.py reports — and, for ``--transport generate``,
tokens/s, the TTFT / ITL percentiles, the outcome ledger and whatever the
server's ``/debug/compile|sched|pilot|roof`` routes answer. Flags, seeded
draws (cancels ``default_rng(2)``, deadlines ``default_rng(4)``) and
JSON keys are the JAX tool's.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
import time
from typing import List, Optional

import numpy as np

from seldon_tpu_torch.core import tracing

logger = logging.getLogger(__name__)


async def _closed_loop(url_path: str, body: bytes, clients: int,
                       seconds: float, on_response=None, on_reject=None):
    """Shared closed-loop HTTP load loop: N workers hammer one endpoint
    until the deadline. `on_response` (async, gets the aiohttp response)
    does transport-specific accounting; non-200s and exceptions count
    as errors and are excluded from latency. `on_reject(status)` lets a
    transport classify non-200s (429 shed vs 503 draining vs real
    failure) instead of lumping them into one error count."""
    import aiohttp

    stop_at = time.perf_counter() + seconds
    latencies: List[float] = []
    errors = [0]
    headers = {"Content-Type": "application/json"}

    async def worker(session):
        n = 0
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                # Callable bodies generate a fresh payload per request
                # (shared-prefix workloads need per-request prompts).
                data = body() if callable(body) else body
                async with session.post(url_path, data=data,
                                        headers=headers) as r:
                    if r.status != 200:
                        await r.read()
                        errors[0] += 1
                        if on_reject is not None:
                            on_reject(r.status)
                        continue
                    if on_response is not None:
                        # t0 lets transports time INSIDE the response
                        # (streaming TTFT / inter-chunk gaps).
                        await on_response(r, t0)
                    else:
                        await r.read()
            except Exception:
                errors[0] += 1
                continue
            latencies.append(time.perf_counter() - t0)
            n += 1
        return n

    conn = aiohttp.TCPConnector(limit=clients)
    async with aiohttp.ClientSession(connector=conn) as session:
        t0 = time.perf_counter()
        counts = await asyncio.gather(
            *[worker(session) for _ in range(clients)]
        )
        dt = time.perf_counter() - t0
    return sum(counts), dt, latencies, errors[0]


async def run_rest(url: str, payload: bytes, clients: int, seconds: float,
                   path: str = "/api/v0.1/predictions"):
    return await _closed_loop(url.rstrip("/") + path, payload, clients,
                              seconds)


async def run_grpc(target: str, payload_rows, clients: int, seconds: float):
    import grpc.aio

    from seldon_tpu_torch.core import payloads as plib
    from seldon_tpu_torch.proto import prediction_grpc

    channel = grpc.aio.insecure_channel(target)
    stub = prediction_grpc.SeldonStub(channel)
    req = plib.build_message(np.asarray(payload_rows, np.float32),
                             kind="ndarray")
    stop_at = time.perf_counter() + seconds
    latencies: List[float] = []
    errors = [0]

    async def worker():
        n = 0
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            try:
                await stub.Predict(req)
            except Exception:
                errors[0] += 1
                continue
            latencies.append(time.perf_counter() - t0)
            n += 1
        return n

    t0 = time.perf_counter()
    counts = await asyncio.gather(*[worker() for _ in range(clients)])
    dt = time.perf_counter() - t0
    await channel.close()
    return sum(counts), dt, latencies, errors[0]


def parse_decode_len_dist(spec: str) -> Optional[tuple]:
    """Parse --decode-len-dist. Supported: "uniform:a,b" — each request
    draws max_new_tokens uniformly from [a, b]. Empty spec -> None
    (every request uses the fixed --max-new-tokens)."""
    if not spec:
        return None
    kind, _, rest = spec.partition(":")
    if kind != "uniform":
        raise ValueError(
            f"unknown decode-len-dist {spec!r} (supported: uniform:a,b)"
        )
    try:
        a, b = (int(x) for x in rest.split(","))
    except Exception:
        raise ValueError(
            f"decode-len-dist {spec!r} needs two ints: uniform:a,b"
        )
    if not 1 <= a <= b:
        raise ValueError(
            f"decode-len-dist bounds must satisfy 1 <= a <= b, got {spec!r}"
        )
    return (a, b)


class _StreamAborted(Exception):
    """Stream ended in a non-completed outcome (already accounted)."""


async def run_generate(url: str, clients: int, seconds: float,
                       prompt: str = "benchmark prompt",
                       max_new_tokens: int = 32,
                       temperature: float = 0.0,
                       shared_prefix_frac: float = 0.0,
                       shared_prefix: str = "",
                       stream: bool = True,
                       decode_len_dist: str = "",
                       cancel_frac: float = 0.0,
                       deadline_ms: int = 0,
                       deadline_frac: float = 1.0,
                       trace_sample: float = 0.0):
    """LLM serving load: closed-loop generation clients. Latency is full
    completion time; tokens/s is the serving-throughput number. Greedy
    by default so completion lengths — and therefore tokens/s — are
    reproducible across runs.

    stream=True (default) drives /generate_stream (NDJSON, one line per
    decode-chunk burst) and records per-stream TTFT (request send ->
    first line) and inter-token latency (gap between consecutive lines,
    divided by the tokens the later line carried) — the numbers that
    make a prefill stall visible. stream=False reverts to the unary
    /generate endpoint.

    shared_prefix_frac > 0 switches to the SHARED-PREFIX workload: that
    fraction of requests opens with one common system prompt (the rest
    get per-request cold prefixes), so an engine with
    EngineConfig.prefix_cache serves them off retained KV — watch
    torchserver_prefix_hits / prefix_tokens_saved move.

    decode_len_dist (e.g. "uniform:8,256") draws a fresh max_new_tokens
    per request — the short/long decode mix that exposes paged-KV pool
    churn and fragmentation (a fixed length never stresses the
    allocator's reuse path).

    Lifecycle injection: cancel_frac > 0 makes that fraction of
    streaming clients drop the connection after the first chunk (what a
    vanished browser does — the engine should cancel, not decode to
    max_tokens); deadline_ms > 0 stamps a per-request TTL on every
    request. Every request lands in exactly one `outcomes` bucket
    ({completed, shed, draining, deadline, cancelled, error}); `errors`
    stays the legacy everything-not-completed total. deadline_frac < 1
    stamps the TTL on only that fraction of requests — the
    MIXED-deadline wave an EDF scheduler (PILOT=1) reorders, leaving
    the rest to the no-deadline aging path.

    trace_sample > 0 stamps that fraction of requests with a freshly
    generated W3C traceparent (riding meta.tags like deadline_ms — the
    server-side engine adopts it when TRACING=1), and the sampled trace
    ids come back in the outcome ledger so a run's server-side spans
    can be pulled from the TRACING_FILE JSONL sink by trace id."""
    dist = parse_decode_len_dist(decode_len_dist)
    len_rng = np.random.default_rng(1)
    cancel_rng = np.random.default_rng(2)
    trace_rng = np.random.default_rng(3)
    deadline_rng = np.random.default_rng(4)
    sampled_traces: List[str] = []
    tokens = [0]
    ttfts: List[float] = []
    itls: List[float] = []
    outcomes = {"completed": 0, "shed": 0, "draining": 0,
                "deadline": 0, "cancelled": 0, "error": 0}

    def on_reject(status: int) -> None:
        # Pre-stream lifecycle statuses (engine.KIND_HTTP_STATUS): a TTL
        # that lapses while queued is a 504, not a trailer.
        if status == 429:
            outcomes["shed"] += 1
        elif status == 503:
            outcomes["draining"] += 1
        elif status == 504:
            outcomes["deadline"] += 1
        elif status == 499:
            outcomes["cancelled"] += 1
        else:
            outcomes["error"] += 1

    async def count_tokens(r, t0):
        out = await r.json()
        tokens[0] += int(out.get("completion_tokens", 0))
        outcomes["completed"] += 1

    async def consume_stream(r, t0):
        last = None
        n_total = 0
        want_cancel = cancel_frac > 0.0 and (
            cancel_rng.random() < cancel_frac
        )
        async for line in r.content:
            if not line.strip():
                continue
            now = time.perf_counter()
            out = json.loads(line)
            if "error" in out:
                # In-band trailer (headers already went out 200): the
                # `kind` field says how the request actually ended.
                kind = out.get("kind", "")
                outcomes[
                    kind if kind in ("deadline", "cancelled") else "error"
                ] += 1
                raise _StreamAborted(out["error"])
            n_toks = len(out.get("token_ids", ()))
            if last is None:
                ttfts.append(now - t0)
            elif n_toks:
                # One burst may carry several tokens: spread the gap so
                # the percentile reflects per-TOKEN latency.
                itls.extend([(now - last) / n_toks] * n_toks)
            last = now
            n_total = int(out.get("completion_tokens", n_total))
            if want_cancel:
                # Simulated client disconnect mid-stream: hard-close the
                # connection and walk away (no graceful shutdown).
                outcomes["cancelled"] += 1
                r.close()
                raise _StreamAborted("client cancelled")
        tokens[0] += n_total
        outcomes["completed"] += 1

    def payload(p: str) -> bytes:
        mnt = max_new_tokens if dist is None else int(
            len_rng.integers(dist[0], dist[1] + 1)
        )
        d = {
            "prompt": p, "max_new_tokens": mnt,
            "temperature": temperature,
        }
        tags = {}
        if deadline_ms > 0 and (
            deadline_frac >= 1.0 or deadline_rng.random() < deadline_frac
        ):
            # The REST edge parses this into a proto GenerateRequest,
            # which has no deadline field — the TTL rides meta.tags
            # (see seldon_methods._generate_request_dict).
            tags["deadline_ms"] = deadline_ms
        if trace_sample > 0.0 and trace_rng.random() < trace_sample:
            tp = tracing.new_traceparent()
            sampled_traces.append(tp.split("-")[1])  # bare trace id
            tags["traceparent"] = tp
        if tags:
            d["meta"] = {"tags": tags}
        return json.dumps(d).encode()

    if shared_prefix_frac > 0.0:
        # Long enough to span several prefix-cache blocks under the byte
        # tokenizer; uniqueness lives strictly AFTER the shared part.
        pre = shared_prefix or (
            "You are a serving benchmark assistant. Answer tersely. " * 4
        )
        rng = np.random.default_rng(0)
        uid = [0]

        def body() -> bytes:
            uid[0] += 1
            head = (pre if rng.random() < shared_prefix_frac
                    else f"cold prefix {uid[0]:08d}. ")
            return payload(f"{head}{prompt} #{uid[0]}")
    elif dist is not None:
        def body() -> bytes:  # fresh per-request decode length
            return payload(prompt)
    else:
        body = payload(prompt)
    path = "/generate_stream" if stream else "/generate"
    total, dt, lats, errors = await _closed_loop(
        url.rstrip("/") + path, body, clients, seconds,
        on_response=consume_stream if stream else count_tokens,
        on_reject=on_reject,
    )
    stream_stats = {}
    if stream:
        for name, samples in (("ttft", ttfts), ("itl", itls)):
            arr = np.asarray(samples) * 1000.0 if samples else np.zeros(1)
            for q in (50, 95, 99):
                stream_stats[f"{name}_p{q}_ms"] = round(
                    float(np.percentile(arr, q)), 2
                )
    if trace_sample > 0.0:
        # First few sampled ids in the ledger (the full run may sample
        # thousands): each one keys the server's TRACING_FILE JSONL sink.
        stream_stats["trace_sampled"] = len(sampled_traces)
        stream_stats["trace_ids"] = sampled_traces[:16]
    return total, dt, lats, errors, tokens[0], stream_stats, outcomes


def _compile_counts(url: str) -> dict:
    """Best-effort /debug/compile poll after a run: folds the server's
    compile-variant and live-retrace counts into the ledger so load
    results carry their lattice cost. Empty when the server has no
    compile ledger (COMPILE_LEDGER off -> the route 404s)."""
    import urllib.request
    try:
        # Short timeout: this poll runs after the load window closed, so
        # a server mid-drain may never answer — don't hold the ledger
        # line hostage for it.
        with urllib.request.urlopen(
            url.rstrip("/") + "/debug/compile", timeout=2
        ) as resp:
            comp = json.loads(resp.read())
        # Per-family counts alongside the total: a key's family is its
        # first '/'-segment ("admit-prefix/64/16/1" -> "admit-prefix"),
        # so the ragged collapse is legible in the post-run ledger
        # — a ragged run shows {"deactivate": 1, "ragged": 1} where the
        # bucketed lattice fans out per family.
        by_family: dict = {}
        for entry in comp.get("lattice", []):
            fam = str(entry["key"]).split("/", 1)[0]
            by_family[fam] = by_family.get(fam, 0) + 1
        return {
            "compile_variants": int(comp["dispatched_variants"]),
            "compile_variants_by_family": dict(sorted(by_family.items())),
            "live_retraces": int(comp["live_retrace_count"]),
            "compile_s_total": float(comp["compile_s_total"]),
        }
    except (OSError, ValueError, KeyError) as exc:
        # 404 (ledger off), connection teardown, or a foreign schema —
        # the ledger line simply goes without compile counters.
        logger.debug("loadtester: /debug/compile poll failed (%s: %s) — "
                     "ledger carries no compile counters",
                     type(exc).__name__, exc)
        return {}


def _sched_counts(url: str) -> dict:
    """Best-effort /debug/sched poll after a run: folds the server's
    waste attribution (padding_waste_frac, budget utilization, the
    goodput-gap scalar + breakdown) into the ledger. Empty when the
    server has no sched ledger (SCHED_LEDGER off -> the route 404s)."""
    import urllib.request
    try:
        # Same short-timeout rationale as _compile_counts above.
        with urllib.request.urlopen(
            url.rstrip("/") + "/debug/sched", timeout=2
        ) as resp:
            sched = json.loads(resp.read())
        gap = sched["goodput_gap"]
        return {
            "padding_waste_frac": float(sched["padding_waste_frac"]),
            "budget_utilization": float(sched["budget_utilization"]),
            "goodput_gap": round(
                float(gap["bucket_pad_frac"]) + float(gap["group_pad_frac"])
                + float(gap.get("spec_rejected_frac", 0.0))
                + float(gap["frag_frac"]), 6
            ),
            "goodput_gap_breakdown": {
                k: float(v) for k, v in gap.items()
            },
            # Speculative-decoding acceptance accounting (all-zero when SPEC off;
            # tolerant of a pre-spec server schema).
            "spec_acceptance_rate": float(
                sched.get("spec", {}).get("acceptance_rate", 1.0)
            ),
            "spec_drafted_tokens": int(
                sched.get("spec", {}).get("drafted_tokens", 0)
            ),
            "spec_accepted_tokens": int(
                sched.get("spec", {}).get("accepted_tokens", 0)
            ),
            "sched_conservation_breaches": int(
                sched["conservation"]["breaches"]
            ),
        }
    except (OSError, ValueError, KeyError) as exc:
        logger.debug("loadtester: /debug/sched poll failed (%s: %s) — "
                     "ledger carries no waste counters",
                     type(exc).__name__, exc)
        return {}


def _pilot_counts(url: str) -> dict:
    """Best-effort /debug/pilot poll after a run: folds the controller's
    final decision count, knob values and EDF counters into the ledger —
    the "what did the autopilot actually do" line for a load run. Empty
    when the server flies no pilot (PILOT off -> the route 404s)."""
    import urllib.request
    try:
        # Same short-timeout rationale as _compile_counts above.
        with urllib.request.urlopen(
            url.rstrip("/") + "/debug/pilot", timeout=2
        ) as resp:
            pilot = json.loads(resp.read())
        return {
            "pilot_decisions": int(pilot["decisions_total"]),
            "pilot_decisions_by_knob": {
                k: int(v) for k, v in pilot["decisions_by_knob"].items()
            },
            "pilot_knobs": dict(pilot["knobs"]),
            "pilot_edf_inversions": int(pilot["edf"]["inversions"]),
            "pilot_expired_at_pop": int(pilot["edf"]["expired_at_pop"]),
            "pilot_goodput_delta": float(
                pilot["counterfactual"]["goodput_delta"]
            ),
        }
    except (OSError, ValueError, KeyError) as exc:
        logger.debug("loadtester: /debug/pilot poll failed (%s: %s) — "
                     "ledger carries no pilot counters",
                     type(exc).__name__, exc)
        return {}


def _roof_counts(url: str) -> dict:
    """Best-effort /debug/roof poll after a run: folds the roof ledger's
    headline roofline numbers (achieved mfu/mbu, the host share of
    boundary wall time, the conservation-audit breach count) into the
    ledger. Empty when the server has no roof ledger (ROOF_LEDGER off
    -> the route 404s)."""
    import urllib.request
    try:
        # Same short-timeout rationale as _compile_counts above.
        with urllib.request.urlopen(
            url.rstrip("/") + "/debug/roof", timeout=2
        ) as resp:
            roof = json.loads(resp.read())
        return {
            "mfu": float(roof["totals"]["mfu"]),
            "mbu": float(roof["totals"]["mbu"]),
            "host_frac": float(roof["host_frac"]),
            "roof_conservation_breaches": int(
                roof["conservation"]["breaches"]
            ),
        }
    except (OSError, ValueError, KeyError) as exc:
        logger.debug("loadtester: /debug/roof poll failed (%s: %s) — "
                     "ledger carries no roofline counters",
                     type(exc).__name__, exc)
        return {}


def report(transport: str, total: int, dt: float, latencies, errors: int,
           clients: int, extra: Optional[dict] = None) -> dict:
    lats = np.asarray(latencies) * 1000.0 if latencies else np.zeros(1)
    out = {
        "metric": f"loadtest_{transport}_req_per_s",
        "value": round(total / dt, 1) if dt else 0.0,
        "unit": f"req/s ({clients} clients)",
        "detail": {
            "requests": total,
            "errors": errors,
            "p50_ms": round(float(np.percentile(lats, 50)), 2),
            "p90_ms": round(float(np.percentile(lats, 90)), 2),
            "p99_ms": round(float(np.percentile(lats, 99)), 2),
            **(extra or {}),
        },
    }
    print(json.dumps(out))
    return out


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description="seldon-tpu-torch load tester")
    parser.add_argument("url", help="engine base URL (http://host:port)")
    parser.add_argument("--clients", type=int, default=64)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--transport", choices=["rest", "grpc", "generate"],
                        default="rest")
    parser.add_argument("--payload",
                        default='{"data": {"ndarray": [[1.0, 2.0]]}}')
    parser.add_argument("--grpc-host", default="",
                        help="host:port for --transport grpc")
    parser.add_argument("--path", default="/api/v0.1/predictions")
    parser.add_argument("--prompt", default="benchmark prompt")
    parser.add_argument("--max-new-tokens", type=int, default=32)
    parser.add_argument("--temperature", type=float, default=0.0)
    parser.add_argument("--shared-prefix-frac", type=float, default=0.0,
                        help="fraction of /generate requests opening with "
                             "one shared system prompt (prefix-cache "
                             "workload); 0 disables")
    parser.add_argument("--shared-prefix", default="",
                        help="override the shared system prompt text")
    parser.add_argument("--decode-len-dist", default="",
                        help="--transport generate: per-request "
                             "max_new_tokens distribution, e.g. "
                             "uniform:8,256 (short/long decode mix — the "
                             "workload that exposes paged-KV pool churn); "
                             "empty uses --max-new-tokens for every "
                             "request")
    parser.add_argument("--no-stream", action="store_true",
                        help="--transport generate: use the unary "
                             "/generate endpoint instead of streaming "
                             "/generate_stream (drops TTFT/ITL "
                             "percentiles from the summary)")
    parser.add_argument("--cancel-frac", type=float, default=0.0,
                        help="--transport generate: fraction of streaming "
                             "clients that drop the connection after the "
                             "first chunk (mid-stream disconnect "
                             "injection); 0 disables")
    parser.add_argument("--deadline-ms", type=int, default=0,
                        help="--transport generate: per-request TTL in "
                             "ms stamped on every request (deadline "
                             "injection); 0 disables")
    parser.add_argument("--deadline-frac", type=float, default=1.0,
                        help="--transport generate: fraction of requests "
                             "the --deadline-ms TTL is stamped on (mixed-"
                             "deadline wave for the EDF scheduler); 1.0 "
                             "stamps every request")
    parser.add_argument("--trace-sample", type=float, default=0.0,
                        help="--transport generate: fraction of requests "
                             "stamped with a generated W3C traceparent "
                             "(server adopts it when TRACING=1); sampled "
                             "trace ids print in the outcome ledger for "
                             "span-sink lookup. 0 disables")
    args = parser.parse_args(argv)

    if args.transport == "generate":
        total, dt, lats, errors, toks, stream_stats, outcomes = asyncio.run(
            run_generate(args.url, args.clients, args.seconds,
                         args.prompt, args.max_new_tokens,
                         args.temperature, args.shared_prefix_frac,
                         args.shared_prefix, stream=not args.no_stream,
                         decode_len_dist=args.decode_len_dist,
                         cancel_frac=args.cancel_frac,
                         deadline_ms=args.deadline_ms,
                         deadline_frac=args.deadline_frac,
                         trace_sample=args.trace_sample)
        )
        extra = {"completion_tokens": toks,
                 "tokens_per_s": round(toks / dt, 1) if dt else 0.0,
                 "outcomes": outcomes,
                 **stream_stats}
        if args.shared_prefix_frac > 0.0:
            extra["shared_prefix_frac"] = args.shared_prefix_frac
        if args.decode_len_dist:
            extra["decode_len_dist"] = args.decode_len_dist
        extra.update(_compile_counts(args.url))
        extra.update(_sched_counts(args.url))
        pilot = _pilot_counts(args.url)
        extra.update(pilot)
        roof = _roof_counts(args.url)
        extra.update(roof)
        report("generate", total, dt, lats, errors, args.clients,
               extra=extra)
        if pilot:
            # Human-readable autopilot postscript (the JSON ledger line
            # above stays machine-parseable and last-but-one).
            print(
                f"pilot: {pilot['pilot_decisions']} decisions, "
                f"final knobs {pilot['pilot_knobs']}, "
                f"{pilot['pilot_edf_inversions']} EDF inversions",
                file=sys.stderr,
            )
        if roof:
            # Roofline postscript: how hard the hardware ran and how
            # much of each boundary the host ate.
            print(
                f"roof: mfu={roof['mfu']:.4f} mbu={roof['mbu']:.4f} "
                f"host_frac={roof['host_frac']:.4f}",
                file=sys.stderr,
            )
        return
    if args.transport == "rest":
        total, dt, lats, errors = asyncio.run(
            run_rest(args.url, args.payload.encode(), args.clients,
                     args.seconds, args.path)
        )
    else:
        rows = json.loads(args.payload)["data"]["ndarray"]
        target = args.grpc_host or args.url.replace("http://", "")
        total, dt, lats, errors = asyncio.run(
            run_grpc(target, rows, args.clients, args.seconds)
        )
    report(args.transport, total, dt, lats, errors, args.clients)


if __name__ == "__main__":  # pragma: no cover
    main()
