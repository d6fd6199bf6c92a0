"""Shared helpers of the tests that hold seldon_tpu_torch against the JAX
package: the same numpy inputs, made from a seed, go through both.

Tensors cross as numpy arrays; bf16 crosses bit for bit as its 16-bit
pattern, so the port never needs ml_dtypes."""

import numpy as np
import pytest
import torch

import jax

from seldon_tpu.models import transformer as jtf
from seldon_tpu_torch.models import convert


@pytest.fixture(scope="module", autouse=True)
def one_intra_op_thread():
    """Import into a test module whose engines and servers run their own
    threads (scheduler, fetcher, watchdog helper, transports): torch's
    intra-op pool beside them only oversubscribes a loaded test host (a
    storm test took 45x longer with four such files at once). Every
    comparison in the module runs both sides with the same setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_torch(x) -> torch.Tensor:
    """numpy / jax array -> CPU tensor of the same dtype (bf16 kept)."""
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def f32(x) -> np.ndarray:
    """Any array or tensor as a float32 numpy array, for comparisons."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x).astype(np.float32)


def bits(x) -> np.ndarray:
    """The raw bit pattern of a bf16 array or tensor (exact comparisons)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().contiguous().view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


def params_pair(cfg, seed: int = 0):
    """(JAX params, the same weights as the port's Transformer on CPU)."""
    jparams = jtf.init_params(cfg, jax.random.key(seed))
    tree = jax.tree.map(np.asarray, jparams)
    return jparams, convert.params_from_numpy(tree, cfg, device="cpu")


# ---------------------------------------------------------------------------
# Engine parity: the same burst through the JAX engine and the port's
# ---------------------------------------------------------------------------

ENGINE_ECFG = dict(max_slots=4, max_seq_len=64, prompt_buckets=(16, 32),
                   paged_kv=True, kv_block=8, kv_pool_blocks=4 * 8 + 1,
                   chunked_prefill=True, prefill_chunk=16, prefix_block=8,
                   ragged=True)
ENGINE_LENGTHS = [12, 26, 7, 30, 16, 3]


def engine_prompts(cfg, seed=29):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, cfg.vocab_size, size=(n,)).tolist()
            for n in ENGINE_LENGTHS]


def drain(q):
    toks = []
    while True:
        item = q.get(timeout=120)
        if item is None:
            return toks
        assert "error" not in item, item
        toks.extend(item["tokens"])


def _copying(asarray):
    def copied(x, *args, **kwargs):
        return asarray(x.copy() if isinstance(x, np.ndarray) else x,
                       *args, **kwargs)
    return copied


def run_jax_engine(params, cfg, prompts, knobs, ecfg=None):
    """The reference streams of ``prompts``, request i sampled with
    ``knobs`` and seed i. The JAX engine runs with an ``asarray`` that
    copies numpy input (ROADMAP.md C3: on the CPU ``jnp.asarray`` may
    alias the engine's live host block table); it changes no value."""
    import pytest
    import jax.numpy as jnp

    from seldon_tpu.models.sampling import SamplingParams
    from seldon_tpu.servers import engine as jeng

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnp, "asarray", _copying(jnp.asarray))
        eng = jeng.InferenceEngine(params, cfg,
                                   jeng.EngineConfig(**(ecfg or ENGINE_ECFG)))
        eng.start()
        try:
            qs = [eng.submit(p, SamplingParams(seed=i, **knobs))
                  for i, p in enumerate(prompts)]
            return [drain(q) for q in qs]
        finally:
            eng.stop()


def run_torch_engine(params, cfg, prompts, knobs, kernel, ecfg=None,
                     **extra):
    """The port's streams of the same burst on the CPU; returns (streams,
    engine)."""
    from seldon_tpu_torch.models.sampling import SamplingParams
    from seldon_tpu_torch.servers import engine as teng

    eng = teng.InferenceEngine(
        params, cfg, teng.EngineConfig(**(ecfg or ENGINE_ECFG),
                                       ragged_kernel=kernel, **extra),
        device="cpu")
    eng.start()
    try:
        qs = [eng.submit(p, SamplingParams(seed=i, **knobs))
              for i, p in enumerate(prompts)]
        streams = [drain(q) for q in qs]
    finally:
        eng.stop()
    assert eng.debug_lifecycle_check() == {}
    return streams, eng


def top2_gap(row) -> float:
    top2 = np.sort(np.asarray(row, np.float32))[-2:]
    return float(top2[1] - top2[0])


def assert_streams_match(got, want, jparams, cfg, prompts, what, knobs=None,
                         seeds=None, atol=None):
    """Equal streams, or a divergence the reference puts at a near-tie,
    reported, not hidden. Greedy requests: the top-2 gap of the
    reference's logits there is below RAGGED_LOGITS_ATOL. Sampled ones:
    the top-2 gap of the masked, temperature-scaled logits plus the
    request's Gumbel noise (JAX's, keyed by (seed, position)) is below
    it, or, under top-k, the k-th and (k+1)-th scaled logits are (the
    mask's edge moves with a logit difference that small). Request r's
    seed is ``seeds[r]``, r by default. ``atol``: the near-tie bound,
    RAGGED_LOGITS_ATOL by default (bf16 models); f32 models pass theirs."""
    import jax
    import jax.numpy as jnp

    from seldon_tpu.models import sampling as jsm
    from seldon_tpu_torch.ops.ragged_paged_attention import (
        RAGGED_LOGITS_ATOL)

    atol = RAGGED_LOGITS_ATOL if atol is None else atol
    knobs = knobs or {"temperature": 0.0}
    temp = knobs.get("temperature", 0.0)
    top_k = knobs.get("top_k", 0)
    for r, (g, w) in enumerate(zip(got, want)):
        if g == w:
            continue
        i = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b),
                 min(len(g), len(w)))
        ctx = prompts[r] + w[:i]
        logits = jtf.forward(jparams, jnp.asarray([ctx], jnp.int32),
                             cfg)[0, -1:]
        edge = np.inf
        if temp > 0:
            scaled = logits / temp
            if top_k:
                desc = np.sort(np.asarray(scaled[0]))[::-1]
                edge = float(desc[top_k - 1] - desc[top_k])
            scaled = jsm._mask_top_k_top_p(
                scaled, jnp.asarray([top_k], jnp.int32),
                jnp.asarray([knobs.get("top_p", 1.0)], jnp.float32))
            seed = r if seeds is None else seeds[r]
            key = jax.random.fold_in(jax.random.key(np.uint32(seed)),
                                     len(ctx))
            logits = scaled + jax.random.gumbel(key, (cfg.vocab_size,),
                                                jnp.float32)
        gap = top2_gap(np.asarray(logits[0]))
        assert min(gap, edge) < atol, (what, r, i, g, w, gap, edge)
        print(f"near-tie reported: {what} stream {r} token {i} top-2 gap "
              f"{gap} top-k edge gap {edge}")


# ---------------------------------------------------------------------------
# Servers on real sockets: aiohttp apps on one background loop, gRPC
# servers on their own threads, stdlib clients
# ---------------------------------------------------------------------------


class RestServers:
    """Serve aiohttp apps on 127.0.0.1 port 0 from one event loop on a
    background thread (blocking a loop that hosts them from the caller's
    thread would deadlock). ``ports[i]`` is app i's port."""

    def __init__(self, *apps):
        import asyncio
        import threading

        from aiohttp import web

        self.ports = []
        self._stop = threading.Event()
        started = threading.Event()

        async def amain():
            runners = []
            for app in apps:
                runner = web.AppRunner(app)
                await runner.setup()
                site = web.TCPSite(runner, "127.0.0.1", 0)
                await site.start()
                self.ports.append(site._server.sockets[0].getsockname()[1])
                runners.append(runner)
            started.set()
            while not self._stop.is_set():
                await asyncio.sleep(0.02)
            for runner in runners:
                await runner.cleanup()

        self._thread = threading.Thread(target=lambda: asyncio.run(amain()),
                                        daemon=True)
        self._thread.start()
        assert started.wait(30), "REST servers did not start"

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)
        assert not self._thread.is_alive()


def grpc_server(wrapper_mod, user_obj):
    """(server, port): ``wrapper_mod.build_grpc_server`` on port 0."""
    server = wrapper_mod.build_grpc_server(user_obj)
    port = server.add_insecure_port("127.0.0.1:0")
    server.start()
    return server, port


def http_request(port, method, path, body=None, headers=None, timeout=120):
    """(status, body bytes) of one HTTP request; a dict body goes as
    JSON."""
    import http.client
    import json

    hdrs = dict(headers or {})
    if isinstance(body, dict):
        body = json.dumps(body).encode()
        hdrs.setdefault("Content-Type", "application/json")
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def ndjson_stream(port, body, headers=None, timeout=120):
    """(status, parsed lines) of a POST /generate_stream."""
    import json

    status, raw = http_request(port, "POST", "/generate_stream", body,
                               headers, timeout)
    return status, [json.loads(line) for line in raw.splitlines() if line]


class EngineThread:
    """An ``EngineServer`` of either package started on 127.0.0.1 from an
    event loop on a background thread, so that blocking client calls from
    the caller's thread never block the loop that hosts grpc.aio. Its
    ports are ``http`` and ``grpc``; ``close()`` stops it."""

    def __init__(self, es, timeout=30):
        import asyncio
        import threading

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
            except BaseException as e:  # surfaced by the caller
                self.errors.append(e)
                started.set()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        assert started.wait(timeout), "engine server did not start"
        assert not self.errors, self.errors
        self.http, self.grpc = es.http_port, es.grpc_port

    def close(self):
        self._stop.set()
        self._thread.join(timeout=30)
        assert not self._thread.is_alive(), "engine server did not stop"
        assert not self.errors, self.errors
