"""Exact tensor parallelism on the card: two ranks sharing one card
(the explicit device list ``["cuda:0", "cuda:0"]``: gloo staged through
host buffers) serve ``tiny`` on the ragged kernel leg. Marked ``cuda``;
skipped where there is no card. This file imports neither jax nor the
JAX package, so it runs on a machine with only PyTorch for CUDA:

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_cuda.py

The tp=2 greedy streams equal tp=1's, every worker's per-slot state
equals rank 0's, and B1 (the hand-written kernel) launched on both
ranks, once per layer per wave leg on each. The dense engine's prefix
cache serves at tp=2 with tp=1's streams and every worker's store equal
to rank 0's trie. The port's projection GEMM (``ops/lt_gemm``) gives
each share of a column-sharded projection's columns at llama3-8b's
widths the full product's columns bit for bit at M = 1, 32 and 1527
rows in bf16 and in f32, has an algorithm for every row count a ragged
wave can give, the serving paths take it, and a worker with other GEMM
settings makes ``MeshEngine`` raise. The sparse walk's block score
product, the one product of the sparse leg that runs at tp = 1's head
count, gives each rank's heads the full product's scores bit for bit.

Four ranks on the one card serve the JAX server's other plans at tiny
width: the auto plan of four devices (``TorchServer._serving_mesh`` over
``["cuda:0"] * 4``: tp = 4 with 4 KV heads) bit-equal to tp = 1, with B1
launched on every rank; dp2 x tp2 with tp = 1's streams, each replica's
ranks launching B1 for its own wave legs, and on the dense engine; and
sp2 x tp2 with the ring config, whose ring score is within 2e-2 of one
device's "xla" score and whose context-parallel admission gives one
device's logits within 2e-2 and its first token. Under dp2 x tp2 both
prefix caches serve with tp = 1's streams and trie counters (a hit on
one replica reads KV moved from the other), and every product batched
over the slots of the sparse walk and of both verify bodies gives a
replica's half of the batch the whole batch's outputs bit for bit."""

import dataclasses

import numpy as np
import pytest
import torch

from seldon_tpu_torch import device as tdevice
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import lt_gemm
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.parallel.mesh import MeshPlan, make_mesh
from seldon_tpu_torch.servers import dp_replicas, mesh_engine, torchserver
from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

PROMPTS = [list(range(2, 2 + n)) for n in (5, 12, 24, 7)]
ECFG = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
            paged_kv=True, chunked_prefill=True, prefill_chunk=8,
            prefix_block=8, kv_block=8, ragged=True, ragged_kernel="pallas",
            async_fetch=False)


# llama3-8b's column-sharded projections: K = d_model, N the full width.
SHARDED = {"wq": 4096, "wk": 1024, "wv": 1024, "w_gate": 14336,
           "w_up": 14336}
DENSE_PREFIX = dict(max_slots=2, max_seq_len=64, prompt_buckets=(32, 64),
                    prefix_cache=True, prefix_block=8,
                    prefix_cache_bytes=6 * 2048, async_fetch=False)
PREFIX_PROMPTS = [list(range(40, 72)) + list(range(100 + 16 * i,
                                                   100 + 16 * i + n))
                  for i, n in enumerate((13, 20, 11, 17))]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_mesh_cuda.py")
    tdevice.configure_gemms()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def groups():
    """The file's one live group on the card (a process is rank 0 of one
    group at a time): ``get(mesh)`` spawns one on ``mesh``, lays the live
    one out on its plan when the devices are the same, else closes it
    first."""
    live = []

    def get(mesh):
        if live and live[0].mesh.flat_devices() == mesh.flat_devices():
            if live[0].mesh.shape != mesh.shape:
                live[0].replan(MeshPlan(**{a: n for a, n in mesh.shape.items()
                                           if n > 1}))
            return live[0]
        while live:
            live.pop().close()
        live.append(mesh_engine.spawn_group(mesh))
        return live[0]

    yield get
    while live:
        live.pop().close()


@pytest.fixture
def group(groups):
    """Two ranks sharing the card (gloo staged through host buffers),
    for the file's tp=2 cases; built on first use."""
    return lambda: groups(mesh_engine.build_tp_mesh(2, ["cuda:0", "cuda:0"]))


FOUR = ["cuda:0"] * 4


def _streams(eng, prompts=PROMPTS):
    qs = [eng.submit(p, SamplingParams(temperature=0.0, max_new_tokens=8))
          for p in prompts]
    eng.start()
    try:
        out = []
        for q in qs:
            toks = []
            while (item := q.get(timeout=300)) is not None:
                assert "error" not in item, item
                toks.extend(item["tokens"])
            out.append(toks)
        if isinstance(eng, mesh_engine.MeshEngine):
            eng.check_replicas()
        return out
    finally:
        eng.stop()


def _launches(worker):
    return rpa.launches


@pytest.mark.cuda
def test_tp2_on_one_card_equals_tp1(cuda, group):
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    want = _streams(InferenceEngine(params, cfg, EngineConfig(**ECFG),
                                    device=cuda))
    group = group()
    assert group.ranks.route == "staged"
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**ECFG),
                                 tp=2, group=group)
    before = rpa.launches, group.run(f"{__name__}:_launches")[0]
    got = _streams(eng)
    after = rpa.launches, group.run(f"{__name__}:_launches")[0]
    assert got == want
    mine, theirs = after[0] - before[0], after[1] - before[1]
    assert mine > 0 and mine == theirs
    assert mine % cfg.n_layers == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("M", [1, 32, 1527])
def test_sharded_gemms_bit_equal_to_full(cuda, M, dtype):
    """The port's projection GEMM (``ops/lt_gemm``: the full width's
    cuBLASLt algorithm at every share of its columns) reduces each output
    of a rank's share of a column-sharded projection as the full product
    does, at every tp of ``lt_gemm.TP_WIDTHS``, for a row-major weight
    and for the int8 projections' column-major layout, in bf16 (within
    one bf16 rounding of an f32 product) and in f32 (float32 models: full
    f32, within f32 summation order of an f32 product with TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(M)
    x = (torch.randn(M, 4096, generator=g, device=cuda) * 0.5).to(dtype)
    for name, N in SHARDED.items():
        w = (torch.randn(4096, N, generator=g, device=cuda) * 0.02).to(
            dtype)
        for layout in (w, w.t().contiguous().t()):
            full = lt_gemm.matmul(x, layout)
            for tp in lt_gemm.TP_WIDTHS[1:]:
                n = N // tp
                for r in range(tp):
                    cols = slice(r * n, (r + 1) * n)
                    part = layout[:, cols].clone(
                        memory_format=torch.preserve_format)
                    differ = int((lt_gemm.matmul(x, part, N)
                                  != full[:, cols]).sum())
                    assert differ == 0, (name, M, tp, r, differ)
        assert full.dtype == dtype
        if dtype == torch.bfloat16:
            # One bf16 rounding of an f32 sum, beside an f32 product.
            assert torch.allclose(full.float(), x.float() @ w.float(),
                                  rtol=2 ** -8, atol=1e-3)
        else:  # f32 sums in another order: ~1e-5 at |y| ~ 1
            assert torch.allclose(full, x @ w, rtol=1e-5, atol=1e-4)


class _Rank:
    """A rank's coordinates in a two-rank group (no collective is made)."""

    world = 2

    def __init__(self, rank):
        self.rank = rank


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("rows", [1, 5, 128])
def test_sparse_walk_scores_bit_equal_to_full(cuda, rows, dtype):
    """The sparse walk's block score product (``rpa._block_scores``, the
    one padded product of the sparse leg) under tp = 2 hints gives each
    rank's KV heads the full product's scores bit for bit: llama3-8b's 8
    KV heads x 4 query heads, 32 slots, one block column of 16, at the
    decode leg's one row a slot (where cuBLAS picks another algorithm
    for half the heads), the verify wave's 5 and a prefill chunk's
    128."""
    from seldon_tpu_torch.models.tp_sharding import TpHints

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(rows)
    q = torch.randn(32, rows, 8, 4, 128, generator=g, device=cuda).to(dtype)
    kb = torch.randn(32, 8, 16, 128, generator=g, device=cuda).to(dtype)
    mask = torch.ones(32, rows, 16, dtype=torch.bool, device=cuda)
    full = rpa._block_scores(q, kb, None, mask)
    for r in range(2):
        heads = slice(4 * r, 4 * r + 4)
        half = rpa._block_scores(q[:, :, heads].contiguous(),
                                 kb[:, heads].contiguous(), None, mask,
                                 TpHints(group=_Rank(r), tp=2))
        differ = int((half != full[:, heads]).sum())
        assert differ == 0, (rows, r, differ)


# The products batched over the slots and KV heads of the sparse walk and
# of both verify bodies, at llama3-8b's 8 KV heads x 4 (kv_block 16, a
# prefill chunk of 128 rows, a verify wave of Sq rows, a 2048-position
# window): name -> (equation, the head dims of the operands and the
# result, the operands' shapes at B slots and Sq rows).
DP_PRODUCTS = {
    "walk scores": ("bskgd,bktd->bkgst", (2, 1, 1), lambda B, S: (
        (B, S, 8, 4, 128), (B, 8, 16, 128))),
    "walk values": ("bkgst,bktd->bkgsd", (1, 1, 1), lambda B, S: (
        (B, 8, 4, S, 16), (B, 8, 16, 128))),
    "sparse suffix values": ("bkgst,bktd->bkgsd", (1, 1, 1), lambda B, S: (
        (B, 8, 4, S, S), (B, 8, S, 128))),
    "fresh values": ("bkgsu,bukd->bkgsd", (1, 2, 1), lambda B, S: (
        (B, 8, 4, S, 1), (B, 1, 8, 128))),
    "masked verify scores": ("bskgd,bktd->bkgst", (2, 1, 1), lambda B, S: (
        (B, S, 8, 4, 128), (B, 8, 2048, 128))),
    "masked verify values": ("bkgst,bktd->bskgd", (1, 1, 2), lambda B, S: (
        (B, 8, 4, S, 2048), (B, 8, 2048, 128))),
    "verify diagonal scores": ("bskgd,bskd->bkgs", (2, 2, 1), lambda B, S: (
        (B, S, 8, 4, 128), (B, S, 8, 128))),
    "verify diagonal values": ("bkgs,bskd->bskgd", (1, 2, 2), lambda B, S: (
        (B, 8, 4, S), (B, S, 8, 128))),
    "verify suffix scores": ("bskgd,bukd->bkgsu", (2, 2, 1), lambda B, S: (
        (B, S, 8, 4, 128), (B, S, 8, 128))),
    "verify suffix values": ("bkgsu,bukd->bkgsd", (1, 2, 1), lambda B, S: (
        (B, 8, 4, S, S), (B, S, 8, 128))),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("product", sorted(DP_PRODUCTS))
def test_dp_batch_products_bit_equal_to_whole_batch(cuda, product, dtype):
    """Each product batched over the slots and heads of the sparse walk
    and of both verify bodies, as served (``lt_gemm.whole_einsum``): a
    dp = 2 replica's half of the batch under ``lt_gemm.row_share``, alone
    and on a tp = 2 rank's half of the heads, gives the whole product's
    outputs bit for bit, at 32 slots and at 8, one to five query rows
    (a verify wave's) and a prefill chunk's 128, on bf16-rounded and f32
    operands (unpadded, the H100 reduced many of them in another
    order)."""
    from seldon_tpu_torch.models.tp_sharding import TpHints

    torch.backends.cuda.matmul.allow_tf32 = False
    eq, heads, shapes = DP_PRODUCTS[product]
    g = torch.Generator(device=cuda).manual_seed(5)
    for B in (32, 8):
        for S in (1, 2, 3, 5, 128):
            sa, sb = shapes(B, S)
            if max(int(np.prod(sa)), int(np.prod(sb))) > 1 << 27:
                continue
            a, b = (torch.randn(s, generator=g, device=cuda).to(dtype).float()
                    for s in (sa, sb))
            full = torch.einsum(eq, a, b)
            h = B // 2
            for r in range(2):
                rows = slice(r * h, (r + 1) * h)
                with lt_gemm.row_share(h, B):
                    half = lt_gemm.whole_einsum(eq, a[rows], b[rows])
                    differ = int((half != full[rows]).sum())
                    assert differ == 0, (B, S, r, differ)
                    for t in range(2):
                        quarter = lt_gemm.whole_einsum(
                            eq, a[rows].narrow(heads[0], 4 * t, 4),
                            b[rows].narrow(heads[1], 4 * t, 4),
                            TpHints(group=_Rank(t), tp=2), heads)
                        differ = int((quarter != full[rows].narrow(
                            heads[2], 4 * t, 4)).sum())
                        assert differ == 0, (B, S, r, t, differ)


@pytest.mark.cuda
@pytest.mark.parametrize("S", [1, 128])
def test_dp_rms_norm_bit_equal_to_whole_batch(cuda, S):
    """RMS norm over llama3-8b's 4096 features, as served: a dp = 2
    replica's half of 8 or 32 slots (one decode row, or a chunk of 128)
    under ``lt_gemm.row_share`` gives the whole batch's rows bit for bit
    (unpadded, the mean of 4 rows of 8 was reduced in another order)."""
    g = torch.Generator(device=cuda).manual_seed(S)
    w = (1 + 0.1 * torch.randn(4096, generator=g, device=cuda)).to(
        torch.bfloat16)
    for B in (8, 32):
        for trial in range(40 if S == 1 else 4):
            x = (torch.randn(B, S, 4096, generator=g, device=cuda)
                 * (0.5 + trial % 3)).to(torch.bfloat16)
            full = transformer.rms_norm(x, w, 1e-5)
            h = B // 2
            for r in range(2):
                with lt_gemm.row_share(h, B):
                    half = transformer.rms_norm(x[r * h:(r + 1) * h], w,
                                                1e-5)
                assert torch.equal(half, full[r * h:(r + 1) * h]), (B, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_every_wave_row_count_has_a_pinned_algorithm(cuda, dtype):
    """For every row count a ragged wave of the default engine can give
    (1 to max_slots x prefill_chunk), each of llama3-8b's projection
    widths has a pinned algorithm that runs the whole and every share
    (``lt_gemm.TP_WIDTHS``), in both weight layouts, splitting no K, for
    bf16 and f32 operands (heuristic and check calls only: no
    product)."""
    ec = EngineConfig()
    for M in range(1, ec.max_slots * ec.prefill_chunk + 1):
        for N in sorted(set(SHARDED.values())):
            for column_major in (False, True):
                for tp in lt_gemm.TP_WIDTHS:
                    algo = lt_gemm.algorithm(M, 4096, N // tp, N,
                                             column_major=column_major,
                                             dtype=dtype)
                    assert algo["splitk"] <= 1 and not algo["reduction"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_replicated_products_have_a_pinned_algorithm(cuda, dtype):
    """For every row count of the default engine's ragged wave, llama3-8b's
    replicated projections (wo, w_down) have a pinned algorithm in both
    weight layouts, and the head's f32 logits product (lm_head, or the
    tied embedding's transpose) one, splitting no K; and every dp share
    (2, 4) of such a row count runs the whole batch's algorithm
    (heuristic and check calls only)."""
    ec = EngineConfig()
    shapes = [(4096, 4096), (14336, 4096)]
    if dtype == torch.float32:
        shapes.append((4096, 128256))
    for M in range(1, ec.max_slots * ec.prefill_chunk + 1):
        for K, N in shapes:
            for column_major in (False, True):
                algo = lt_gemm.algorithm(M, K, N, column_major=column_major,
                                         tps=(1,), dtype=dtype)
                assert algo["splitk"] <= 1 and not algo["reduction"]
                for dp in (2, 4):
                    if M % dp == 0:
                        lt_gemm.algorithm(M // dp, K, N, tps=(1,),
                                          column_major=column_major,
                                          dtype=dtype, m_full=M)


@pytest.mark.cuda
@pytest.mark.parametrize("leg", ["decode", "prefill"])
def test_dp_row_share_bit_equal_to_whole_batch(cuda, leg):
    """A dp = 2 replica's half of the ragged wave's rows under
    ``lt_gemm.row_share``: each projection (a tp = 2 share of the
    column-sharded ones, wo, w_down) and the f32 head product give the
    whole batch's rows bit for bit, and the fresh scores and their
    combine (the products batched over the slots) the whole batch's
    slots; llama3-8b's widths, 32 slots, one row a slot or a chunk of
    128."""
    from seldon_tpu_torch.models import ragged_attention as ra_mod

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(3)

    def rn(*shape, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=g, device=cuda) * 0.05).to(dtype)

    Sq = 1 if leg == "decode" else 128
    M, h = 32 * Sq, 16 * Sq
    for K, N, n_full, tps in ((4096, 2048, 4096, lt_gemm.TP_WIDTHS),
                              (4096, 7168, 14336, lt_gemm.TP_WIDTHS),
                              (4096, 4096, 4096, (1,)),
                              (14336, 4096, 4096, (1,))):
        x, w = rn(M, K), rn(K, N)
        full = lt_gemm.matmul(x, w, n_full, tps)
        with lt_gemm.row_share(16, 32):
            half = lt_gemm.matmul(x[:h], w, n_full, tps)
        assert torch.equal(full[:h], half), (K, N)
    x, w = rn(32, 4096, dtype=torch.float32), rn(4096, 128256,
                                                  dtype=torch.float32)
    full = lt_gemm.matmul(x, w, 128256, (1,))
    with lt_gemm.row_share(16, 32):
        assert torch.equal(full[:16], lt_gemm.matmul(x[:16], w, 128256,
                                                     (1,)))
    eq = "bskgd,bukd->bkgsu" if leg == "decode" else "bskgd,btkd->bkgst"
    qr = rn(32, Sq, 8, 4, 128, dtype=torch.float32)
    k = rn(32, Sq, 8, 128, dtype=torch.float32)
    s_full = ra_mod._fresh_scores(eq, qr, k)
    with lt_gemm.row_share(16, 32):
        assert torch.equal(s_full[:16], ra_mod._fresh_scores(
            eq, qr[:16], k[:16]))
    parts = (rn(32, 8, 4, Sq, 1, dtype=torch.float32),
             rn(32, 8, 4, Sq, 1, dtype=torch.float32).abs() + 1,
             rn(32, 8, 4, Sq, 128, dtype=torch.float32))
    v = rn(32, 8, Sq, 128, dtype=torch.float32)
    out = ra_mod._combine_fresh(parts, s_full, v)
    with lt_gemm.row_share(16, 32):
        assert torch.equal(out[:16], ra_mod._combine_fresh(
            tuple(t[:16] for t in parts), s_full[:16], v[:16]))


@pytest.mark.cuda
def test_projections_take_the_pinned_gemm(cuda):
    """On the card, outside autograd, the seven projections of every
    layer and the head's logits product run ``lt_gemm.matmul``; under
    autograd (the training route) none does."""
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.arange(3, 19, device=cuda)[None]
    lt_gemm.launches = 0
    transformer.forward(params, toks, cfg)
    assert lt_gemm.launches == 7 * cfg.n_layers + 1
    lt_gemm.launches = 0
    transformer.forward_train(params, toks, cfg)
    assert lt_gemm.launches == 0


@pytest.mark.cuda
def test_dense_prefix_tp2_on_one_card_equals_tp1(cuda, group):
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    ref = InferenceEngine(params, cfg, EngineConfig(**DENSE_PREFIX),
                          device=cuda)
    want = _streams(ref, PREFIX_PROMPTS)
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**DENSE_PREFIX),
                                 tp=2, group=group())
    assert _streams(eng, PREFIX_PROMPTS) == want
    keys = ("prefix_hits", "prefix_tokens_saved", "prefix_evictions")
    one, two = ref.stats.snapshot(), eng.stats.snapshot()
    assert one["prefix_hits"] > 0
    assert {k: two[k] for k in keys} == {k: one[k] for k in keys}


def _reduction(worker, allow):
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = allow


@pytest.mark.cuda
def test_worker_with_other_gemm_settings_raises(cuda, group):
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    group = group()
    assert group.gemms == [tdevice.configure_gemms()]
    mine = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    group.run(f"{__name__}:_reduction", not mine)
    try:
        with pytest.raises(RuntimeError, match="rank 1 runs GEMMs"):
            mesh_engine.MeshEngine(params, cfg, EngineConfig(**ECFG), tp=2,
                                   group=group)
    finally:
        group.run(f"{__name__}:_reduction", mine)


def _tapped_streams(eng, group, rows):
    """Streams of ``eng`` with rank 0's logits kept in ``rows`` and each
    rank's B1 launches counted: (streams, [launches per rank])."""
    real = transformer._logits

    def tap(*a, **k):
        out = real(*a, **k)
        rows.append(out.detach().float().cpu())
        return out

    transformer._logits = tap
    try:
        before = [rpa.launches] + group.run(f"{__name__}:_launches")
        got = _streams(eng)
        after = [rpa.launches] + group.run(f"{__name__}:_launches")
    finally:
        transformer._logits = real
    return got, [a - b for a, b in zip(after, before)]


@pytest.mark.cuda
def test_auto_plan_of_four_ranks_equals_tp1(cuda, groups, monkeypatch):
    """The server's plan on four devices: tp = 4 for 4 KV heads; every
    wave's logits bit-equal to tp = 1's and B1 launched on every rank,
    layers x wave legs."""
    cfg = dataclasses.replace(get_config("tiny"), n_kv_heads=4)
    monkeypatch.setattr(torchserver, "serving_devices",
                        lambda device: [torch.device(d) for d in FOUR])
    mesh = torchserver.TorchServer(preset="tiny")._serving_mesh(cfg)
    assert mesh.shape["tp"] == 4 and mesh.devices.size == 4
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    want_rows, got_rows = [], []
    ref = InferenceEngine(params, cfg, EngineConfig(**ECFG), device=cuda)
    real = transformer._logits

    def tap(*a, **k):
        out = real(*a, **k)
        want_rows.append(out.detach().float().cpu())
        return out

    transformer._logits = tap
    try:
        want = _streams(ref)
    finally:
        transformer._logits = real
    group = groups(mesh)
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**ECFG),
                                 group=group)
    got, launches = _tapped_streams(eng, group, got_rows)
    st = eng.stats.snapshot()
    assert got == want
    assert len(got_rows) == len(want_rows)
    for a, b in zip(want_rows, got_rows):
        assert torch.equal(a, b)
    legs = st["decode_dispatches"] + st["prefill_waves"]
    assert launches == [cfg.n_layers * legs] * 4


@pytest.mark.cuda
def test_dp2_tp2_on_one_card_equals_tp1(cuda, groups, monkeypatch):
    """dp2 x tp2: tp = 1's streams, every worker's slots equal to rank
    0's, and each replica's ranks launching B1 for that replica's wave
    legs only."""
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    want = _streams(InferenceEngine(params, cfg, EngineConfig(**ECFG),
                                    device=cuda))
    group = groups(make_mesh(MeshPlan(dp=2, tp=2), FOUR))
    legs = [0, 0]
    real = dp_replicas.cut

    def counted(name, args, kw, lo, hi, active):
        c = real(name, args, kw, lo, hi, active)
        if c is not None and name == "ragged_wave":
            legs[lo // (ECFG["max_slots"] // 2)] += 1 + int(
                bool(c.kw.get("has_prefill")))
        return c

    monkeypatch.setattr(dp_replicas, "cut", counted)
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**ECFG),
                                 group=group)
    got, launches = _tapped_streams(eng, group, [])
    assert got == want
    assert launches == [cfg.n_layers * legs[0]] * 2 + [
        cfg.n_layers * legs[1]] * 2
    assert sum(legs) > 0


@pytest.mark.cuda
def test_dp2_tp2_dense_on_one_card_equals_tp1(cuda, groups):
    """dp2 x tp2 on the dense engine (its decode chunks and admissions
    cut by slot, each replica on its own rows of the slab): tp = 1's
    streams, and every worker's slots equal to rank 0's."""
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    dense = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
                 async_fetch=False)
    want = _streams(InferenceEngine(params, cfg, EngineConfig(**dense),
                                    device=cuda))
    group = groups(make_mesh(MeshPlan(dp=2, tp=2), FOUR))
    eng = mesh_engine.MeshEngine(params, cfg, EngineConfig(**dense),
                                 group=group)
    assert _streams(eng) == want


PREFIX_HEAD = list(range(40, 72))
PREFIX_PHASES = ([PREFIX_HEAD + list(range(90, 95))],
                 [PREFIX_HEAD + list(range(100 + 16 * i, 100 + 16 * i + n))
                  for i, n in enumerate((13, 4, 11, 7))])
DP_PREFIX = {
    "paged": dict(ECFG, prompt_buckets=(8, 32, 64), prefix_cache=True),
    "dense": dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32, 64),
                  prefix_cache=True, prefix_block=8, async_fetch=False),
}
PREFIX_STATS = ("prefix_hits", "prefix_tokens_saved", "zero_copy_admissions",
                "cow_copies", "prefix_evictions", "prefix_seed_copies")


def _phased_streams(eng):
    """Greedy streams of PREFIX_PHASES on ``eng``, each phase queued at
    once (the primer runs on slot 3, replica 1; the burst's last requests
    on replica 0), and the trie's counters."""
    eng.start()
    try:
        out = []
        for phase in PREFIX_PHASES:
            with eng._book:
                qs = [eng.submit(p, SamplingParams(temperature=0.0,
                                                   max_new_tokens=8))
                      for p in phase]
            for q in qs:
                toks = []
                while (item := q.get(timeout=300)) is not None:
                    assert "error" not in item, item
                    toks.extend(item["tokens"])
                out.append(toks)
        if isinstance(eng, mesh_engine.MeshEngine):
            eng.check_replicas()
    finally:
        eng.stop()
    st = eng.stats.snapshot()
    return out, {k: st[k] for k in PREFIX_STATS}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", sorted(DP_PREFIX))
def test_dp2_tp2_prefix_on_one_card_equals_tp1(cuda, groups, mode):
    """dp2 x tp2 with the prefix cache on (paged: the ragged kernel leg;
    dense: the one-shot warm admission): a hit on replica 0 reads the
    KV replica 1 computed, moved to it (paged: the head's pool blocks;
    dense: every trie span, broadcast at its insertion); tp = 1's streams
    and trie counters, every worker's slots (and prefix store) equal to
    rank 0's."""
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    ecfg = EngineConfig(**DP_PREFIX[mode])
    want = _phased_streams(InferenceEngine(params, cfg, ecfg, device=cuda))
    group = groups(make_mesh(MeshPlan(dp=2, tp=2), FOUR))
    group.transfers(reset=True)
    got = _phased_streams(mesh_engine.MeshEngine(params, cfg, ecfg,
                                                 group=group))
    moved = group.transfers()
    assert got == want
    assert want[1]["prefix_hits"] == 4
    assert moved[0].bytes_in > 0 and moved[1].bytes_in > 0, moved


# The least top-2 logit gap of the admission prompt of
# test_sp2_tp2_ring_on_one_card: wider than two logits can move apart
# within the ring's 2e-2 tolerance (tiny's logits stay under 1), so the
# ring's rounding cannot flip the first token.
RING_GAP_MIN = 0.1


def _admission(eng, prompt):
    """(first token of ``eng``'s greedy stream for ``prompt``, rank 0's
    logits of its admission)."""
    rows = []
    real = transformer._logits

    def tap(*a, **k):
        out = real(*a, **k)
        rows.append(out.detach().float().cpu())
        return out

    transformer._logits = tap
    try:
        got = _streams(eng, [prompt])[0]
    finally:
        transformer._logits = real
    return got[0], rows[0]


@pytest.mark.cuda
def test_sp2_tp2_ring_on_one_card(cuda, groups):
    """sp2 x tp2 with the ring: the ring score within 2e-2 of one device's
    "xla" score; a context-parallel admission's logits within 2e-2 of one
    device's admission's and its first token one device's. The prompt is
    the one of 64 seeded prompts whose top-2 logit gap on one device is
    the widest, and that gap is at least RING_GAP_MIN (the choice reads
    one device's logits only)."""
    cfg = get_config("tiny")
    ring = dataclasses.replace(cfg, attn_impl="ring")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 64),
                         generator=torch.Generator(device=cuda).manual_seed(1),
                         device=cuda)
    want = transformer.forward(params, toks, cfg)
    dense = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
                 async_fetch=False)
    gaps = {}
    for seed in range(64):
        p = np.random.default_rng(seed).integers(3, cfg.vocab_size,
                                                 20).tolist()
        top2 = transformer.forward(params, torch.tensor([p], device=cuda),
                                   cfg)[0, -1].topk(2).values
        gaps[float(top2[0] - top2[1])] = p
    gap = max(gaps)
    prompt = gaps[gap]
    print(f"sp2 x tp2 admission prompt: top-2 logit gap {gap:.4f}")
    assert gap >= RING_GAP_MIN
    assert float(want.abs().max()) < 1.0
    one, one_logits = _admission(
        InferenceEngine(params, cfg, EngineConfig(**dense), device=cuda),
        prompt)
    group = groups(make_mesh(MeshPlan(sp=2, tp=2), FOUR))
    eng = mesh_engine.MeshEngine(params, ring, EngineConfig(**dense),
                                 group=group)
    got = group.score(toks.cpu().numpy(), lambda: transformer.forward(
        eng.params, toks, ring, ring=group.sp_ranks, tp=group.hints(2)))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-2, atol=2e-2)
    first, logits = _admission(eng, prompt)
    print(f"sp2 x tp2 admission: max |dlogit| against one device "
          f"{float((logits - one_logits).abs().max()):.4g}")
    np.testing.assert_allclose(logits.numpy(), one_logits.numpy(),
                               rtol=2e-2, atol=2e-2)
    assert first == one
