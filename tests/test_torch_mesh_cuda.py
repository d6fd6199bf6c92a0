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
count, gives each rank's heads the full product's scores bit for bit."""

import pytest
import torch

from seldon_tpu_torch import device as tdevice
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.models.sampling import SamplingParams
from seldon_tpu_torch.ops import lt_gemm
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from seldon_tpu_torch.servers import mesh_engine
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
def group():
    """Two ranks sharing the card (gloo staged through host buffers),
    for the file's tp=2 cases; built on first use."""
    made = []

    def get():
        if not made:
            made.append(mesh_engine.spawn_group(
                mesh_engine.build_tp_mesh(2, ["cuda:0", "cuda:0"])))
        return made[0]

    yield get
    for g in made:
        g.close()


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
def test_projections_take_the_pinned_gemm(cuda):
    """On the card, outside autograd, the five column-sharded
    projections of every layer run ``lt_gemm.matmul``; under autograd
    (the training route) none does."""
    cfg = get_config("tiny")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    toks = torch.arange(3, 19, device=cuda)[None]
    lt_gemm.launches = 0
    transformer.forward(params, toks, cfg)
    assert lt_gemm.launches == 5 * cfg.n_layers
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
