"""The hand-written CUDA kernels against their plain versions, on the
card: ragged paged attention (B1) and flash attention (B2). Marked
`cuda`; skipped where there is no card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (the repo's conftest imports jax;
skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances — B1: 1e-4 absolute on m and on acc/l, 1e-4 relative on l,
f32 sums taken in another order than the plain version's (both of its
routes keep p in f32: the tensor-core route as a bf16 hi + lo pair); B1's
f32 route (float32 models: f32 queries against an f32 or int8 pool; f32
FMA on the CUDA cores below 64 rows, 3xTF32 on the tensor cores from 64
up) 1e-5 on acc/l and relative on l, m within 1e-5 relative to
max(|m|, 1), with TF32 off in the plain version. B2: both of its kernels
(bf16 on the tensor cores, f32 on them as 3xTF32) keep the plain
version's rounding points, so f32 outputs agree to 1e-4 absolute,
and each bf16 output lies within one bf16 ulp of the plain one
(|d| <= 2**-7 |plain| + 1e-5).

Also on the card, integer work that must match the CPU bit for bit: the
W8A8 projections' s8 x s8 -> s32 products (``torch._int_mm``, cuBLASLt)
against an int64 numpy product at llama3-8b widths, the int8 weight
codes and scales of ``quantize._quantize_leaf`` (and of the activation
and KV quantizers), and the threefry bits
of the engine's sampling noise (``models/prng.py``) against the CPU's;
the Gumbel noise itself within two f32 ulps at its scale (two logs, each
rounded by another library). And the kernels at the bucketed engines'
call sites: B1 at the verify wave's shapes, B2 at the cold admission's,
and both launched (never their plain versions) by the engines on tiny."""

import dataclasses

import numpy as np
import pytest
import torch

from seldon_tpu_torch.models import prng, quantize, transformer
from seldon_tpu_torch.models.config import get_config
from seldon_tpu_torch.ops import flash_attention as fa
from seldon_tpu_torch.ops import ragged_paged_attention as rpa

TOL = 1e-4
BF16_ULP = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernel_cuda.py")
    return torch.device("cuda")


def _inputs(dev, B, Sq, Hkv, G, Dh, block, nbs, kv_dtype, seed,
            bounds=None):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    nb = B * nbs + 1
    raw_k = torch.randn(nb, Hkv, block, Dh, generator=gen)
    raw_v = torch.randn(nb, Hkv, block, Dh, generator=gen)
    if kv_dtype == "int8":
        kq, ks = transformer._quantize_kv(raw_k.bfloat16())
        vq, vs = transformer._quantize_kv(raw_v.bfloat16())
        layer = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        layer = {"k": raw_k.bfloat16(), "v": raw_v.bfloat16()}
    if bounds is None:
        bounds = torch.randint(0, nbs * block + 1, (B,), generator=gen)
        bounds[0] = 0
        bounds[-1] = nbs * block
    else:
        bounds = torch.tensor(bounds)
    table = torch.zeros(B, nbs, dtype=torch.int32)
    for b in range(B):
        live = -(-int(bounds[b]) // block)
        table[b, :live] = 1 + b * nbs + torch.arange(live)
    bound = bounds[:, None].expand(B, Sq).contiguous().int()
    q = torch.randn(B, Sq, Hkv, G, Dh, generator=gen).bfloat16()
    move = lambda t: t.to(dev)  # noqa: E731
    return (move(q), {k: move(v) for k, v in layer.items()}, move(table),
            move(bound))


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", [
    dict(B=5, Sq=1, Hkv=2, G=2, Dh=16, block=8, nbs=6),
    dict(B=4, Sq=1, Hkv=8, G=4, Dh=128, block=16, nbs=20),
    dict(B=3, Sq=24, Hkv=2, G=4, Dh=64, block=16, nbs=9),
    dict(B=2, Sq=128, Hkv=8, G=4, Dh=128, block=16, nbs=8),
    # A block that does not divide the kernel's 64-position step.
    dict(B=3, Sq=2, Hkv=2, G=2, Dh=64, block=48, nbs=3),
    # The decode route (R = G * Sq < 64) cut into many splits (128
    # positions each, rpa.decode_split): a full table beside short slots,
    # a bound-0 slot, and bounds on and around a split boundary.
    dict(B=6, Sq=1, Hkv=8, G=4, Dh=128, block=16, nbs=128,
         bounds=(0, 2048, 17, 256, 255, 257)),
    dict(B=4, Sq=1, Hkv=2, G=2, Dh=64, block=8, nbs=80,
         bounds=(0, 640, 256, 1)),
    dict(B=4, Sq=1, Hkv=2, G=8, Dh=16, block=48, nbs=20,
         bounds=(0, 960, 256, 240)),
    # Both sides of the route boundary (R = 63 decode, two row tiles; R =
    # 64, 65 on the tensor cores) and R = 512 on the tensor cores, Dh 16,
    # 64 and 128 on both routes.
    dict(B=3, Sq=63, Hkv=2, G=1, Dh=64, block=16, nbs=40),
    dict(B=3, Sq=16, Hkv=2, G=4, Dh=16, block=8, nbs=40),
    dict(B=3, Sq=65, Hkv=2, G=1, Dh=128, block=48, nbs=12),
    dict(B=3, Sq=32, Hkv=2, G=2, Dh=64, block=16, nbs=20),
    dict(B=2, Sq=128, Hkv=2, G=4, Dh=64, block=8, nbs=70),
    dict(B=2, Sq=128, Hkv=2, G=4, Dh=16, block=48, nbs=9),
    # A prefill wave whose rows are all dead.
    dict(B=3, Sq=64, Hkv=2, G=2, Dh=128, block=16, nbs=8,
         bounds=(0, 0, 0)),
])
def test_kernel_matches_plain(cuda, kv_dtype, shape):
    q, layer, table, bound = _inputs(cuda, kv_dtype=kv_dtype, seed=0,
                                     **shape)
    dead = (bound[:, 0] == 0).cpu()
    before = rpa.launches
    got = rpa.partials_kernel(q, layer, table, bound)
    torch.cuda.synchronize()
    assert rpa.launches == before + 1
    want = rpa.partials_sparse(q, layer, table, bound)
    gm, gl, ga = (t.cpu() for t in got)
    wm, wl, wa = (t.cpu() for t in want)
    assert torch.isfinite(gm).all() and torch.isfinite(ga).all()
    assert dead.any()  # every case has a bound = 0 slot: (NEG_INF, 0, 0)
    assert torch.all(gm[dead] == rpa.NEG_INF) and torch.all(gl[dead] == 0)
    assert torch.all(ga[dead] == 0)
    np.testing.assert_allclose(gm.numpy(), wm.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(gl.numpy(), wl.numpy(), rtol=TOL, atol=0)
    np.testing.assert_allclose(
        (ga / gl.clamp(min=1e-30)).numpy(),
        (wa / wl.clamp(min=1e-30)).numpy(), rtol=0, atol=TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_kernel_at_the_verify_wave_shapes(cuda, kv_dtype, k):
    """The speculative verify wave's call: 32 slots x (k + 1) query rows
    of llama3-8b's grouping (R = 8, 12, 20, the split-KV decode route),
    2048-position tables, every column of a row bounded at its pre-wave
    position, and rows outside the wave at bound 0 (their partials must
    be exactly (NEG_INF, 0, 0), which the wave's combine relies on)."""
    bounds = [0] * 12 + [int(b) for b in np.random.default_rng(k).integers(
        1, 2048, 18)] + [2047, 16]
    q, layer, table, bound = _inputs(cuda, B=32, Sq=k + 1, Hkv=8, G=4,
                                     Dh=128, block=16, nbs=128,
                                     kv_dtype=kv_dtype, seed=k,
                                     bounds=bounds)
    dead = (bound[:, 0] == 0).cpu()
    before = rpa.launches
    got = rpa.ragged_paged_partials(q, layer, table, bound, mode="pallas")
    torch.cuda.synchronize()
    assert rpa.launches == before + 1
    want = rpa.partials_sparse(q, layer, table, bound)
    gm, gl, ga = (t.cpu() for t in got)
    wm, wl, wa = (t.cpu() for t in want)
    assert torch.all(gm[dead] == rpa.NEG_INF) and torch.all(gl[dead] == 0)
    assert torch.all(ga[dead] == 0)
    np.testing.assert_allclose(gm.numpy(), wm.numpy(), rtol=0, atol=TOL)
    np.testing.assert_allclose(gl.numpy(), wl.numpy(), rtol=TOL, atol=0)
    np.testing.assert_allclose(
        (ga / gl.clamp(min=1e-30)).numpy(),
        (wa / wl.clamp(min=1e-30)).numpy(), rtol=0, atol=TOL)


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda):
    q, layer, table, bound = _inputs(cuda, B=2, Sq=1, Hkv=2, G=2, Dh=16,
                                     block=8, nbs=4, kv_dtype="bf16", seed=1)
    strided = q.transpose(2, 3).contiguous().transpose(2, 3)  # Hkv == G
    with pytest.raises(ValueError, match="contiguous"):
        rpa.partials_kernel(strided, layer, table, bound)
    with pytest.raises(TypeError, match="dtype"):
        rpa.partials_kernel(q.float(), layer, table, bound)
    with pytest.raises(ValueError, match="is on"):
        rpa.partials_kernel(q, layer, table.cpu(), bound)


# ---------------------------------------------------------------------------
# B1's f32 route (float32 models)
# ---------------------------------------------------------------------------

# The f32 route against its plain version, both in f32 with TF32 off: the
# normalised output within 1e-5 and l within 1e-5 relative; m (the max of
# dots of Dh f32 products, summed by the kernel as one FMA chain and by
# the plain version's GEMM in another order) within 1e-5 relative to
# max(|m|, 1): a few ulps of |m| differ (chip_smoke phase 3, PERF.md).
F32_TOL = 1e-5


@pytest.fixture
def f32_cuda(cuda):
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield cuda
    torch.backends.cuda.matmul.allow_tf32 = before


def _f32_inputs(dev, kv_dtype, **shape):
    """``_inputs`` for an f32 model: f32 queries, and an f32 pool or the
    int8 pool with bf16 scales."""
    q, layer, table, bound = _inputs(dev, kv_dtype=kv_dtype, **shape)
    if kv_dtype != "int8":
        layer = {k: v.float() for k, v in layer.items()}
    return q.float(), layer, table, bound


def _assert_f32_partials(got, want, dead):
    """``dead``: the slots [B] or the rows [B, Sq] whose bound is 0."""
    gm, gl, ga = (t.cpu() for t in got)
    wm, wl, wa = (t.cpu() for t in want)
    assert all(t.dtype == torch.float32 for t in got)
    assert torch.isfinite(gm).all() and torch.isfinite(ga).all()
    if dead.dim() == 2:
        dead = dead[:, None, None, :, None]
        assert torch.all(gm[dead.expand_as(gm)] == rpa.NEG_INF)
        assert torch.all(gl[dead.expand_as(gl)] == 0)
        assert torch.all(ga[dead.expand_as(ga)] == 0)
    else:
        assert torch.all(gm[dead] == rpa.NEG_INF)
        assert torch.all(gl[dead] == 0)
        assert torch.all(ga[dead] == 0)
    np.testing.assert_array_less(
        (gm - wm).abs().numpy(),
        F32_TOL * torch.clamp(wm.abs(), min=1.0).numpy() + 1e-30)
    np.testing.assert_allclose(gl.numpy(), wl.numpy(), rtol=F32_TOL, atol=0)
    np.testing.assert_allclose(
        (ga / gl.clamp(min=1e-30)).numpy(),
        (wa / wl.clamp(min=1e-30)).numpy(), rtol=0, atol=F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("shape", [
    dict(B=5, Sq=1, Hkv=2, G=2, Dh=16, block=8, nbs=6),
    # llama3-8b's decode: 128-position splits of a 2048-position table.
    dict(B=6, Sq=1, Hkv=8, G=4, Dh=128, block=16, nbs=128,
         bounds=(0, 2048, 17, 256, 255, 257)),
    dict(B=4, Sq=1, Hkv=2, G=8, Dh=16, block=48, nbs=20,
         bounds=(0, 960, 256, 240)),
    # Both sides of the split boundary (R = 63 split, R = 64 one split
    # per row tile) and a prefill wave (R = 512), Dh 16, 64 and 128.
    dict(B=3, Sq=63, Hkv=2, G=1, Dh=64, block=16, nbs=40),
    dict(B=3, Sq=65, Hkv=2, G=1, Dh=128, block=48, nbs=12),
    dict(B=2, Sq=128, Hkv=8, G=4, Dh=128, block=16, nbs=8),
    dict(B=2, Sq=128, Hkv=2, G=4, Dh=16, block=48, nbs=9),
    dict(B=3, Sq=64, Hkv=2, G=2, Dh=128, block=16, nbs=8,
         bounds=(0, 0, 0)),
])
def test_f32_kernel_matches_plain(f32_cuda, kv_dtype, shape):
    q, layer, table, bound = _f32_inputs(f32_cuda, kv_dtype, seed=0,
                                         **shape)
    dead = (bound[:, 0] == 0).cpu()
    before = rpa.launches, rpa.entry_launches[torch.float32]
    got = rpa.partials_kernel(q, layer, table, bound)
    torch.cuda.synchronize()
    assert (rpa.launches, rpa.entry_launches[torch.float32]) == (
        before[0] + 1, before[1] + 1)
    assert dead.any()
    _assert_f32_partials(got, rpa.partials_sparse(q, layer, table, bound),
                         dead)


def _full_mantissa(dev, q, layer, seed, spread=0.0):
    """q, and an f32 pool, redrawn with all 23 mantissa bits live (so the
    tensor-core route's lo terms matter), magnitudes spread over
    2**+-spread; an int8 pool is kept (its codes are exact in TF32)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def draw(t):
        x = torch.randn(tuple(t.shape), generator=gen)
        if spread:
            x = x * torch.exp2(torch.empty(tuple(t.shape)).uniform_(
                -spread, spread, generator=gen))
        return x.to(dev)

    if "k_scale" not in layer:
        layer = {k: draw(v) for k, v in layer.items()}
    return draw(q), layer


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("shape", [
    # R = 64 exactly, a block that does not divide the 32-position step.
    dict(B=3, Sq=64, Hkv=2, G=1, Dh=64, block=24, nbs=20,
         bounds=(0, 480, 100)),
    # R = 65: the second warpgroup holds one row.
    dict(B=2, Sq=65, Hkv=1, G=1, Dh=16, block=48, nbs=7, bounds=(336, 0)),
    # R = 512 with all-dead tiles (slots 0 and 2) beside a 31-position
    # walk, Dh 128.
    dict(B=4, Sq=128, Hkv=2, G=4, Dh=128, block=16, nbs=16,
         bounds=(0, 256, 0, 31)),
    # R = 192: a second tile with 64 rows, its second warpgroup past R.
    dict(B=2, Sq=96, Hkv=1, G=2, Dh=64, block=16, nbs=10),
    # One live row in a tile (s = 70 of 128: the first warpgroup all dead).
    dict(B=2, Sq=128, Hkv=2, G=1, Dh=128, block=64, nbs=5, one_live=70),
    dict(B=2, Sq=128, Hkv=1, G=1, Dh=16, block=8, nbs=9, one_live=3),
])
def test_f32_tensor_core_route_matches_plain(f32_cuda, kv_dtype, shape):
    """B1's route from 64 rows up (3xTF32 wgmma) on full-mantissa f32
    inputs, at its tile and step edges."""
    shape = dict(shape)
    one_live = shape.pop("one_live", None)
    q, layer, table, bound = _f32_inputs(f32_cuda, kv_dtype, seed=3,
                                         **shape)
    q, layer = _full_mantissa(f32_cuda, q, layer, seed=4)
    if one_live is not None:
        keep = torch.zeros_like(bound)
        keep[:, one_live] = 1
        bound = (bound * keep).contiguous()
    assert q.shape[1] * q.shape[3] >= rpa.PREFILL_ROWS
    dead = (bound == 0).cpu()
    before = rpa.entry_launches[torch.float32]
    got = rpa.partials_kernel(q, layer, table, bound)
    torch.cuda.synchronize()
    assert rpa.entry_launches[torch.float32] == before + 1
    assert dead.any() and not dead.all()
    _assert_f32_partials(got, rpa.partials_sparse(q, layer, table, bound),
                         dead)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["b1", "b2"])
def test_f32_tensor_cores_keep_the_lo_terms(f32_cuda, kernel):
    """Inputs that single-pass TF32 gets wrong: all 23 mantissa bits live
    and magnitudes spread over 2**+-1. The plain version run on operands
    rounded to TF32 (what one pass computes) misses the route's tolerance
    by far; the 3xTF32 kernel meets it, so its lo terms are used."""
    from seldon_tpu_torch.ops._tf32 import tf32_round

    if kernel == "b1":
        q, layer, table, bound = _f32_inputs(
            f32_cuda, "f32", seed=5, B=3, Sq=128, Hkv=2, G=4, Dh=128,
            block=16, nbs=16, bounds=(256, 0, 200))
        q, layer = _full_mantissa(f32_cuda, q, layer, seed=6, spread=1.0)
        dead = (bound[:, 0] == 0).cpu()
        want = rpa.partials_sparse(q, layer, table, bound)
        one = rpa.partials_sparse(
            tf32_round(q), {k: tf32_round(v) for k, v in layer.items()},
            table, bound)
        with pytest.raises(AssertionError):
            _assert_f32_partials(one, want, dead)
        got = rpa.partials_kernel(q, layer, table, bound)
        torch.cuda.synchronize()
        _assert_f32_partials(got, want, dead)
    else:
        gen = torch.Generator(device="cpu").manual_seed(7)

        def draw(*shape):
            x = torch.randn(shape, generator=gen) * torch.exp2(
                torch.empty(shape).uniform_(-1.0, 1.0, generator=gen))
            return x.to(f32_cuda)

        q, k, v = draw(16, 512, 128), draw(4, 512, 128), draw(4, 512, 128)
        want = fa.flash_blockwise(q, k, v, True, 0, q_per_kv=4)
        one = fa.flash_blockwise(tf32_round(q), tf32_round(k),
                                 tf32_round(v), True, 0, q_per_kv=4)
        assert (one - want).abs().max().item() > 10 * TOL
        got = fa.flash_kernel(q, k, v, True, 0, q_per_kv=4)
        torch.cuda.synchronize()
        _assert_flash_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("k", [1, 4])
def test_f32_kernel_at_the_verify_wave_shapes(f32_cuda, kv_dtype, k):
    """The verify wave of an f32 llama3-8b: 32 slots x (k + 1) rows, rows
    outside the wave at bound 0."""
    bounds = [0] * 12 + [int(b) for b in np.random.default_rng(k).integers(
        1, 2048, 18)] + [2047, 16]
    q, layer, table, bound = _f32_inputs(
        f32_cuda, kv_dtype, B=32, Sq=k + 1, Hkv=8, G=4, Dh=128, block=16,
        nbs=128, seed=k, bounds=bounds)
    got = rpa.ragged_paged_partials(q, layer, table, bound, mode="pallas")
    torch.cuda.synchronize()
    _assert_f32_partials(got, rpa.partials_sparse(q, layer, table, bound),
                         (bound[:, 0] == 0).cpu())


@pytest.mark.cuda
def test_f32_kernel_rejects_what_it_cannot_take(f32_cuda):
    q, layer, table, bound = _f32_inputs(f32_cuda, "f32", B=2, Sq=1, Hkv=2,
                                         G=2, Dh=16, block=8, nbs=4, seed=1)
    with pytest.raises(TypeError, match="dtype"):  # f32 q, bf16 pool
        rpa.partials_kernel(q, {k: v.bfloat16() for k, v in layer.items()},
                            table, bound)
    with pytest.raises(TypeError, match="dtype"):  # no float16 route
        rpa.partials_kernel(q.half(), {k: v.half() for k, v in
                                       layer.items()}, table, bound)
    with pytest.raises(ValueError, match="block"):
        rpa.partials_kernel(q, {k: v.repeat(1, 1, 9, 1)
                                for k, v in layer.items()}, table, bound)


@pytest.mark.cuda
def test_f32_engine_runs_the_f32_route_and_refuses_tf32(f32_cuda):
    """A float32 tiny model on the ragged kernel leg: every wave leg
    launches B1's f32 route (never the bf16 one) once per layer, and the
    greedy streams equal the same engine's on the CPU (the plain version,
    f32 sums in another order: tiny's top-2 gaps are far above 1e-4 on
    these prompts). With TF32 matmuls on, the engine refuses the model."""
    from seldon_tpu_torch.models.sampling import SamplingParams
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

    cfg = dataclasses.replace(get_config("tiny"), dtype="float32")
    ecfg = dict(max_slots=4, max_seq_len=64, prompt_buckets=(8, 32),
                paged_kv=True, chunked_prefill=True, prefill_chunk=8,
                prefix_block=8, kv_block=8, ragged=True,
                ragged_kernel="pallas", async_fetch=False)

    def streams(dev):
        params = transformer.init_params(
            cfg, torch.Generator().manual_seed(0), "cpu").to(dev)
        eng = InferenceEngine(params, cfg, EngineConfig(**ecfg), device=dev)
        qs = [eng.submit(list(range(2, 2 + n)), SamplingParams(
            temperature=0.0, max_new_tokens=8)) for n in (5, 12, 24, 7)]
        eng.start()
        try:
            out = []
            for q in qs:
                toks = []
                while (item := q.get(timeout=300)) is not None:
                    assert "error" not in item, item
                    toks.extend(item["tokens"])
                out.append(toks)
            return out, eng.stats.snapshot()
        finally:
            eng.stop()

    before = dict(rpa.entry_launches)
    got, snap = streams(f32_cuda)
    f32_launches = rpa.entry_launches[torch.float32] - before[torch.float32]
    assert rpa.entry_launches[torch.bfloat16] == before[torch.bfloat16]
    assert f32_launches > 0 and f32_launches % cfg.n_layers == 0
    want, _ = streams(torch.device("cpu"))
    assert got == want
    torch.backends.cuda.matmul.allow_tf32 = True
    with pytest.raises(ValueError, match="TF32"):
        InferenceEngine(transformer.Transformer(cfg, "meta"), cfg,
                        EngineConfig(**ecfg), device=f32_cuda)


# ---------------------------------------------------------------------------
# B2: flash attention
# ---------------------------------------------------------------------------


def _flash_inputs(dev, BH, Sq, Skv, Dh, q_per_kv, dtype, seed):
    gen = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn(BH, Sq, Dh, generator=gen)
    k = torch.randn(BH // q_per_kv, Skv, Dh, generator=gen)
    v = torch.randn(BH // q_per_kv, Skv, Dh, generator=gen)
    return tuple(t.to(dtype).to(dev) for t in (q, k, v))


def _assert_flash_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    if got.dtype == torch.float32:
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=TOL)
    else:
        bad = (g - w).abs() > BF16_ULP * w.abs() + 1e-5
        assert not bad.any(), f"{int(bad.sum())} elements beyond one ulp"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [
    dict(BH=4, Sq=64, Skv=64, Dh=16, q_per_kv=1, causal=True, q_offset=0),
    dict(BH=8, Sq=256, Skv=256, Dh=128, q_per_kv=4, causal=True,
         q_offset=0),
    dict(BH=8, Sq=200, Skv=1000, Dh=64, q_per_kv=4, causal=True,
         q_offset=800),
    dict(BH=4, Sq=77, Skv=333, Dh=128, q_per_kv=1, causal=False,
         q_offset=0),
    dict(BH=8, Sq=131, Skv=131, Dh=16, q_per_kv=4, causal=True, q_offset=0),
    dict(BH=2, Sq=1, Skv=129, Dh=64, q_per_kv=1, causal=True, q_offset=128),
    # The edges of the tensor-core kernel's tiles (128 query rows in two
    # warpgroups of 64, KV blocks of 128): Sq around 64 and 128, a
    # diagonal inside a block (q_offset 1, 127), Skv tails and Skv < 128.
    *(dict(BH=4 * G, Sq=Sq, Skv=Skv, Dh=Dh, q_per_kv=G, causal=c,
           q_offset=off)
      for Sq, Skv, off, Dh, G, c in (
          (1, 129, 128, 128, 4, True), (1, 17, 0, 16, 1, True),
          (63, 128, 0, 64, 1, True), (63, 1000, 128, 64, 4, False),
          (64, 128, 1, 16, 4, True), (64, 1000, 1, 128, 1, False),
          (65, 129, 127, 128, 1, True), (65, 17, 1, 64, 4, False),
          (127, 1000, 128, 64, 4, True), (127, 128, 0, 128, 1, True),
          (128, 17, 0, 128, 4, False), (128, 129, 127, 16, 4, True),
          (129, 1000, 127, 16, 1, True), (129, 129, 0, 128, 4, False))),
])
def test_flash_kernel_matches_plain(cuda, dtype, shape):
    shape = dict(shape)
    causal, q_offset = shape.pop("causal"), shape.pop("q_offset")
    q, k, v = _flash_inputs(cuda, dtype=dtype, seed=2, **shape)
    G = shape["q_per_kv"]
    before = fa.launches
    by_entry = dict(fa.entry_launches)
    got = fa.flash_kernel(q, k, v, causal, q_offset, q_per_kv=G)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    # bf16 through its entry point, f32 through its own, each counted.
    entry = {torch.bfloat16: "flash_attention_bf16_fwd",
             torch.float32: "flash_attention_f32_fwd"}[dtype]
    assert fa.entry_launches == dict(by_entry,
                                     **{entry: by_entry[entry] + 1})
    want = fa.flash_blockwise(q, k, v, causal, q_offset, q_per_kv=G)
    _assert_flash_close(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("Sq,Skv,q_offset,Dh,G,causal", [
    # The f32 kernel's 32-position sub-tiles: Skv and diagonals on and
    # around their edges inside a 128 block, sub-tiles past Skv or wholly
    # above a warpgroup's diagonal, and a full-mantissa walk of 4 blocks.
    (32, 32, 0, 128, 4, True), (33, 33, 0, 64, 1, True),
    (96, 97, 0, 16, 4, True), (1, 31, 30, 128, 1, True),
    (64, 160, 96, 128, 4, True), (65, 161, 31, 64, 4, True),
    (130, 95, 0, 16, 1, False), (200, 300, 100, 128, 4, True),
    (128, 512, 0, 128, 4, False), (257, 257, 0, 64, 1, True),
])
def test_flash_f32_kernel_sub_tile_edges(cuda, Sq, Skv, q_offset, Dh, G,
                                         causal):
    q, k, v = _flash_inputs(cuda, 4 * G, Sq, Skv, Dh, G, torch.float32,
                            seed=9)
    before = fa.entry_launches["flash_attention_f32_fwd"]
    got = fa.flash_kernel(q, k, v, causal, q_offset, q_per_kv=G)
    torch.cuda.synchronize()
    assert fa.entry_launches["flash_attention_f32_fwd"] == before + 1
    _assert_flash_close(got, fa.flash_blockwise(q, k, v, causal, q_offset,
                                                q_per_kv=G))


@pytest.mark.cuda
@pytest.mark.parametrize("G,Sb", [(1, 32), (2, 128), (4, 512), (8, 2048),
                                  (8, 32), (1, 2048)])
def test_flash_kernel_at_the_admission_shapes(cuda, G, Sb):
    """The bucketed cold admission's call at llama3-8b heads: G prompts
    of the Sb bucket folded to [G * 32, Sb, 128] queries against
    [G * 8, Sb, 128] keys, causal from position 0 (Sb = 32 is below the
    kernel's 128-row query tile; G = 8 x Sb = 2048 is the largest
    admission)."""
    q, k, v = _flash_inputs(cuda, G * 32, Sb, Sb, 128, 4, torch.bfloat16,
                            G * Sb)
    before = fa.launches
    got = fa.flash_kernel(q, k, v, True, 0, q_per_kv=4)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    _assert_flash_close(got, fa.flash_blockwise(q, k, v, True, 0,
                                                q_per_kv=4))


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["paged", "dense", "spec"])
def test_bucketed_engines_launch_the_kernels(cuda, mode):
    """On the card the bucketed engines' families run the kernels and
    never their plain versions: a cold admission launches B2 once per
    layer under ``attn_impl="flash"``, and a verify wave on the kernel
    leg launches B1 once per layer."""
    from seldon_tpu_torch.models.sampling import SamplingParams
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

    cfg = get_config("tiny", attn_impl="flash")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    ecfg = dict(max_slots=4, max_seq_len=128, prompt_buckets=(32, 128),
                kv_block=16)
    if mode != "dense":
        ecfg.update(paged_kv=True)
    if mode == "spec":
        ecfg.update(spec_decode=True, spec_k=4, ragged_kernel="pallas")
    eng = InferenceEngine(params, cfg, EngineConfig(**ecfg), cuda)
    eng.warmup()
    fa_before, rpa_before = fa.launches, rpa.launches
    eng.start()
    try:
        outs = [eng.generate_blocking(list(range(3, 3 + n)), SamplingParams(
            temperature=0.0, max_new_tokens=12)) for n in (20, 70)]
    finally:
        eng.stop()
    snap = eng.stats.snapshot()
    assert all(o["token_ids"] for o in outs)
    assert fa.launches - fa_before == \
        cfg.n_layers * snap["cold_admit_dispatches"] > 0
    # Under spec every decode dispatch is a verify wave.
    waves = snap["decode_dispatches"] if mode == "spec" else 0
    assert rpa.launches - rpa_before == cfg.n_layers * waves
    assert (waves > 0) == (mode == "spec")
    assert eng.debug_lifecycle_check() == {}


@pytest.mark.cuda
def test_flash_on_cuda_never_runs_the_plain_version(cuda, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    q, k, v = _flash_inputs(cuda, 8, 96, 96, 64, 4, torch.bfloat16, 3)
    want = fa.flash_blockwise(q, k, v, True, 0, q_per_kv=4)
    monkeypatch.setattr(fa, "flash_blockwise", refuse)
    before = fa.launches
    got = fa.flash_attention(q, k, v, q_per_kv=4)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    _assert_flash_close(got, want)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    q, k, v = _flash_inputs(cuda, 4, 32, 32, 16, 2, torch.bfloat16, 4)
    with pytest.raises(ValueError, match="Dh"):
        fa.flash_kernel(*(t[..., :8].contiguous() for t in (q, k, v)),
                        True, 0, q_per_kv=2)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_kernel(q.transpose(0, 1).contiguous().transpose(0, 1), k, v,
                        True, 0, q_per_kv=2)
    with pytest.raises(TypeError, match="dtype"):
        fa.flash_kernel(q, k.float(), v, True, 0, q_per_kv=2)
    with pytest.raises(ValueError, match="block"):
        fa.flash_kernel(q, k, v, True, 0, block_k=16, q_per_kv=2)


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 2])
def test_forward_flash_launches_once_per_layer(cuda, B):
    cfg = get_config("tiny", attn_impl="flash")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = transformer.init_params(cfg, gen, cuda)
    toks = torch.randint(0, cfg.vocab_size, (B, 70), device=cuda)
    before = fa.launches
    flash = transformer.forward(params, toks, cfg)
    torch.cuda.synchronize()
    assert fa.launches == before + cfg.n_layers
    xla = transformer.forward(params, toks,
                              dataclasses.replace(cfg, attn_impl="xla"))
    assert torch.isfinite(flash).all()
    assert (flash - xla).abs().max().item() < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n", [(4, 4096, 1024), (32, 4096, 14336),
                                      (200, 14336, 4096)])
def test_int_mm_on_the_card_is_the_int64_product(cuda, rows, k, n):
    gen = torch.Generator(device="cpu").manual_seed(rows)
    xq = torch.randint(-127, 128, (rows, k), generator=gen,
                       dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    before = transformer.int_mm_launches
    got = transformer._int_mm(xq.to(cuda), w.to(cuda))
    assert transformer.int_mm_launches == before + 1
    assert got.dtype == torch.int32 and tuple(got.shape) == (rows, n)
    cols = slice(0, 512)
    want = xq.numpy().astype(np.int64) @ w.numpy()[:, cols].astype(np.int64)
    np.testing.assert_array_equal(got[:, cols].cpu().numpy(), want)


@pytest.mark.cuda
def test_weight_codes_on_the_card_equal_the_cpu_codes(cuda):
    gen = torch.Generator(device="cpu").manual_seed(0)
    w = (torch.randn(4096, 1024, generator=gen) * 0.02).bfloat16()
    q_cpu, s_cpu = quantize._quantize_leaf(w)
    q_gpu, s_gpu = quantize._quantize_leaf(w.to(cuda))
    assert torch.equal(q_gpu.cpu(), q_cpu)
    assert torch.equal(s_gpu.cpu().view(torch.int32), s_cpu.view(torch.int32))
    x = (torch.randn(32, 4096, generator=gen) * 3).bfloat16()
    for a, b in zip(transformer._quantize_act(x.to(cuda)),
                    transformer._quantize_act(x)):
        assert torch.equal(a.cpu(), b)
    kv = torch.randn(32, 8, 128, generator=gen).bfloat16()
    for a, b in zip(transformer._quantize_kv(kv.to(cuda)),
                    transformer._quantize_kv(kv)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_noise_bits_on_the_card_equal_the_cpu_bits(cuda):
    seeds = torch.arange(16, dtype=torch.int64) * 977 + 3
    pos = torch.arange(16, dtype=torch.int64) * 131
    V = 128256
    keys = prng.fold_in(prng.key(seeds), pos)
    bits_cpu = prng.random_bits(keys, (V,))
    bits_gpu = prng.random_bits(keys.to(cuda), (V,))
    assert torch.equal(bits_gpu.cpu(), bits_cpu)
    g_cpu = prng.gumbel(keys, (V,))
    g_gpu = prng.gumbel(keys.to(cuda), (V,)).cpu()
    scale = torch.maximum(g_cpu.abs(), torch.ones_like(g_cpu))
    ulp = torch.nextafter(scale, torch.full_like(scale, np.inf)) - scale
    assert torch.isfinite(g_gpu).all()
    assert ((g_gpu - g_cpu).abs() <= 2 * ulp).all()


# The engine's observatory on the card: every ledger armed through the
# environment, as chip_smoke's observatory phase arms it.
OBS_KNOBS = {"FLIGHT_RECORDER": "1", "COMPILE_LEDGER": "1",
             "DISPATCH_TIMING": "1", "HBM_LEDGER": "1", "SCHED_LEDGER": "1",
             "ROOF_LEDGER": "1", "PILOT": "hold"}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["ragged", "paged"])
def test_observatory_on_the_card(cuda, mode, monkeypatch):
    """With every ledger armed the engine launches the kernels as it does
    with none (B1 = layers x wave legs on the ragged kernel leg, B2 =
    layers x cold admissions on the paged bucketed engine under flash),
    the greedy streams are bit-equal, the warmed lattice leaves no live
    retrace, both conservation audits are clean, the roof ledger's peaks
    are the card's table entry (or its own calibration on an unlisted
    card), and the HBM ledger's weights are the parameters' bytes and
    its total at most what the allocator holds."""
    from seldon_tpu_torch.models.sampling import SamplingParams
    from seldon_tpu_torch.servers import cost_model
    from seldon_tpu_torch.servers.engine import EngineConfig, InferenceEngine

    cfg = get_config("tiny", attn_impl="flash")
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda).manual_seed(0), cuda)
    ecfg = dict(max_slots=4, max_seq_len=128, prompt_buckets=(32, 128),
                kv_block=16, paged_kv=True, async_fetch=False)
    if mode == "ragged":
        ecfg.update(chunked_prefill=True, prefill_chunk=32, ragged=True,
                    ragged_kernel="pallas", dispatch_token_budget=4 * 32)
    prompts = [list(range(3, 3 + n)) for n in (20, 70, 9, 100)]

    def run(armed):
        for var, val in OBS_KNOBS.items():
            if armed:
                monkeypatch.setenv(var, val)
            else:
                monkeypatch.delenv(var, raising=False)
        eng = InferenceEngine(params, cfg, EngineConfig(**ecfg), cuda)
        eng.warmup()
        b1, b2 = rpa.launches, fa.launches
        qs = [eng.submit(p, SamplingParams(temperature=0.0,
                                           max_new_tokens=12))
              for p in prompts]
        eng.start()
        try:
            streams = []
            for q in qs:
                toks = []
                while (item := q.get(timeout=120)) is not None:
                    assert "error" not in item, item
                    toks.extend(item["tokens"])
                streams.append(toks)
        finally:
            eng.stop()
        assert eng.debug_lifecycle_check() == {}
        return streams, eng, rpa.launches - b1, fa.launches - b2

    want, _, off_b1, off_b2 = run(False)
    got, eng, b1, b2 = run(True)
    assert got == want
    snap = eng.stats.snapshot()
    if mode == "ragged":
        assert b1 == cfg.n_layers * (snap["decode_dispatches"]
                                     + snap["prefill_waves"]) > 0
        assert b2 == 0
    else:
        assert b2 == cfg.n_layers * snap["cold_admit_dispatches"] > 0
        assert b1 == 0
    assert (b1, b2) == (off_b1, off_b2)
    comp = eng.debug_compile()
    assert comp["warmup_complete"] and comp["live_retrace_count"] == 0
    assert {e["key"] for e in comp["lattice"]} <= set(eng.static_lattice())
    assert eng.debug_sched()["conservation"]["breaches"] == 0
    roof = eng.debug_roof()
    assert roof["conservation"]["breaches"] == 0
    table = cost_model.match_peaks(torch.cuda.get_device_name(cuda))
    if table is not None:
        assert roof["peaks"] == {"tflops": table[0], "gbs": table[1],
                                 "source": "table"}
    else:
        assert roof["peaks"]["source"] == "microbench"
    assert all(v["mfu"] <= 1.0 and v["mbu"] <= 1.0
               for v in roof["variants"])
    hbm = eng.debug_hbm()
    assert hbm["categories"]["weights"]["bytes"] == sum(
        t.numel() * t.element_size() for t in params.parameters())
    assert hbm["total_bytes"] <= torch.cuda.memory_allocated(cuda)


@pytest.mark.cuda
def test_peaks_calibrate_on_the_card(cuda, monkeypatch):
    """An unlisted card name calibrates on the card itself: positive
    rates from a bf16 matmul and a copy there, reported as such."""
    from seldon_tpu_torch.servers import cost_model

    monkeypatch.delenv("ROOF_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("ROOF_PEAK_GBS", raising=False)
    got = cost_model.resolve_peaks("an unlisted card", cuda)
    assert got["source"] == "microbench"
    assert got["tflops"] > 1.0 and got["gbs"] > 10.0
