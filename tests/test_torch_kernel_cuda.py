"""The hand-written CUDA kernels against their plain versions, on the
card: ragged paged attention (B1) and flash attention (B2). Marked
`cuda`; skipped where there is no card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (the repo's conftest imports jax;
skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerances — B1: 1e-4 absolute on m and on acc/l, 1e-4 relative on l,
f32 sums taken in another order than the plain version's (both of its
routes keep p in f32: the tensor-core route as a bf16 hi + lo pair). B2: both of
its kernels (bf16 on the tensor cores, f32 on the CUDA cores) keep the
plain version's rounding points, so f32 outputs agree to 1e-4 absolute,
and each bf16 output lies within one bf16 ulp of the plain one
(|d| <= 2**-7 |plain| + 1e-5).

Also on the card, integer work that must match the CPU bit for bit: the
W8A8 projections' s8 x s8 -> s32 products (``torch._int_mm``, cuBLASLt)
against an int64 numpy product at llama3-8b widths, the int8 weight
codes and scales of ``quantize._quantize_leaf`` (and of the activation
and KV quantizers), and the threefry bits
of the engine's sampling noise (``models/prng.py``) against the CPU's;
the Gumbel noise itself within two f32 ulps at its scale (two logs, each
rounded by another library)."""

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
    # bf16 through the tensor-core entry point, f32 through the CUDA-core
    # one, each counted.
    entry = {torch.bfloat16: "flash_attention_bf16_fwd",
             torch.float32: "flash_attention_f32_fwd"}[dtype]
    assert fa.entry_launches == dict(by_entry,
                                     **{entry: by_entry[entry] + 1})
    want = fa.flash_blockwise(q, k, v, causal, q_offset, q_per_kv=G)
    _assert_flash_close(got, want)


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
def test_forward_flash_launches_once_per_layer(cuda):
    cfg = get_config("tiny", attn_impl="flash")
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = transformer.init_params(cfg, gen, cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 70), device=cuda)
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
