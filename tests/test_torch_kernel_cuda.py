"""The hand-written CUDA ragged paged-attention kernel against its plain
version, on the card. Marked `cuda`; skipped where there is no card.

This file imports neither jax nor the JAX package, so it also runs on a
machine with only PyTorch for CUDA (the repo's conftest imports jax;
skip it there):

    python -m pytest --noconftest -m cuda tests/test_torch_kernel_cuda.py

Tolerance: 1e-4 absolute on m and on acc/l, 1e-4 relative on l — f32
sums taken in another order than the plain version's."""

import numpy as np
import pytest
import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.ops import ragged_paged_attention as rpa

TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "python -m pytest --noconftest -m cuda "
                    "tests/test_torch_kernel_cuda.py")
    return torch.device("cuda")


def _inputs(dev, B, Sq, Hkv, G, Dh, block, nbs, kv_dtype, seed):
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
    bounds = torch.randint(0, nbs * block + 1, (B,), generator=gen)
    bounds[0] = 0
    bounds[-1] = nbs * block
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
])
def test_kernel_matches_plain(cuda, kv_dtype, shape):
    q, layer, table, bound = _inputs(cuda, kv_dtype=kv_dtype, seed=0,
                                     **shape)
    before = rpa.launches
    got = rpa.partials_kernel(q, layer, table, bound)
    torch.cuda.synchronize()
    assert rpa.launches == before + 1
    want = rpa.partials_sparse(q, layer, table, bound)
    gm, gl, ga = (t.cpu() for t in got)
    wm, wl, wa = (t.cpu() for t in want)
    assert torch.isfinite(gm).all() and torch.isfinite(ga).all()
    assert torch.all(gm[0] == rpa.NEG_INF) and torch.all(gl[0] == 0)
    assert torch.all(ga[0] == 0)  # the bound = 0 row
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
