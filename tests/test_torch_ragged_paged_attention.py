"""seldon_tpu_torch.ops.ragged_paged_attention against the JAX package.

The port's plain version of the kernel (``partials_sparse``) and its
oracle (``partials_reference``) are held against JAX's
``partials_reference`` and, at one small shape, against JAX's Pallas
kernel ``partials_pallas`` in interpret mode, for bf16 and int8 pools,
with a ``bound = 0`` row and table tails at the trash block 0.
Tolerance: 1e-5 on m and acc/l (f32 sums in another order), relative
1e-5 on l. The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_kernel_cuda.py, chip_smoke.py). The sparse
leg's masked-matched two-pass walk (``sparse_max_sum``,
``sparse_weighted_value``) is held against its JAX twin with bf16 and
int8 pools, dequant on and off: m within 1e-6 absolute, l and acc within
1e-5 relative (acc relative to each row's largest element)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import transformer as jtf
from seldon_tpu.models.config import PRESETS
from seldon_tpu.ops import ragged_paged_attention as jrpa
from seldon_tpu_torch.ops import ragged_paged_attention as rpa
from tests.torch_port_helpers import f32, to_torch

TINY = PRESETS["tiny"]
BLOCK, NBS, B = 8, 6, 4
# Empty row, partial block, exact block edge, multi-block.
BOUNDS = np.array([0, 5, BLOCK, 37], np.int32)


def _layer(kv_dtype, seed):
    """One pool layer with random contents and per-row tables whose tails
    past each row's live blocks point at the trash block 0."""
    rng = np.random.default_rng(seed)
    hkv, dh = TINY.n_kv_heads, TINY.head_dim
    nb = B * NBS + 1
    raw_k = jnp.asarray(rng.standard_normal((nb, hkv, BLOCK, dh)),
                        jnp.bfloat16)
    raw_v = jnp.asarray(rng.standard_normal((nb, hkv, BLOCK, dh)),
                        jnp.bfloat16)
    if kv_dtype == "int8":
        kq, ks = jtf._quantize_kv(raw_k)
        vq, vs = jtf._quantize_kv(raw_v)
        layer = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        layer = {"k": raw_k, "v": raw_v}
    table = np.zeros((B, NBS), np.int32)
    for i, bnd in enumerate(BOUNDS):
        live = -(-int(bnd) // BLOCK)
        table[i, :live] = 1 + i * NBS + np.arange(live)
    return layer, jnp.asarray(table), rng


def _q(rng, sq):
    g = TINY.n_heads // TINY.n_kv_heads
    return jnp.asarray(
        rng.standard_normal((B, sq, TINY.n_kv_heads, g, TINY.head_dim)),
        jnp.bfloat16)


def _torch_args(q, layer, table, bound):
    return (to_torch(q), {k: to_torch(v) for k, v in layer.items()},
            to_torch(table), to_torch(bound))


def _assert_partials(got, want, tol=1e-5):
    gm, gl, ga = (f32(x) for x in got)
    wm, wl, wa = (np.asarray(x, np.float32) for x in want)
    assert gm.shape == wm.shape and ga.shape == wa.shape
    np.testing.assert_allclose(gm, wm, rtol=0, atol=tol)
    np.testing.assert_allclose(gl, wl, rtol=tol, atol=0)
    np.testing.assert_allclose(ga / np.maximum(gl, 1e-30),
                               wa / np.maximum(wl, 1e-30), rtol=0, atol=tol)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("leg", ["sparse", "reference"])
def test_plain_partials_match_jax_reference(kv_dtype, leg):
    layer, table, rng = _layer(kv_dtype, seed=0)
    sq = 3
    q = _q(rng, sq)
    bound = jnp.broadcast_to(jnp.asarray(BOUNDS)[:, None], (B, sq))
    want = jrpa.partials_reference(q, layer, table, bound)
    fn = rpa.partials_sparse if leg == "sparse" else rpa.partials_reference
    got = fn(*_torch_args(q, layer, table, bound))
    _assert_partials(got, want)
    # The empty row comes out exactly (NEG_INF, 0, 0), never NaN.
    m, l, acc = got
    assert torch.all(m[0] == rpa.NEG_INF) and torch.all(l[0] == 0)
    assert torch.all(acc[0] == 0)


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_kernel_wrapper_on_cpu_matches_jax_pallas_interpret(kv_dtype):
    """The JAX Pallas kernel (interpret mode off-TPU) and the port's
    kernel wrapper, which runs the plain version for CPU tensors."""
    layer, table, rng = _layer(kv_dtype, seed=1)
    q = _q(rng, 1)
    bound = jnp.asarray(BOUNDS)[:, None]
    want = jrpa.partials_pallas(q, layer, table, bound, interpret=True)
    before = rpa.launches
    got = rpa.ragged_paged_partials(*_torch_args(q, layer, table, bound),
                                    mode="pallas")
    _assert_partials(got, want, tol=1e-4)
    assert rpa.launches == before  # the CPU path launches no kernel


def test_combine_fresh_matches():
    rng = np.random.default_rng(2)
    Bq, hkv, g, sq, f, dh = 2, 2, 3, 4, 5, 16
    m = jnp.asarray(rng.standard_normal((Bq, hkv, g, sq, 1)), jnp.float32)
    m = m.at[0, 0].set(jrpa.NEG_INF)
    l = jnp.asarray(rng.uniform(0.5, 3.0, (Bq, hkv, g, sq, 1)), jnp.float32)
    l = l.at[0, 0].set(0.0)
    acc = jnp.asarray(rng.standard_normal((Bq, hkv, g, sq, dh)), jnp.float32)
    acc = acc.at[0, 0].set(0.0)
    s_f = jnp.asarray(rng.standard_normal((Bq, hkv, g, sq, f)), jnp.float32)
    s_f = s_f.at[..., 3:].set(jrpa.NEG_INF)
    v_f = jnp.asarray(rng.standard_normal((Bq, hkv, f, dh)), jnp.bfloat16)
    want = jrpa.combine_fresh((m, l, acc), s_f, v_f)
    got = rpa.combine_fresh(tuple(to_torch(x) for x in (m, l, acc)),
                            to_torch(s_f), to_torch(v_f))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    p_mask = jnp.arange(f)[None, None, None, None, :] < 2
    want = jrpa.combine_fresh((m, l, acc), s_f, v_f, p_mask=p_mask)
    got = rpa.combine_fresh(tuple(to_torch(x) for x in (m, l, acc)),
                            to_torch(s_f), to_torch(v_f),
                            p_mask=to_torch(p_mask))
    np.testing.assert_allclose(f32(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_constants_and_modes():
    assert rpa.NEG_INF == jrpa.NEG_INF
    assert rpa.RAGGED_LOGITS_ATOL == jrpa.RAGGED_LOGITS_ATOL
    layer, table, rng = _layer("bf16", seed=3)
    q = _q(rng, 1)
    args = _torch_args(q, layer, table, jnp.asarray(BOUNDS)[:, None])
    assert rpa.MODES == ("reference", "sparse", "pallas")
    with pytest.raises(ValueError, match="unknown"):
        rpa.ragged_paged_partials(*args, mode="masked")
    ref = rpa.ragged_paged_partials(*args, mode="reference")
    _assert_partials(rpa.ragged_paged_partials(*args, mode="sparse"),
                     tuple(x.numpy() for x in ref))
    _assert_partials(rpa.ragged_paged_partials(*args, mode="pallas"),
                     tuple(x.numpy() for x in ref))


def test_kernel_wrapper_rejects_cuda_tensors_it_cannot_take(monkeypatch):
    """For a CUDA tensor the wrapper launches or raises; here a tensor
    posing as CUDA with the wrong dtype must raise before any build."""
    layer, table, rng = _layer("bf16", seed=4)
    q, tl, tt, tb = _torch_args(_q(rng, 1), layer, table,
                                jnp.asarray(BOUNDS)[:, None])

    class FakeCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    qf = q.float().as_subclass(FakeCuda)
    monkeypatch.setattr(rpa, "_kernel_lib", lambda: pytest.fail("built"))
    with pytest.raises(TypeError, match="dtype"):
        rpa.partials_kernel(qf, tl, tt, tb)


def _split_partials(args, cols):
    """The plain walk cut into splits of ``cols`` block columns (the
    kernel's decode route cuts its walk into position ranges; ranges of
    whole blocks are the ones the plain walk can express): split i walks
    its own columns with positions counted from its start."""
    q, layer, table, bound = args
    parts = []
    for c0 in range(0, table.shape[1], cols):
        sub = table[:, c0:c0 + cols].contiguous()
        b = torch.clamp(bound - c0 * BLOCK, 0, sub.shape[1] * BLOCK)
        parts.append(rpa.partials_sparse(q, layer, sub, b.int()))
    return parts


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("cols", [1, 2, 4])
def test_merge_partials_of_splits_matches_whole_walk(kv_dtype, cols):
    """Splits of the live columns folded by merge_partials (the decode
    route's merge) against the unsplit plain walk (1e-6: only the fold's
    f32 rounding differs) and JAX's Pallas kernel in interpret mode (the
    file's kernel tolerance); rows with bound 0, whose splits are all
    dead, come out exactly (NEG_INF, 0, 0)."""
    layer, table, rng = _layer(kv_dtype, seed=5)
    sq = 2
    q = _q(rng, sq)
    bound = jnp.broadcast_to(jnp.asarray(BOUNDS)[:, None], (B, sq))
    args = _torch_args(q, layer, table, bound)
    parts = _split_partials(args, cols)
    assert len(parts) == -(-NBS // cols)
    got = rpa.merge_partials(parts)
    _assert_partials(got, tuple(x.numpy() for x in rpa.partials_sparse(*args)),
                     tol=1e-6)
    want = jrpa.partials_pallas(q, layer, table, bound, interpret=True)
    _assert_partials(got, want, tol=1e-4)
    m, l, acc = got
    assert torch.all(m[0] == rpa.NEG_INF) and torch.all(l[0] == 0)
    assert torch.all(acc[0] == 0)


def test_decode_split_plan():
    """Split plans follow the table's width in positions, never the
    bounds: splits of SPLIT_POSITIONS positions."""
    assert rpa.decode_split(128, 16) == (16, 128)  # 2048 positions
    assert rpa.decode_split(27, 16) == (4, 128)
    assert rpa.decode_split(6, 8) == (1, 128)
    assert rpa.decode_split(20, 48) == (8, 128)
    for nbs in (1, 7, 64, 129):
        for block in (1, 3, 8, 16, 48, 64):
            n, span = rpa.decode_split(nbs, block)
            assert span == rpa.SPLIT_POSITIONS and span % 32 == 0
            assert (n - 1) * span < nbs * block <= n * span


def _two_pass_inputs(kv_dtype, seed, sq=3):
    layer, table, rng = _layer(kv_dtype, seed)
    q = _q(rng, sq)
    # Per query row bounds: the row's bound, then fewer positions.
    bound = np.maximum(BOUNDS[:, None] - np.arange(sq)[None, :] * 3, 0)
    bound[0] = 0  # a dead row: every pool lane masked
    s_f = jnp.asarray(rng.standard_normal(
        (B, TINY.n_kv_heads, q.shape[3], sq, 1)), jnp.float32)
    return q, layer, table, jnp.asarray(bound.astype(np.int32)), s_f


@pytest.mark.parametrize("dequant", [False, True])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sparse_two_pass_walk_matches_jax(kv_dtype, dequant):
    q, layer, table, bound, s_f = _two_pass_inputs(kv_dtype, 11)
    m_p, l_p = jrpa.sparse_max_sum(q, layer, table, bound, dequant=dequant)
    args = _torch_args(q, layer, table, bound)
    gm, gl = rpa.sparse_max_sum(*args, dequant=dequant)
    np.testing.assert_allclose(f32(gm), np.asarray(m_p), rtol=0, atol=1e-6)
    np.testing.assert_allclose(f32(gl), np.asarray(l_p), rtol=1e-5, atol=0)
    # The caller's fold of one fresh column, then pass 2 on the same m_t,
    # l_t in both packages.
    m_t = jnp.maximum(m_p, s_f)
    l_t = l_p * jnp.exp(m_p - m_t) + jnp.exp(s_f - m_t)
    want = np.asarray(jrpa.sparse_weighted_value(q, layer, table, bound,
                                                 m_t, l_t, dequant=dequant))
    got = f32(rpa.sparse_weighted_value(*args, to_torch(m_t), to_torch(l_t),
                                        dequant=dequant))
    scale = np.abs(want).max(axis=-1, keepdims=True)
    assert np.all(np.abs(got - want) <= 1e-5 * np.maximum(scale, 1e-30))
    assert np.all(got[0] == 0.0)  # the dead row adds nothing


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_sparse_walk_trip_count_from_the_host(kv_dtype):
    """The host's count equals the one read from the device, and a
    larger count walks dead columns that add exact zeros."""
    q, layer, table, bound, s_f = _two_pass_inputs(kv_dtype, 12)
    args = _torch_args(q, layer, table, bound)
    n = -(-int(BOUNDS.max()) // BLOCK)
    assert rpa.live_columns(args[3], BLOCK, NBS) == n
    assert rpa.live_columns(args[3], BLOCK, NBS, n_live=99) == NBS
    m_t, l_t = to_torch(jnp.full(s_f.shape, 2.0)), to_torch(
        jnp.full(s_f.shape, 3.0))
    base = rpa.sparse_max_sum(*args, dequant=True)
    base_acc = rpa.sparse_weighted_value(*args, m_t, l_t, dequant=True)
    for extra in (n, n + 1, NBS):
        got = rpa.sparse_max_sum(*args, dequant=True, n_live=extra)
        for g, w in zip(got, base):
            assert torch.equal(g, w)
        acc = rpa.sparse_weighted_value(*args, m_t, l_t, dequant=True,
                                        n_live=extra)
        assert torch.equal(acc, base_acc)
