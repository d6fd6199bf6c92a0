"""The 3xTF32 split of the f32 tensor-core kernels, and its arithmetic held
against the JAX package's f32 functions.

``seldon_tpu_torch.ops._tf32.tf32_split`` is checked by properties
(hypothesis) and against an independent float64 rounding: ``hi`` and
``lo`` carry at most 10 explicit mantissa bits, ties round away from zero
(``cvt.rna``), signed zeros are kept, and ``|x - hi - lo| <= 2**-21 |x|``
over normal f32 values whose residual is normal.

``partials_3xtf32`` (kernel B1's tensor-core route, f32 and int8 pools) and
``flash_3xtf32`` (kernel B2's f32 kernel) redo the kernels' arithmetic from
that split on the CPU: the products as three TF32 terms (two against int8
codes), f32 sums with the small terms first, the kernels' steps and
rescaling points. The same numpy inputs from a seed, with all 23 mantissa
bits live so that the lo terms matter, go through them and through the
JAX package's f32 functions: ``partials_reference`` and ``flash_attention``
(its closed-form reference, and its Pallas kernel in interpret mode as
tests/test_torch_flash_attention.py runs it). Tolerances are the card's:
B1 1e-5 (m relative to max(|m|, 1), l relative, acc / l absolute), B2
1e-4 absolute. Single-pass TF32 (hi terms only) is shown to miss B1's."""

import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl

from seldon_tpu.models import transformer as jtf
from seldon_tpu.ops import ragged_paged_attention as jrpa
from seldon_tpu_torch.ops import _tf32
from tests.torch_port_helpers import f32, to_torch

jfa = importlib.import_module("seldon_tpu.ops.flash_attention")

B1_TOL = 1e-5
B2_TOL = 1e-4
LOW13 = 0x1FFF


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def _rna_f64(x: float) -> float:
    """Round-to-nearest, ties away, to 11 significant bits, in float64."""
    if x == 0.0:
        return x
    m, e = np.frexp(abs(x))  # |x| = m 2^e, m in [0.5, 1)
    r = np.floor(m * 2.0 ** 11 + 0.5) / 2.0 ** 11
    return float(np.copysign(np.ldexp(r, e), x))


normal_f32 = st.floats(min_value=2.0 ** -100, max_value=2.0 ** 100,
                       width=32).flatmap(
    lambda a: st.sampled_from([a, -a]))


@settings(max_examples=300, deadline=None)
@given(st.lists(normal_f32, min_size=1, max_size=64))
def test_split_bits_and_residual(xs):
    x = torch.tensor(xs, dtype=torch.float32)
    hi, lo = _tf32.tf32_split(x)
    assert not (_bits(hi) & LOW13).any() and not (_bits(lo) & LOW13).any()
    x64 = x.double()
    err = (x64 - hi.double() - lo.double()).abs()
    assert (err <= 2.0 ** -21 * x64.abs()).all()
    # x - hi is exact in f32: the residual is what hi left of x.
    assert torch.equal((x - hi).double(), x64 - hi.double())


@settings(max_examples=300, deadline=None)
@given(st.lists(normal_f32, min_size=1, max_size=64))
def test_round_matches_float64_rna(xs):
    x = torch.tensor(xs, dtype=torch.float32)
    want = np.array([_rna_f64(float(v)) for v in x], np.float64)
    np.testing.assert_array_equal(_tf32.tf32_round(x).double().numpy(),
                                  want)


@settings(max_examples=200, deadline=None)
@given(st.integers(min_value=0x00800000 >> 13, max_value=0x7F7FFFFF >> 13),
       st.booleans())
def test_ties_round_away_from_zero(top, negative):
    """Dropped bits exactly half a unit (0x1000): the magnitude rounds up."""
    pattern = (top << 13) | 0x1000 | (0x80000000 if negative else 0)
    x = torch.from_numpy(np.array([pattern], np.uint32).view(np.float32))
    hi = _tf32.tf32_round(x)
    assert int(_bits(hi)[0]) == ((pattern + 0x1000) & 0xFFFFE000)
    assert abs(float(hi)) > abs(float(x))


def test_signed_zeros():
    x = torch.tensor([0.0, -0.0], dtype=torch.float32)
    hi, lo = _tf32.tf32_split(x)
    assert torch.equal(torch.signbit(hi), torch.tensor([False, True]))
    assert (hi == 0).all() and (lo == 0).all()


# ---------------------------------------------------------------------------
# B1: the tensor-core route's partials against JAX's f32 reference
# ---------------------------------------------------------------------------


def _b1_inputs(seed, B, Sq, Hkv, G, Dh, block, nbs, kv, bounds):
    """f32 queries and pool (or the int8 pool the JAX package quantizes
    from f32 K/V), scattered tables whose tails point at the trash block
    0; full-mantissa f32 values."""
    rng = np.random.default_rng(seed)
    nb = B * nbs + 1
    raw_k = jnp.asarray(rng.standard_normal((nb, Hkv, block, Dh)),
                        jnp.float32)
    raw_v = jnp.asarray(rng.standard_normal((nb, Hkv, block, Dh)),
                        jnp.float32)
    if kv == "int8":
        kq, ks = jtf._quantize_kv(raw_k)
        vq, vs = jtf._quantize_kv(raw_v)
        layer = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        layer = {"k": raw_k, "v": raw_v}
    perm = rng.permutation(nb - 1) + 1
    table = np.zeros((B, nbs), np.int32)
    for i, bnd in enumerate(bounds):
        live = -(-int(bnd) // block)
        table[i, :live] = perm[i * nbs:i * nbs + live]
    bound = np.repeat(np.asarray(bounds, np.int32)[:, None], Sq, axis=1)
    q = jnp.asarray(rng.standard_normal((B, Sq, Hkv, G, Dh)), jnp.float32)
    return q, layer, jnp.asarray(table), jnp.asarray(bound)


def _b1_errors(got, want, bound):
    gm, gl, ga = (f32(x) for x in got)
    wm, wl, wa = (np.asarray(x, np.float32) for x in want)
    live = np.broadcast_to((np.asarray(bound) > 0)[:, None, None, :, None],
                           gm.shape)
    dead = ~live
    assert (gm[dead] == -1e30).all() and (gl[dead] == 0).all()
    assert (ga[np.broadcast_to(dead, ga.shape)] == 0).all()
    em = np.where(live, np.abs(gm - wm) / np.maximum(np.abs(wm), 1.0), 0)
    el = np.where(live, np.abs(gl - wl) / np.maximum(wl, 1e-30), 0)
    ea = np.where(np.broadcast_to(live, ga.shape),
                  np.abs(ga / np.maximum(gl, 1e-30)
                         - wa / np.maximum(wl, 1e-30)), 0)
    return float(em.max()), float(el.max()), float(ea.max())


B1_SHAPES = [
    # R = 64 (one warpgroup tile), Dh 16, a block that does not divide 32.
    dict(B=3, Sq=16, Hkv=2, G=4, Dh=16, block=48, nbs=6,
         bounds=(0, 288, 47)),
    # R = 512 (the serving prefill wave's rows), Dh 128, dead rows.
    dict(B=3, Sq=128, Hkv=1, G=4, Dh=128, block=16, nbs=16,
         bounds=(256, 0, 33)),
    # R = 64 at Dh 128; R = 512 at Dh 16.
    dict(B=2, Sq=64, Hkv=2, G=1, Dh=128, block=16, nbs=8,
         bounds=(0, 97)),
    dict(B=2, Sq=128, Hkv=1, G=4, Dh=16, block=16, nbs=12,
         bounds=(192, 0)),
]


@pytest.mark.parametrize("kv", ["f32", "int8"])
@pytest.mark.parametrize("shape", B1_SHAPES)
def test_b1_3xtf32_matches_jax_f32(kv, shape):
    shape = dict(shape)
    q, layer, table, bound = _b1_inputs(seed=7, kv=kv, **shape)
    want = jrpa.partials_reference(q, layer, table, bound)
    args = (to_torch(q), {k: to_torch(v) for k, v in layer.items()},
            to_torch(table), to_torch(bound))
    got = _tf32.partials_3xtf32(*args)
    err = _b1_errors(got, want, bound[:, 0][:, None])
    assert max(err) <= B1_TOL, err


def test_b1_single_pass_tf32_misses_the_gate(monkeypatch):
    """Dropping the lo terms (hi products only: single-pass TF32) moves
    the same partials far past 1e-5: the lo terms carry the accuracy."""
    q, layer, table, bound = _b1_inputs(seed=7, kv="f32", **{
        k: v for k, v in B1_SHAPES[1].items()})
    want = jrpa.partials_reference(q, layer, table, bound)
    args = (to_torch(q), {k: to_torch(v) for k, v in layer.items()},
            to_torch(table), to_torch(bound))
    monkeypatch.setattr(_tf32, "tf32_split",
                        lambda x: (_tf32.tf32_round(x), None))
    err = _b1_errors(_tf32.partials_3xtf32(*args), want,
                     bound[:, 0][:, None])
    assert max(err) > 10 * B1_TOL, err


# ---------------------------------------------------------------------------
# B2: the f32 kernel's output against JAX's f32 flash attention
# ---------------------------------------------------------------------------


def _b2_inputs(seed, BH, Sq, Skv, Dh, q_per_kv):
    rng = np.random.default_rng(seed)
    return tuple(jnp.asarray(rng.standard_normal(s), jnp.float32) for s in (
        (BH, Sq, Dh), (BH // q_per_kv, Skv, Dh), (BH // q_per_kv, Skv, Dh)))


def _interp_flash_pallas(*args, **kw):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp):
        return jfa._flash_pallas(*args, **kw)


@pytest.mark.parametrize("BH,Sq,Skv,Dh,G,causal,q_offset", [
    (4, 64, 64, 16, 1, True, 0),
    (8, 200, 300, 128, 4, True, 100),
    (4, 77, 333, 128, 1, False, 0),
    (8, 130, 130, 16, 4, True, 0),
])
def test_b2_3xtf32_matches_jax_f32_reference(BH, Sq, Skv, Dh, G, causal,
                                             q_offset):
    q, k, v = _b2_inputs(3, BH, Sq, Skv, Dh, G)
    want = jfa.flash_attention(q, k, v, causal, q_offset, G,
                               force_reference=True)
    got = _tf32.flash_3xtf32(to_torch(q), to_torch(k), to_torch(v), causal,
                             q_offset, G)
    np.testing.assert_allclose(f32(got), np.asarray(want, np.float32),
                               rtol=0, atol=B2_TOL)


@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 128),
                                             (False, 0)])
def test_b2_3xtf32_matches_interpreted_pallas(causal, q_offset):
    """At the kernel's own block (128) and llama3-8b's head shape."""
    q, k, v = _b2_inputs(4, 8, 128, 128 + q_offset, 128, 4)
    want = _interp_flash_pallas(q, k, v, causal, q_offset, 128, 128,
                                q_per_kv=4)
    got = _tf32.flash_3xtf32(to_torch(q), to_torch(k), to_torch(v), causal,
                             q_offset, 4)
    np.testing.assert_allclose(f32(got), np.asarray(want, np.float32),
                               rtol=0, atol=B2_TOL)
