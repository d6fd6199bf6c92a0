"""seldon_tpu_torch.ops.flash_attention against seldon_tpu.ops.flash_attention.

Same numpy inputs (made from a seed) through both. Tolerances:
 * f32, 1e-5 (relative and absolute): the two sum the same terms in
   another order;
 * bf16, 1e-2 (relative and absolute): the outputs are rounded to bf16
   (2**-8 relative), and a probability whose f32 value sits on a bf16
   rounding boundary may round the other way; the share of bit-equal
   elements is reported.
The Pallas kernel runs in interpret mode, patched exactly as
tests/test_ops.py patches ``pl.pallas_call``."""

import importlib
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from seldon_tpu_torch.ops import flash_attention as tfa
from tests.torch_port_helpers import bits, f32, to_torch

# seldon_tpu.ops re-exports the function under the module's name.
jfa = importlib.import_module("seldon_tpu.ops.flash_attention")

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _inputs(seed, BH, Sq, Skv, Dh, q_per_kv, dtype):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, Sq, Dh))
    k = rng.standard_normal((BH // q_per_kv, Skv, Dh))
    v = rng.standard_normal((BH // q_per_kv, Skv, Dh))
    return tuple(jnp.asarray(a, jnp.float32).astype(dtype) for a in (q, k, v))


def _close(got, want, dtype, what):
    tol = TOL[dtype]
    np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)
    if dtype == "bfloat16":
        share = float(np.mean(bits(got) == bits(want)))
        print(f"{what}: {share:.4f} of bf16 elements bit-equal")


def _interp_flash_pallas(*args, **kw):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp):
        return jfa._flash_pallas(*args, **kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,q_offset", [(True, 0), (True, 9),
                                             (False, 0)])
@pytest.mark.parametrize("q_per_kv", [1, 2, 4])
def test_reference_matches_jax(dtype, causal, q_offset, q_per_kv):
    q, k, v = _inputs(0, 8, 12, 12 + q_offset, 16, q_per_kv, dtype)
    want = jfa.flash_attention(q, k, v, causal, q_offset, q_per_kv,
                               force_reference=True)
    got = tfa.flash_attention(to_torch(q), to_torch(k), to_torch(v), causal,
                              q_offset, q_per_kv, force_reference=True)
    assert got.dtype == to_torch(want).dtype
    _close(got, want, dtype, f"reference {dtype} causal={causal} "
           f"q_offset={q_offset} G={q_per_kv}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,Sq,Skv,q_offset", [
    (True, 32, 32, 0), (False, 32, 32, 0), (True, 16, 48, 32)])
@pytest.mark.parametrize("q_per_kv", [1, 2])
def test_plain_matches_interpreted_pallas(dtype, causal, Sq, Skv, q_offset,
                                          q_per_kv):
    q, k, v = _inputs(1, 4, Sq, Skv, 16, q_per_kv, dtype)
    want = _interp_flash_pallas(q, k, v, causal, q_offset, 16, 16,
                                q_per_kv=q_per_kv)
    got = tfa.flash_blockwise(to_torch(q), to_torch(k), to_torch(v), causal,
                              q_offset, block_k=16, q_per_kv=q_per_kv)
    _close(got, want, dtype, f"plain vs pallas {dtype} causal={causal} "
           f"Sq={Sq} Skv={Skv} q_offset={q_offset} G={q_per_kv}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Skv,q_offset", [(256, 0), (384, 128)])
def test_plain_matches_interpreted_pallas_at_kernel_blocks(dtype, Skv,
                                                          q_offset):
    """The CUDA kernels' own block (128) and llama3-8b's head shape (Dh
    128, four query heads per KV head): the plain version is the kernels'
    oracle on the card, so its agreement with the TPU kernel is pinned
    here at that block size."""
    q, k, v = _inputs(4, 8, 256, Skv, 128, 4, dtype)
    want = _interp_flash_pallas(q, k, v, True, q_offset, 128, 128,
                                q_per_kv=4)
    got = tfa.flash_blockwise(to_torch(q), to_torch(k), to_torch(v), True,
                              q_offset, block_k=tfa.KERNEL_BLOCK_K,
                              q_per_kv=4)
    _close(got, want, dtype, f"plain vs pallas {dtype} Dh=128 G=4 "
           f"Skv={Skv} q_offset={q_offset} blocks=128")


@pytest.mark.parametrize("causal,Sq,Skv,q_offset,block_k", [
    (True, 37, 37, 0, 16),
    (True, 20, 75, 55, 16),
    (True, 5, 300, 295, 128),
    (False, 50, 33, 0, 16),
    (False, 3, 200, 0, 128),
])
def test_plain_tails_and_offsets_match_reference(causal, Sq, Skv, q_offset,
                                                 block_k):
    q, k, v = _inputs(2, 4, Sq, Skv, 16, 2, "float32")
    tq, tk, tv = to_torch(q), to_torch(k), to_torch(v)
    want = tfa.flash_attention(tq, tk, tv, causal, q_offset, 2,
                               force_reference=True)
    got = tfa.flash_blockwise(tq, tk, tv, causal, q_offset, block_k=block_k,
                              q_per_kv=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_dispatch_on_the_cpu():
    q, k, v = (to_torch(a) for a in _inputs(3, 4, 40, 40, 16, 2,
                                            "bfloat16"))
    before = tfa.launches
    got = tfa.flash_attention(q, k, v, q_per_kv=2)
    assert tfa.launches == before  # the plain version, not the kernel
    assert torch.equal(got, tfa.flash_blockwise(q, k, v, True, 0, 128, 2))
    ref = tfa.flash_attention(q, k, v, q_per_kv=2, force_reference=True)
    assert torch.equal(ref, tfa.attention_reference(
        q, k.repeat_interleave(2, 0), v.repeat_interleave(2, 0)))
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(q, k, v, q_per_kv=2, force_pallas=True)
    with pytest.raises(ValueError, match="group"):
        tfa.flash_attention(q, k, v, q_per_kv=4)
