"""seldon_tpu_torch.models.sampling against seldon_tpu.models.sampling.

Selection is held against JAX's ``sample_per_row`` by feeding the
port's ``select_tokens`` JAX's own Gumbel noise (``jax.random.gumbel``
under the same per-row keys): the tokens must be equal, greedy,
temperature-only and with top-k / top-p masks. The port's own noise
(``jax.random``'s threefry under ``fold_in(key(seed), position)``,
models/prng.py; held against JAX in tests/test_torch_prng.py) is checked
for what the engine relies on: rows reproducible from (seed, position)
alone, and a Gumbel(0, 1) distribution."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seldon_tpu.models import sampling as jsm
from seldon_tpu_torch.models import sampling as tsm
from tests.torch_port_helpers import to_torch

B, V = 6, 257


def _jax_gumbel(keys):
    return jax.vmap(lambda k: jax.random.gumbel(k, (V,), jnp.float32))(keys)


KNOBS = ["greedy", "temperature", "top_k", "top_p", "mixed"]


@pytest.mark.parametrize("knobs", KNOBS)
def test_selection_with_jax_noise_gives_jax_tokens(knobs):
    rng = np.random.default_rng(KNOBS.index(knobs))
    logits = jnp.asarray(rng.standard_normal((B, V)) * 3, jnp.float32)
    temps = jnp.full((B,), 0.0 if knobs == "greedy" else 0.8, jnp.float32)
    top_k = jnp.zeros((B,), jnp.int32)
    top_p = jnp.ones((B,), jnp.float32)
    if knobs == "top_k":
        top_k = jnp.asarray([1, 2, 5, 10, 50, 0], jnp.int32)
    if knobs == "top_p":
        top_p = jnp.asarray([0.0, 0.1, 0.5, 0.9, 0.99, 1.0], jnp.float32)
    if knobs == "mixed":
        temps = jnp.asarray([0.0, 0.5, 1.0, 1.5, 0.7, 0.0], jnp.float32)
        top_k = jnp.asarray([0, 3, 0, 40, 8, 2], jnp.int32)
        top_p = jnp.asarray([1.0, 1.0, 0.8, 0.95, 0.3, 1.0], jnp.float32)
    seeds = jnp.arange(B, dtype=jnp.uint32) * 7 + 1
    pos = jnp.arange(B, dtype=jnp.int32) + 11
    keys = jax.vmap(lambda s, p: jax.random.fold_in(jax.random.key(s), p))(
        seeds, pos)
    draws = []
    for trial in range(8):  # many draws: sampled rows land anywhere
        ks = jax.vmap(lambda k: jax.random.fold_in(k, trial))(keys)
        want = jsm.sample_per_row(logits, ks, temps, top_k, top_p)
        got = tsm.select_tokens(to_torch(logits), to_torch(_jax_gumbel(ks)),
                                to_torch(temps), to_torch(top_k),
                                to_torch(top_p))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        draws.append(np.asarray(want))
    if knobs == "top_k":
        # top_k = 1 is greedy whatever the noise.
        assert all(d[0] == int(jnp.argmax(logits[0])) for d in draws)


def test_mask_top_k_top_p_matches():
    rng = np.random.default_rng(3)
    scaled = jnp.asarray(rng.standard_normal((B, V)), jnp.float32)
    top_k = jnp.asarray([0, 1, 4, 100, 0, 7], jnp.int32)
    top_p = jnp.asarray([0.5, 1.0, 0.9, 0.2, 1.0, 0.0], jnp.float32)
    want = np.asarray(jsm._mask_top_k_top_p(scaled, top_k, top_p))
    got = tsm._mask_top_k_top_p(to_torch(scaled), to_torch(top_k),
                                to_torch(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_noise_is_keyed_by_seed_and_position_only():
    seeds = torch.tensor([5, 5, 6, 2**32 - 1], dtype=torch.int64)
    pos = torch.tensor([9, 10, 9, 9], dtype=torch.int32)
    g = tsm.gumbel_noise(seeds, pos, V)
    assert g.shape == (4, V) and torch.isfinite(g).all()
    # A row does not depend on its batch position or neighbours.
    alone = tsm.gumbel_noise(seeds[1:2], pos[1:2], V)
    assert torch.equal(alone[0], g[1])
    assert not torch.equal(g[0], g[1]) and not torch.equal(g[0], g[2])
    # Same (seed, position) -> same noise, call after call.
    assert torch.equal(tsm.gumbel_noise(seeds, pos, V), g)


def test_noise_is_gumbel_distributed():
    seeds = torch.arange(64, dtype=torch.int64)
    pos = torch.arange(64, dtype=torch.int32) * 3
    g = tsm.gumbel_noise(seeds, pos, 4096).double()
    # Gumbel(0, 1): mean = Euler-Mascheroni, variance = pi^2 / 6.
    assert abs(g.mean().item() - 0.5772157) < 0.01
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.03


def test_sampling_params_fields_match():
    jf = [(f.name, f.default) for f in dataclasses.fields(jsm.SamplingParams)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tsm.SamplingParams)]
    assert tf == jf
