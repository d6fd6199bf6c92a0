"""seldon_tpu_torch.models.prng against jax.random (threefry 2x32, the
partitionable scheme jax uses by default).

Bit-equal over a (seed, position) grid: the threefry hash, ``key``,
``fold_in``, ``split``, ``random_bits`` and ``uniform``. The Gumbel
noise ``-log(-log(u))`` of the same uniform may differ only where a
``log`` rounds differently in the two libraries: each of the two logs is
held within one ulp of XLA's on the same input. Composed, an ulp of the
inner log's output near 1 moves the outer log by 2**-23 absolute, so the
noise itself is held within two ulps at its scale, ``max(|g|, 1)``.
Sampled engine streams then equal the JAX engine's token for token,
except at reported near-ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

from seldon_tpu.models import sampling as jsm
from seldon_tpu.models.config import PRESETS
from seldon_tpu_torch.models import prng
from seldon_tpu_torch.models import sampling as tsm
from seldon_tpu_torch.models.config import PRESETS as TPRESETS
from tests.torch_port_helpers import (assert_streams_match, engine_prompts,
                                      params_pair, run_jax_engine,
                                      run_torch_engine, to_torch)

SEEDS = np.array([0, 1, 7, 100, 12345, 2**31 - 1, 2**31 + 5, 2**32 - 1],
                 np.uint32)
POSITIONS = np.array([0, 1, 2, 15, 16, 127, 2047, 65535], np.int32)
V = 1031  # odd, and not a multiple of any tile


def _grid():
    s, p = np.meshgrid(SEEDS, POSITIONS, indexing="ij")
    return s.reshape(-1), p.reshape(-1)


def _jax_keys():
    s, p = _grid()
    return jax.vmap(lambda a, b: jax.random.fold_in(jax.random.key(a), b))(
        jnp.asarray(s), jnp.asarray(p))


def _torch_keys():
    s, p = _grid()
    return prng.fold_in(prng.key(torch.from_numpy(s.astype(np.int64))),
                        torch.from_numpy(p.astype(np.int64)))


def _data(keys):
    return np.asarray(jax.random.key_data(keys)).astype(np.int64)


def test_jax_runs_the_default_threefry_scheme():
    assert jax.config.jax_threefry_partitionable
    assert not jax.config.jax_high_dynamic_range_gumbel  # gumbel "low"
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_threefry_2x32_matches_jax(n):
    for seed in (0, 42, 2**32 - 1):
        k = jax.random.key_data(jax.random.key(np.uint32(seed)))
        count = (np.arange(n, dtype=np.uint64) * 2654435761
                 % 2**32).astype(np.uint32)
        want = np.asarray(jprng.threefry_2x32(k, jnp.asarray(count)))
        got = prng.threefry_2x32(
            torch.from_numpy(np.asarray(k).astype(np.int64)),
            torch.from_numpy(count.astype(np.int64)))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_key_and_fold_in_match_jax():
    s, _ = _grid()
    want = _data(jax.vmap(jax.random.key)(jnp.asarray(s)))
    got = prng.key(torch.from_numpy(s.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_torch_keys().numpy(), _data(_jax_keys()))


def test_split_matches_jax():
    want = np.asarray(jax.vmap(lambda k: jax.random.key_data(
        jax.random.split(k, 5)))(_jax_keys())).astype(np.int64)
    got = prng.split(_torch_keys(), 5)
    np.testing.assert_array_equal(got.numpy(), want)


def test_random_bits_and_uniform_match_jax():
    jk, tk = _jax_keys(), _torch_keys()
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (V,), jnp.uint32))(jk))
    np.testing.assert_array_equal(prng.random_bits(tk, (V,)).numpy(),
                                  want.astype(np.int64))
    want = np.asarray(jax.vmap(
        lambda k: jax.random.bits(k, (3, 5), jnp.uint32))(jk))
    np.testing.assert_array_equal(prng.random_bits(tk, (3, 5)).numpy(),
                                  want.astype(np.int64))
    for lo, hi in ((0.0, 1.0), (float(np.finfo(np.float32).tiny), 1.0)):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (V,), jnp.float32, lo, hi))(jk))
        got = prng.uniform(tk, (V,), lo, hi).numpy()
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    # Another range: XLA fuses the scale and shift into one multiply-add,
    # rounded once, where the port rounds the product first.
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (V,), jnp.float32, -2.0, 3.0))(jk))
    got = prng.uniform(tk, (V,), -2.0, 3.0).numpy()
    assert np.abs(got - want).max() <= np.spacing(np.float32(5.0))


def _ulps(got, want):
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


def _noise_close(got, want):
    """Within two f32 ulps at the noise's scale, max(|g|, 1)."""
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    return np.abs(got - want) <= 2 * scale


def test_gumbel_logs_within_one_ulp_of_jax():
    u = prng.uniform(_torch_keys(), (V,), prng.F32_TINY, 1.0).numpy()
    inner = np.asarray(jnp.log(jnp.asarray(u)))
    assert _ulps(torch.log(torch.from_numpy(u)).numpy(), inner).max() <= 1
    outer = np.asarray(jnp.log(jnp.asarray(-inner)))
    assert _ulps(torch.log(torch.from_numpy(-inner)).numpy(),
                 outer).max() <= 1
    want = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (V,), jnp.float32))(_jax_keys()))
    np.testing.assert_array_equal(-outer, want)  # JAX's gumbel is that
    got = prng.gumbel(_torch_keys(), (V,)).numpy()
    assert np.isfinite(got).all()
    assert _noise_close(got, want).all()
    assert (got == want).mean() > 0.5  # most values are the very bits


def test_engine_noise_is_jax_noise():
    s, p = _grid()
    want = np.asarray(jax.vmap(lambda a, b: jax.random.gumbel(
        jax.random.fold_in(jax.random.key(a), b), (V,), jnp.float32))(
            jnp.asarray(s), jnp.asarray(p)))
    got = tsm.gumbel_noise(torch.from_numpy(s.astype(np.int64)),
                           torch.from_numpy(p), V).numpy()
    assert _noise_close(got, want).all()


def test_sample_per_row_gives_jax_tokens():
    """The engine's sampler against JAX's ``sample_per_row`` under the
    same (seed, position) keys: equal tokens, except where the top-2 gap
    of the scaled logits plus noise is below an ulp's reach."""
    s, p = _grid()
    rng = np.random.default_rng(0)
    n = len(s)
    logits = jnp.asarray(rng.standard_normal((n, V)) * 3, jnp.float32)
    temps = jnp.asarray(rng.choice([0.0, 0.5, 1.0, 1.5], n), jnp.float32)
    top_k = jnp.asarray(rng.choice([0, 0, 5, 50], n), jnp.int32)
    top_p = jnp.asarray(rng.choice([1.0, 1.0, 0.9], n), jnp.float32)
    keys = jax.vmap(lambda a, b: jax.random.fold_in(jax.random.key(a), b))(
        jnp.asarray(s), jnp.asarray(p))
    want = np.asarray(jsm.sample_per_row(logits, keys, temps, top_k, top_p))
    got = tsm.sample_per_row(
        to_torch(logits), torch.from_numpy(s.astype(np.int64)),
        torch.from_numpy(p), to_torch(temps), to_torch(top_k),
        to_torch(top_p)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kernel", ["masked", "sparse", "pallas"])
def test_sampled_engine_streams_match_jax_engine(kernel):
    cfg, tcfg = PRESETS["tiny"], TPRESETS["tiny"]
    jp, tp = params_pair(cfg, seed=0)
    prompts = engine_prompts(cfg)
    knobs = dict(temperature=0.8, top_k=20, max_new_tokens=6)
    want = run_jax_engine(jp, cfg, prompts, knobs)
    got, _ = run_torch_engine(tp, tcfg, prompts, knobs, kernel)
    assert all(len(s) == 6 for s in want)
    assert_streams_match(got, want, jp, cfg, prompts, f"sampled/{kernel}",
                         knobs)
