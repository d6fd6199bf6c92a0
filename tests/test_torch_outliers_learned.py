"""The port's learned outlier detectors (components/outliers_learned.py)
and JAX's normal sampler (models/prng.normal) against the JAX package.

 * ``prng.normal`` against ``jax.random.normal``: the uniform under it
   bit-equal, the normal within NORMAL_ULPS f32 ulps (``torch.erfinv``
   and XLA's ``erf_inv`` round differently; the widest gap seen over 2**20
   draws was 89 ulps, at |z| ~ 3.76 in XLA's coarsest polynomial range);
 * scores within rtol 1e-4 of the JAX detectors' on the JAX detectors'
   own state carried across by ``from_jax_state``;
 * isolation-forest arrays bit-equal from the same seed;
 * ``fit(seed)``: initial parameters within NORMAL_ULPS of JAX's, one
   Adam step within FIRST_STEP_ATOL of JAX's (optax and torch round the
   update differently), and after the JAX tests' epochs outlier verdicts
   equal to JAX's, any difference printed beside its score gap;
 * the 7 cases of tests/test_outliers_learned.py twinned: separation,
   MODEL/TRANSFORMER duality, pickling, the multivariate shape."""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seldon_tpu.components import outliers_learned as J
from seldon_tpu_torch.components import (IsolationForestDetector,
                                         Seq2SeqLSTMDetector, VAEDetector)
from seldon_tpu_torch.components import outliers_learned as P
from seldon_tpu_torch.models import prng
from torch_port_helpers import one_intra_op_thread  # noqa: F401 (autouse)

CPU = "cpu"
NORMAL_ULPS = 128
FIRST_STEP_ATOL = 2e-6
SCORE_RTOL = 1e-4


def ulps(a, b) -> np.ndarray:
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


def jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def port_leaves(tree):
    """The port's parameter tree in jax.tree.leaves' order (sorted keys)."""
    return jax_leaves(P._tree_map(
        lambda t: t.detach().cpu().numpy() if isinstance(t, torch.Tensor)
        else np.asarray(t), tree))


@pytest.fixture(scope="module")
def tabular_data():
    rng = np.random.default_rng(0)
    inliers = rng.normal(0.0, 1.0, size=(512, 8)).astype(np.float32)
    outliers = rng.normal(6.0, 1.0, size=(16, 8)).astype(np.float32)
    return inliers, outliers


@pytest.fixture(scope="module")
def sequence_data():
    rng = np.random.default_rng(0)
    t = np.linspace(0, 4 * np.pi, 32)
    phases = rng.uniform(0, 2 * np.pi, size=(256, 1))
    inliers = np.sin(t[None, :] + phases) + rng.normal(
        0, 0.05, size=(256, 32)
    )
    outliers = rng.normal(0, 1.2, size=(8, 32))
    return inliers.astype(np.float32), outliers.astype(np.float32)


# ---------------------------------------------------------------------------
# JAX's normal sampler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,shape", [(0, (8,)), (1, (41, 20)),
                                        (7, (3, 64, 2)), (12345, (4096,))])
def test_normal_matches_jax(seed, shape):
    k = jax.random.key(seed)
    kp = prng.key(torch.tensor(seed))
    lo = np.nextafter(np.float32(-1), np.float32(0))
    assert np.float32(prng._NORMAL_LO) == lo
    want_u = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, 1.0))
    got_u = prng.uniform(kp, shape, prng._NORMAL_LO, 1.0).numpy()
    assert np.array_equal(got_u.view(np.int32), want_u.view(np.int32))
    want = np.asarray(jax.random.normal(k, shape, jnp.float32))
    got = prng.normal(kp, shape).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert ulps(got, want).max() <= NORMAL_ULPS
    # On split keys, as the detectors draw them.
    jk = jax.random.split(k, 64)[5]
    pk = prng.split(kp, 64)[5]
    assert ulps(prng.normal(pk, shape).numpy(),
                np.asarray(jax.random.normal(jk, shape))).max() <= NORMAL_ULPS


# ---------------------------------------------------------------------------
# Fitted on JAX, scored by the port
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_vae(tabular_data):
    return J.VAEDetector(latent_dim=2, seed=0).fit(
        tabular_data[0], epochs=30, batch_size=128)


@pytest.fixture(scope="module")
def fitted_vae(tabular_data):
    return VAEDetector(latent_dim=2, seed=0, device=CPU).fit(
        tabular_data[0], epochs=30, batch_size=128)


@pytest.fixture(scope="module")
def jax_lstm(sequence_data):
    det = J.Seq2SeqLSTMDetector(hidden_dim=24, seed=0)
    return det.fit(sequence_data[0], epochs=40, batch_size=64)


@pytest.fixture(scope="module")
def fitted_lstm(sequence_data):
    det = Seq2SeqLSTMDetector(hidden_dim=24, seed=0, device=CPU)
    return det.fit(sequence_data[0], epochs=40, batch_size=64)


def test_vae_scores_from_jax_state(tabular_data, jax_vae):
    inliers, outliers = tabular_data
    X = np.vstack([inliers[:64], outliers])
    det = VAEDetector.from_jax_state(jax_vae.__getstate__(), device=CPU)
    assert (det.latent_dim, det.n_mc, det.seed) == (2, 8, 0)
    np.testing.assert_allclose(det.predict(X, []), jax_vae.predict(X, []),
                               rtol=SCORE_RTOL)


def test_lstm_scores_from_jax_state(sequence_data, jax_lstm):
    X = np.vstack([sequence_data[0][:32], sequence_data[1]])
    det = Seq2SeqLSTMDetector.from_jax_state(jax_lstm.__getstate__(),
                                             device=CPU)
    np.testing.assert_allclose(det.predict(X, []), jax_lstm.predict(X, []),
                               rtol=SCORE_RTOL)
    # [B, T, F] input too.
    Y = X[..., None].repeat(1, axis=-1)
    np.testing.assert_allclose(det.predict(Y, []), jax_lstm.predict(Y, []),
                               rtol=SCORE_RTOL)


@pytest.mark.parametrize("seed,n_trees,sub", [(0, 100, 256), (1, 50, 256),
                                              (3, 20, 64)])
def test_forest_arrays_bit_equal_and_scores(tabular_data, seed, n_trees,
                                            sub):
    inliers, outliers = tabular_data
    ref = J.IsolationForestDetector(n_trees=n_trees, sub_sample=sub,
                                    seed=seed).fit(inliers)
    det = IsolationForestDetector(n_trees=n_trees, sub_sample=sub,
                                  seed=seed, device=CPU).fit(inliers)
    for a, b in zip(det.arrays, ref.arrays):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert (det.max_depth, det._cn) == (ref.max_depth, ref._cn)
    X = np.vstack([inliers[:64], outliers])
    want = ref.predict(X, [])
    np.testing.assert_allclose(det.predict(X, []), want, rtol=SCORE_RTOL)
    carried = IsolationForestDetector.from_jax_state(ref.__getstate__(),
                                                     device=CPU)
    np.testing.assert_allclose(carried.predict(X, []), want,
                               rtol=SCORE_RTOL)


# ---------------------------------------------------------------------------
# fit(seed) against JAX's fit
# ---------------------------------------------------------------------------


def test_initial_params_match_jax():
    # VAE: key, pkey = split(key(seed)); the 64 per-layer keys of pkey.
    for seed, f in ((0, 8), (3, 41)):
        vae = VAEDetector(latent_dim=2, seed=seed, device=CPU)
        _, pkey = prng.split(prng.key(torch.tensor(seed)))
        _, jpkey = jax.random.split(jax.random.key(seed))
        got = port_leaves(vae._init_params(pkey, f))
        want = jax_leaves(J.VAEDetector(latent_dim=2, seed=seed)
                          ._init_params(jpkey, f))
        assert [g.shape for g in got] == [w.shape for w in want]
        assert max(ulps(g, w).max() for g, w in zip(got, want)) \
            <= NORMAL_ULPS
    lstm = Seq2SeqLSTMDetector(hidden_dim=24, seed=0, device=CPU)
    got = port_leaves(lstm._init_params(prng.key(torch.tensor(0)), 3))
    want = jax_leaves(J.Seq2SeqLSTMDetector(hidden_dim=24, seed=0)
                      ._init_params(jax.random.key(0), 3))
    assert max(ulps(g, w).max() for g, w in zip(got, want)) <= NORMAL_ULPS


def test_first_adam_step_matches_jax(tabular_data, sequence_data):
    """One epoch of one full batch: the initial parameters plus one Adam
    update (the VAE's with its reparameterisation noise)."""
    X = tabular_data[0][:128]
    got = VAEDetector(latent_dim=2, seed=0, device=CPU).fit(
        X, epochs=1, batch_size=128).params
    want = J.VAEDetector(latent_dim=2, seed=0).fit(
        X, epochs=1, batch_size=128).params
    for g, w in zip(jax_leaves(got), jax_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=FIRST_STEP_ATOL)
    S = sequence_data[0][:64]
    got = Seq2SeqLSTMDetector(hidden_dim=8, seed=0, device=CPU).fit(
        S, epochs=1, batch_size=64).params
    want = J.Seq2SeqLSTMDetector(hidden_dim=8, seed=0).fit(
        S, epochs=1, batch_size=64).params
    for g, w in zip(jax_leaves(got), jax_leaves(want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=FIRST_STEP_ATOL)


def _verdict_diffs(name, got, want, thr):
    """Rows whose verdict differs, printed beside their score gaps."""
    diff = np.flatnonzero((got > thr) != (want > thr))
    for i in diff:
        print(f"{name}: row {i} port {got[i]:.6g} jax {want[i]:.6g} "
              f"threshold {thr:.6g}")
    return diff


def test_fitted_verdicts_match_jax(tabular_data, sequence_data, jax_vae,
                                   fitted_vae, jax_lstm, fitted_lstm):
    inliers, outliers = tabular_data
    X = np.vstack([inliers, outliers])
    want, got = jax_vae.predict(X, []), fitted_vae.predict(X, [])
    thr = float(want[:64].max() * 1.5)
    for i in _verdict_diffs("vae", got, want, thr):
        assert abs(want[i] - thr) <= 1e-3 * thr
    np.testing.assert_allclose(got, want, rtol=1e-3)
    S = np.vstack(sequence_data)
    want, got = jax_lstm.predict(S, []), fitted_lstm.predict(S, [])
    thr = float(want[:32].max() * 1.5)
    for i in _verdict_diffs("lstm", got, want, thr):
        assert abs(want[i] - thr) <= 1e-3 * thr
    np.testing.assert_allclose(got, want, rtol=1e-3)


# ---------------------------------------------------------------------------
# The JAX package's cases, on the port
# ---------------------------------------------------------------------------


def test_vae_separates_outliers(tabular_data, fitted_vae):
    inliers, outliers = tabular_data
    s_in = fitted_vae.predict(inliers[:64], [])
    s_out = fitted_vae.predict(outliers, [])
    assert s_out.min() > s_in.mean() * 2, (s_in.mean(), s_out.min())


def test_vae_transformer_dual(tabular_data, fitted_vae):
    inliers, outliers = tabular_data
    det = pickle.loads(pickle.dumps(fitted_vae))  # keep the fixture's
    det.threshold = float(det.predict(inliers[:64], []).max() * 1.5)
    out = det.transform_input(outliers[:4], [])
    np.testing.assert_array_equal(out, outliers[:4])  # pass-through
    assert det.tags()["outlier"] is True
    assert det.tags()["outlier_count"] == 4
    keys = {m["key"] for m in det.metrics()}
    assert "outlier_score_max" in keys
    det.transform_input(inliers[:4], [])
    assert det.tags()["outlier"] is False


def test_vae_pickle_roundtrip(tabular_data, fitted_vae):
    _, outliers = tabular_data
    blob = pickle.dumps(fitted_vae)
    restored = pickle.loads(blob)
    assert restored._params_dev is None
    assert all(isinstance(x, np.ndarray)
               for x in jax.tree.leaves(restored.params))
    np.testing.assert_allclose(
        restored.predict(outliers, []), fitted_vae.predict(outliers, []),
        rtol=1e-5,
    )


def test_iforest_separates_outliers(tabular_data):
    inliers, outliers = tabular_data
    det = IsolationForestDetector(n_trees=100, seed=0,
                                  device=CPU).fit(inliers)
    s_in = det.predict(inliers[:64], [])
    s_out = det.predict(outliers, [])
    assert s_out.mean() > s_in.mean() + 0.1, (s_in.mean(), s_out.mean())
    assert 0.0 < s_in.min() and s_out.max() <= 1.0
    assert np.median(s_out) > 0.55


def test_iforest_pickle_and_dual(tabular_data):
    inliers, outliers = tabular_data
    det = IsolationForestDetector(n_trees=50, seed=1, threshold=0.55,
                                  device=CPU)
    det.fit(inliers)
    restored = pickle.loads(pickle.dumps(det))
    np.testing.assert_allclose(
        restored.predict(outliers, []), det.predict(outliers, []), rtol=1e-6
    )
    restored.transform_input(outliers[:3], [])
    assert restored.tags()["outlier"] is True


def test_seq2seq_separates_anomalous_sequences(sequence_data, fitted_lstm):
    inliers, outliers = sequence_data
    det = pickle.loads(pickle.dumps(fitted_lstm))
    s_in = det.predict(inliers[:32], [])
    s_out = det.predict(outliers, [])
    assert s_out.mean() > 2 * s_in.mean(), (s_in.mean(), s_out.mean())
    det.threshold = float(s_in.max() * 1.5)
    restored = pickle.loads(pickle.dumps(det))
    restored.transform_input(outliers[:2], [])
    assert restored.tags()["outlier"] is True
    np.testing.assert_allclose(
        restored.predict(outliers, []), s_out, rtol=1e-5
    )


def test_seq2seq_multivariate_shape():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(32, 10, 3)).astype(np.float32)
    det = Seq2SeqLSTMDetector(hidden_dim=8, seed=0, device=CPU)
    det.fit(X, epochs=2, batch_size=16)
    assert det.predict(X[:5], []).shape == (5,)
    with pytest.raises(ValueError):
        det.predict(np.zeros((2, 2, 2, 2), np.float32), [])
    ref = J.Seq2SeqLSTMDetector(hidden_dim=8, seed=0).fit(X, epochs=2,
                                                          batch_size=16)
    np.testing.assert_allclose(det.predict(X[:5], []), ref.predict(X[:5], []),
                               rtol=1e-3)
