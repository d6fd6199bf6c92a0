"""Learned outlier detectors: VAE, Isolation Forest, Seq2Seq-LSTM — port
of ``seldon_tpu/components/outliers_learned.py``.

Reference families: components/outlier-detection/vae/CoreVAE.py:80-92
(keras MLP-VAE, score = reconstruction MSE), CoreIsolationForest.py:36-48
(sklearn wrapper, score = -decision_function), and
seq2seq-lstm/CoreSeq2SeqLSTM.py:81-93 (keras LSTM encoder-decoder, score
= per-feature reconstruction error).

 * VAE and Seq2Seq are small functional torch models on the detector's
   device. ``fit`` trains with ``torch.autograd`` and ``torch.optim.Adam``
   at optax ``adam``'s settings (b1 0.9, b2 0.999, eps 1e-8), in the JAX
   detectors' batch order (``np.random.default_rng(seed)``), with their
   initial parameters and noise drawn from the same threefry keys
   (``models/prng.py``: ``normal`` is JAX's sampler). Scoring is one
   batched forward on the device.
 * The isolation forest is built on the host with numpy, draw for draw
   the JAX detector's (its arrays are bit-equal for a seed), uploaded
   once and scored on the device by the traversal of ``ops/trees.py``
   (``DeviceTrees``): ``[batch, n_trees]`` cursors, ``max_depth + 1``
   rounds.
 * All three share the MODEL/TRANSFORMER duality + thread-local verdict
   plumbing of components/outliers.py and pickle with their state as
   numpy. ``from_jax_state`` builds a port detector from the JAX
   detector's numpy state (its pickled ``__dict__``).
"""

from __future__ import annotations

import math
import threading
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch

from seldon_tpu_torch.components.outliers import _TagMetricsMixin
from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.models import prng
from seldon_tpu_torch.ops import trees


def _tree_map(fn: Callable[[Any], Any], tree):
    """Apply fn to every array leaf of a dict / list parameter tree."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_leaves(tree) -> List[torch.Tensor]:
    out: List[torch.Tensor] = []
    _tree_map(out.append, tree)
    return out


def _to_numpy(tree):
    return _tree_map(lambda x: x.detach().cpu().numpy(), tree)


def _to_device(tree, dev: torch.device):
    return _tree_map(lambda x: torch.as_tensor(
        np.asarray(x, np.float32), device=dev), tree)


def _adam(leaves: List[torch.Tensor], lr: float) -> torch.optim.Adam:
    """optax.adam(lr)'s settings."""
    return torch.optim.Adam(leaves, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def _key(seed: int, dev: torch.device) -> torch.Tensor:
    return prng.key(torch.tensor(seed, device=dev))


class _DeviceDetector(_TagMetricsMixin):
    """Shared device and pickling plumbing: ``params`` is the numpy
    state, ``_params_dev`` its device copy, uploaded once."""

    _STATE: Sequence[str] = ()

    def _dev_params(self):
        if self._params_dev is None:
            # Device-resident params, uploaded once — a per-request upload
            # of the whole model would dominate serving latency.
            self._params_dev = _to_device(self.params, self.device)
        return self._params_dev

    @classmethod
    def from_jax_state(cls, d: Dict[str, Any], device: DeviceLike = None):
        """A port detector from the JAX detector's numpy state (its
        ``__getstate__()``): the constructor fields and the fitted
        arrays, copied."""
        det = cls(device=device, **{k: d[k] for k in cls._FIELDS})
        for k in cls._STATE:
            v = d[k]
            if isinstance(v, (dict, list, tuple, np.ndarray)):
                v = _tree_map(np.array, v)
            setattr(det, k, v)
        return det

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_tls_obj", None)
        d.pop("_params_dev", None)  # device buffers: the numpy state stays
        d.pop("_arrays_dev", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._tls_obj = threading.local()
        self._params_dev = None
        self._arrays_dev = None


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------


class VAEDetector(_DeviceDetector):
    """MLP variational autoencoder; outlier score = reconstruction MSE in
    standardized feature space, averaged over `n_mc` posterior samples
    (reference CoreVAE._get_preds semantics)."""

    _FIELDS = ("threshold", "latent_dim", "hidden_dims", "n_mc", "seed")
    _STATE = ("params", "mu_", "sigma_")

    def __init__(self, threshold: float = 10.0, latent_dim: int = 2,
                 hidden_dims: Sequence[int] = (), n_mc: int = 8,
                 seed: int = 0, device: DeviceLike = None):
        self.threshold = float(threshold)
        self.latent_dim = int(latent_dim)
        self.hidden_dims = tuple(int(h) for h in hidden_dims)
        self.n_mc = int(n_mc)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.params = None  # numpy tree after fit()
        self.mu_ = None  # feature standardization
        self.sigma_ = None
        self._tls_obj = threading.local()
        self._params_dev = None
        self._arrays_dev = None

    # -- model ---------------------------------------------------------------

    def _dims(self, n_features: int) -> List[int]:
        if self.hidden_dims:
            return list(self.hidden_dims)
        # Reference default: halve until just above latent dim.
        dims, d = [], n_features
        while d // 2 > self.latent_dim:
            d = d // 2
            dims.append(max(d, self.latent_dim + 1))
            if len(dims) >= 2:
                break
        return dims or [max(n_features // 2, self.latent_dim + 1)]

    def _init_params(self, key: torch.Tensor, n_features: int):
        """JAX's initial parameters: the same 64 split keys, one per
        layer in the same order, normals scaled by sqrt(2 / fan-in)."""
        dims = self._dims(n_features)
        enc_sizes = [n_features] + dims
        dec_sizes = [self.latent_dim] + dims[::-1] + [n_features]
        keys = iter(prng.split(key, 64))

        def dense(key, din, dout):
            scale = (2.0 / din) ** 0.5
            return {
                "w": prng.normal(key, (din, dout)) * scale,
                "b": torch.zeros((dout,), device=key.device),
            }

        return {
            "enc": [dense(next(keys), a, b)
                    for a, b in zip(enc_sizes[:-1], enc_sizes[1:])],
            "mean": dense(next(keys), enc_sizes[-1], self.latent_dim),
            "logvar": dense(next(keys), enc_sizes[-1], self.latent_dim),
            "dec": [dense(next(keys), a, b)
                    for a, b in zip(dec_sizes[:-1], dec_sizes[1:])],
        }

    @staticmethod
    def _apply(params, X: torch.Tensor, key: torch.Tensor,
               n_samples: int = 1):
        """-> (recon [n_samples,B,F], z_mean, z_logvar)."""
        h = X
        for lyr in params["enc"]:
            h = torch.tanh(h @ lyr["w"] + lyr["b"])
        z_mean = h @ params["mean"]["w"] + params["mean"]["b"]
        z_logvar = h @ params["logvar"]["w"] + params["logvar"]["b"]
        eps = prng.normal(key, (n_samples,) + tuple(z_mean.shape))
        z = z_mean[None] + torch.exp(0.5 * z_logvar)[None] * eps
        h = z
        for lyr in params["dec"][:-1]:
            h = torch.tanh(h @ lyr["w"] + lyr["b"])
        out = h @ params["dec"][-1]["w"] + params["dec"][-1]["b"]
        return out, z_mean, z_logvar

    # -- training ------------------------------------------------------------

    def fit(self, X: np.ndarray, epochs: int = 40, batch_size: int = 128,
            lr: float = 1e-3, kl_weight: float = 1.0) -> "VAEDetector":
        X = np.asarray(X, np.float32)
        self.mu_ = X.mean(axis=0)
        self.sigma_ = X.std(axis=0) + 1e-8
        Xs = (X - self.mu_) / self.sigma_
        n, f = Xs.shape
        dev = self.device
        key, pkey = prng.split(_key(self.seed, dev))
        params = self._init_params(pkey, f)
        leaves = _tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = _adam(leaves, lr)

        def loss_fn(p, xb, k):
            recon, z_mean, z_logvar = self._apply(p, xb, k, 1)
            mse = torch.mean((recon[0] - xb) ** 2)
            kl = -0.5 * torch.mean(
                1 + z_logvar - z_mean**2 - torch.exp(z_logvar)
            )
            return mse + kl_weight * kl / f

        bs = min(batch_size, n)
        rng = np.random.default_rng(self.seed)
        xd = torch.from_numpy(Xs).to(dev)
        for _ in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(dev)
            for i in range(0, n - bs + 1, bs):
                key, sk = prng.split(key)
                opt.zero_grad(set_to_none=True)
                loss_fn(params, xd[order[i: i + bs]], sk).backward()
                opt.step()
        params = _tree_map(lambda p: p.detach(), params)
        self.params = _to_numpy(params)
        self._params_dev = params  # already device-resident
        return self

    # -- scoring -------------------------------------------------------------

    def _scores(self, X: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("VAEDetector.fit() (or load) required first")
        Xs = (np.asarray(X, np.float32) - self.mu_) / self.sigma_
        params = self._dev_params()
        xb = torch.from_numpy(np.ascontiguousarray(Xs, np.float32)).to(
            self.device)
        with torch.no_grad():
            recon, _, _ = VAEDetector._apply(
                params, xb, _key(self.seed, self.device), self.n_mc)
            score = torch.mean((recon - xb[None]) ** 2, dim=(0, 2))
        return score.cpu().numpy()

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None) -> np.ndarray:
        s = self._scores(np.atleast_2d(np.asarray(X, np.float32)))
        self._last_scores = s
        return s


# ---------------------------------------------------------------------------
# Isolation forest
# ---------------------------------------------------------------------------


def _c(n: float) -> float:
    """Average unsuccessful-search path length in a BST of n nodes."""
    if n <= 1:
        return 0.0
    return 2.0 * (math.log(n - 1) + 0.5772156649) - 2.0 * (n - 1) / n


class IsolationForestDetector(_DeviceDetector):
    """Isolation forest: host-built random trees, device-scored traversal.

    Score = 2^(-E[h(x)]/c(sub_sample)) in [0,1]; higher = more anomalous
    (the reference's sklearn wrapper exposes -decision_function, a shifted
    version of the same quantity)."""

    _FIELDS = ("threshold", "n_trees", "sub_sample", "seed")
    _STATE = ("arrays", "max_depth", "_cn")

    def __init__(self, threshold: float = 0.6, n_trees: int = 100,
                 sub_sample: int = 256, seed: int = 0,
                 device: DeviceLike = None):
        self.threshold = float(threshold)
        self.n_trees = int(n_trees)
        self.sub_sample = int(sub_sample)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.arrays = None  # (feature, thresh, left, right, pathlen) flat
        self.max_depth = 0
        self._tls_obj = threading.local()
        self._params_dev = None
        self._arrays_dev = None

    def fit(self, X: np.ndarray) -> "IsolationForestDetector":
        X = np.asarray(X, np.float32)
        n = X.shape[0]
        psi = min(self.sub_sample, n)
        depth_cap = max(1, int(math.ceil(math.log2(max(psi, 2)))))
        rng = np.random.default_rng(self.seed)
        trees = []

        def build(rows: np.ndarray, depth: int, nodes: list) -> int:
            nid = len(nodes)
            nodes.append(None)
            if depth >= depth_cap or len(rows) <= 1:
                # Leaf: isolation path length = depth + c(|rows|) correction.
                nodes[nid] = (-1, 0.0, nid, nid, depth + _c(len(rows)))
                return nid
            f = int(rng.integers(0, X.shape[1]))
            lo, hi = X[rows, f].min(), X[rows, f].max()
            if lo == hi:
                nodes[nid] = (-1, 0.0, nid, nid, depth + _c(len(rows)))
                return nid
            thr = float(rng.uniform(lo, hi))
            lrows = rows[X[rows, f] < thr]
            rrows = rows[X[rows, f] >= thr]
            li = build(lrows, depth + 1, nodes)
            ri = build(rrows, depth + 1, nodes)
            nodes[nid] = (f, thr, li, ri, 0.0)
            return nid

        for _ in range(self.n_trees):
            rows = rng.choice(n, size=psi, replace=False)
            nodes: list = []
            build(rows, 0, nodes)
            trees.append(nodes)

        max_nodes = max(len(t) for t in trees)
        T = len(trees)
        feature = np.full((T, max_nodes), -1, np.int32)
        thresh = np.zeros((T, max_nodes), np.float32)
        left = np.zeros((T, max_nodes), np.int32)
        right = np.zeros((T, max_nodes), np.int32)
        pathlen = np.zeros((T, max_nodes), np.float32)
        for i, t in enumerate(trees):
            for j, (f, th, l, r, pl) in enumerate(t):
                feature[i, j] = f
                thresh[i, j] = th
                left[i, j] = l
                right[i, j] = r
                pathlen[i, j] = pl
        self.arrays = (feature, thresh, left, right, pathlen)
        self.max_depth = depth_cap
        self._cn = _c(psi)
        self._arrays_dev = None  # refit invalidates the device copy
        return self

    def _scores(self, X: np.ndarray) -> np.ndarray:
        if self.arrays is None:
            raise RuntimeError("IsolationForestDetector.fit() required first")
        if self._arrays_dev is None:
            # One-time host->device upload of the forest, walked by the
            # traversal of ops/trees.py: ``max_depth + 1`` rounds, leaves
            # valued by their path length; a NaN feature goes right
            # (``missing`` = ``right``), as ``x < thr`` sends it.
            feature, thresh, left, right, pathlen = self.arrays
            self._arrays_dev = trees.DeviceTrees(trees.TreeEnsemble(
                feature, thresh, left, right, pathlen, right,
                max_depth=self.max_depth + 1), self.device)
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
            self.device)
        mean_path = self._arrays_dev.leaf_values(Xd).mean(dim=1)
        return (2.0 ** (-mean_path / max(self._cn, 1e-9))).cpu().numpy()

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None) -> np.ndarray:
        s = self._scores(np.atleast_2d(np.asarray(X, np.float32)))
        self._last_scores = s
        return s


# ---------------------------------------------------------------------------
# Seq2Seq LSTM
# ---------------------------------------------------------------------------


class Seq2SeqLSTMDetector(_DeviceDetector):
    """LSTM encoder-decoder; outlier score = per-sequence reconstruction
    MSE in standardized space. Input [B, T, F] (or [B, T] for univariate).

    The LSTM cell is written out as in the JAX detector (one product,
    split into i, f, g, o), not ``nn.LSTM``, whose bias layout and cuDNN
    route differ; the time loop runs on the host."""

    _FIELDS = ("threshold", "hidden_dim", "seed")
    _STATE = ("params", "mu_", "sigma_")

    def __init__(self, threshold: float = 0.3, hidden_dim: int = 32,
                 seed: int = 0, device: DeviceLike = None):
        self.threshold = float(threshold)
        self.hidden_dim = int(hidden_dim)
        self.seed = int(seed)
        self.device = resolve_device(device)
        self.params = None
        self.mu_ = None
        self.sigma_ = None
        self._tls_obj = threading.local()
        self._params_dev = None
        self._arrays_dev = None

    # -- model ---------------------------------------------------------------

    def _init_params(self, key: torch.Tensor, n_features: int):
        H, F = self.hidden_dim, n_features
        k = iter(prng.split(key, 8))

        def mat(key, din, dout):
            return prng.normal(key, (din, dout)) * (1.0 / max(din, 1)) ** 0.5

        def lstm(key):
            k1, k2 = prng.split(key)
            return {
                "wx": mat(k1, F, 4 * H),
                "wh": mat(k2, H, 4 * H),
                "b": torch.zeros((4 * H,), device=key.device),
            }

        return {
            "enc": lstm(next(k)),
            "dec": lstm(next(k)),
            "out": {"w": mat(next(k), H, F),
                    "b": torch.zeros((F,), device=key.device)},
        }

    @staticmethod
    def _cell(p, x, h, c):
        gates = x @ p["wx"] + h @ p["wh"] + p["b"]
        i, f, g, o = torch.chunk(gates, 4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        h = torch.sigmoid(o) * torch.tanh(c)
        return h, c

    @classmethod
    def _recon(cls, params, X: torch.Tensor) -> torch.Tensor:
        """X [B,T,F] -> reconstruction [B,T,F]."""
        B, T, F = X.shape
        H = params["enc"]["wh"].shape[0]
        h = c = torch.zeros((B, H), dtype=X.dtype, device=X.device)
        for t in range(T):
            h, c = cls._cell(params["enc"], X[:, t], h, c)
        # Teacher-forced on the (shifted) input, like the reference decoder.
        dec_in = torch.cat([torch.zeros_like(X[:, :1]), X[:, :-1]], 1)
        ys = []
        for t in range(T):
            h, c = cls._cell(params["dec"], dec_in[:, t], h, c)
            ys.append(h @ params["out"]["w"] + params["out"]["b"])
        return torch.stack(ys, dim=1)

    # -- training ------------------------------------------------------------

    def fit(self, X: np.ndarray, epochs: int = 60, batch_size: int = 64,
            lr: float = 1e-2) -> "Seq2SeqLSTMDetector":
        X = self._shape(X)
        self.mu_ = X.mean(axis=(0, 1))
        self.sigma_ = X.std(axis=(0, 1)) + 1e-8
        Xs = (X - self.mu_) / self.sigma_
        n = Xs.shape[0]
        dev = self.device
        params = self._init_params(_key(self.seed, dev), Xs.shape[2])
        leaves = _tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        opt = _adam(leaves, lr)

        bs = min(batch_size, n)
        rng = np.random.default_rng(self.seed)
        xd = torch.from_numpy(np.ascontiguousarray(Xs)).to(dev)
        for _ in range(epochs):
            order = torch.from_numpy(rng.permutation(n)).to(dev)
            for i in range(0, n - bs + 1, bs):
                xb = xd[order[i: i + bs]]
                opt.zero_grad(set_to_none=True)
                torch.mean((self._recon(params, xb) - xb) ** 2).backward()
                opt.step()
        params = _tree_map(lambda p: p.detach(), params)
        self.params = _to_numpy(params)
        self._params_dev = params  # already device-resident
        return self

    # -- scoring -------------------------------------------------------------

    @staticmethod
    def _shape(X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        if X.ndim == 2:  # [B, T] univariate
            X = X[..., None]
        if X.ndim != 3:
            raise ValueError(f"expected [B,T] or [B,T,F], got {X.shape}")
        return X

    def _scores(self, X: np.ndarray) -> np.ndarray:
        if self.params is None:
            raise RuntimeError("Seq2SeqLSTMDetector.fit() required first")
        Xs = (self._shape(X) - self.mu_) / self.sigma_
        params = self._dev_params()
        xb = torch.from_numpy(np.ascontiguousarray(Xs, np.float32)).to(
            self.device)
        with torch.no_grad():
            score = torch.mean(
                (Seq2SeqLSTMDetector._recon(params, xb) - xb) ** 2,
                dim=(1, 2))
        return score.cpu().numpy()

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None) -> np.ndarray:
        s = self._scores(X)
        self._last_scores = s
        return s
