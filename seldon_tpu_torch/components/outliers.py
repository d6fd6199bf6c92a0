"""Outlier detectors — port of ``seldon_tpu/components/outliers.py``,
numpy only: usable as MODEL (predict -> scores) or TRANSFORMER
(transform_input passes data through, tagging outliers into meta.tags and
scores into custom metrics). The Mahalanobis detector keeps an online
mean and covariance, the z-score detector per-feature running moments.
State is picklable for the persistence layer (runtime/persistence.py)."""

from __future__ import annotations

import threading
from typing import Dict, Iterable, List, Optional

import numpy as np


class _TagMetricsMixin:
    """Shared MODEL/TRANSFORMER duality: predict scores, transform tags.

    The score->tags handoff uses THREAD-LOCAL storage: the unit server runs
    requests on a thread pool, and predict()+tags() for one request execute
    on the same worker thread — instance-global state would let concurrent
    requests read each other's verdicts."""

    threshold: float

    @property
    def _tls(self):
        # _tls_obj is created eagerly in __init__/__setstate__ — lazy
        # creation here would race under the server thread pool.
        return self._tls_obj

    @property
    def _last_scores(self) -> Optional[np.ndarray]:
        return getattr(self._tls, "scores", None)

    @_last_scores.setter
    def _last_scores(self, value) -> None:
        self._tls.scores = value

    def transform_input(self, X: np.ndarray, names: Iterable[str],
                        meta: Optional[Dict] = None):
        self.predict(X, names, meta)  # updates _last_scores / state
        return X  # pass-through; verdict rides on tags/metrics

    def tags(self) -> Dict:
        s = self._last_scores
        if s is None:
            return {}
        return {
            "outlier": bool(np.any(s > self.threshold)),
            "outlier_count": int(np.sum(s > self.threshold)),
        }

    def metrics(self) -> List[Dict]:
        s = self._last_scores
        if s is None:
            return []
        return [
            {"type": "GAUGE", "key": "outlier_score_max",
             "value": float(np.max(s))},
            {"type": "GAUGE", "key": "outlier_score_mean",
             "value": float(np.mean(s))},
            # Exported so dashboards can draw the decision line next to
            # the live score (ref per-detector Grafana configs).
            {"type": "GAUGE", "key": "outlier_threshold",
             "value": float(self.threshold)},
            {"type": "COUNTER", "key": "outliers_total",
             "value": float(np.sum(s > self.threshold))},
        ]


class MahalanobisDetector(_TagMetricsMixin):
    """Online Mahalanobis distance: running mean + covariance (Welford-style
    batch updates), score = sqrt((x-mu)^T Sigma^-1 (x-mu)).

    `start_clip` samples must arrive before scores are reported (the
    reference clips early unstable estimates the same way)."""

    def __init__(self, threshold: float = 3.0, start_clip: int = 20,
                 reg_eps: float = 1e-6):
        self.threshold = float(threshold)
        self.start_clip = int(start_clip)
        self.reg_eps = float(reg_eps)
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.cov_sum: Optional[np.ndarray] = None  # sum of outer deviations
        self._lock = threading.Lock()
        self._tls_obj = threading.local()

    def _update(self, X: np.ndarray) -> None:
        for x in X:
            self.n += 1
            if self.mean is None:
                self.mean = x.astype(np.float64).copy()
                self.cov_sum = np.zeros((x.size, x.size))
                continue
            delta = x - self.mean
            self.mean += delta / self.n
            self.cov_sum += np.outer(delta, x - self.mean)

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        with self._lock:
            if self.n >= max(self.start_clip, 2):
                cov = self.cov_sum / (self.n - 1)
                cov = cov + self.reg_eps * np.eye(cov.shape[0])
                inv = np.linalg.pinv(cov)
                d = X - self.mean
                scores = np.sqrt(np.maximum(
                    np.einsum("bi,ij,bj->b", d, inv, d), 0.0
                ))
            else:
                scores = np.zeros(X.shape[0])
            self._update(X)
            self._last_scores = scores
        return scores

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock", None)
        d.pop("_tls_obj", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()
        self._tls_obj = threading.local()


class ZScoreDetector(_TagMetricsMixin):
    """Per-feature running z-score; score = max |z| over features: a
    lightweight detector with no learned model."""

    def __init__(self, threshold: float = 4.0, start_clip: int = 10):
        self.threshold = float(threshold)
        self.start_clip = int(start_clip)
        self.n = 0
        self.mean: Optional[np.ndarray] = None
        self.m2: Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._tls_obj = threading.local()

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=np.float64))
        with self._lock:
            if self.n >= self.start_clip and self.m2 is not None:
                var = self.m2 / max(self.n - 1, 1)
                std = np.sqrt(np.maximum(var, 1e-12))
                scores = np.max(np.abs((X - self.mean) / std), axis=1)
            else:
                scores = np.zeros(X.shape[0])
            for x in X:
                self.n += 1
                if self.mean is None:
                    self.mean = x.copy()
                    self.m2 = np.zeros_like(x)
                else:
                    delta = x - self.mean
                    self.mean += delta / self.n
                    self.m2 += delta * (x - self.mean)
            self._last_scores = scores
        return scores

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_lock", None)
        d.pop("_tls_obj", None)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._lock = threading.Lock()
        self._tls_obj = threading.local()
