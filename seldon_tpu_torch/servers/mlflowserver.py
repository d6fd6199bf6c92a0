"""MLFlow parity server — port of ``seldon_tpu/servers/mlflowserver.py``,
route for route (reference servers/mlflowserver/mlflowserver/
MLFlowServer.py:12-49: mlflow.pyfunc.load_model, predict via DataFrame).

mlflow is NOT required. The MLmodel descriptor is plain YAML (PyYAML,
imported when a descriptor is read), and the dominant flavor in Seldon
deployments is sklearn — so this server parses MLmodel natively, loads
the pickled sklearn model, and routes linear-family models onto the
device product of SKLearnServer (``sklearnserver.LinearHead``). Anything
else still predicts through the unpickled model's own
predict()/predict_proba(). mlflow.pyfunc is used only as a LAST resort
for exotic flavors, when it happens to be installed.

Supported without mlflow:
  * flavors.sklearn (pickled_model via pickle/joblib/cloudpickle
    serialization_format)
  * flavors.python_function with loader_module mlflow.sklearn (same
    artifact, different descriptor spelling)
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Iterable, Optional

import numpy as np

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.servers.sklearnserver import LinearHead
from seldon_tpu_torch.servers.storage import download

logger = logging.getLogger(__name__)

_LINEAR_ATTRS = ("coef_", "intercept_")
# Estimators whose predict/predict_proba really are a plain (identity-
# link) linear map + softmax/sigmoid — safe for the device fast path.
_LINEAR_FAST_PATH_CLASSES = frozenset({
    "LinearRegression", "Ridge", "RidgeCV", "Lasso", "LassoCV",
    "ElasticNet", "ElasticNetCV", "LogisticRegression",
    "LogisticRegressionCV",
})


def parse_mlmodel(local: str) -> Dict:
    """Parse <dir>/MLmodel (YAML). Returns {} when absent — a bare
    pickled dir still loads via the sklearn fallback below."""
    path = os.path.join(local, "MLmodel")
    if not os.path.exists(path):
        return {}
    import yaml

    with open(path) as f:
        return yaml.safe_load(f) or {}


def _sklearn_pickle_path(local: str, desc: Dict) -> Optional[str]:
    """Locate the pickled sklearn artifact from the flavor descriptors."""
    flavors = desc.get("flavors") or {}
    sk = flavors.get("sklearn") or {}
    rel = sk.get("pickled_model")
    if not rel:
        pf = flavors.get("python_function") or {}
        if pf.get("loader_module") == "mlflow.sklearn":
            rel = pf.get("model_path", "model.pkl")
    if not rel:
        # Bare dir without a descriptor: accept the conventional name.
        if not flavors and os.path.exists(os.path.join(local, "model.pkl")):
            rel = "model.pkl"
        else:
            return None
    path = os.path.join(local, rel)
    return path if os.path.exists(path) else None


def _load_pickle(path: str, serialization_format: str = "pickle"):
    """sklearn models pickle with the stdlib pickle protocol; mlflow's
    'cloudpickle' format is a superset that plain pickle also reads for
    estimator objects. joblib dumps need joblib (ships with sklearn)."""
    if serialization_format == "joblib" or path.endswith(".joblib"):
        import joblib

        return joblib.load(path)
    if serialization_format == "cloudpickle":
        try:
            import cloudpickle

            with open(path, "rb") as f:
                return cloudpickle.load(f)
        except ImportError:
            pass  # plain pickle handles sklearn estimators fine
    import pickle

    with open(path, "rb") as f:
        return pickle.load(f)


class MLFlowServer:
    def __init__(self, model_uri: str = "", method: str = "predict",
                 device: DeviceLike = None):
        self.model_uri = model_uri
        self.method = method
        self.device = resolve_device(device)
        self.model = None  # unpickled estimator (or mlflow pyfunc)
        self._head: Optional[LinearHead] = None  # device linear path
        self._is_pyfunc = False

    def load(self) -> None:
        local = download(self.model_uri)
        desc = parse_mlmodel(local)
        pkl = _sklearn_pickle_path(local, desc)
        if pkl is not None:
            fmt = ((desc.get("flavors") or {}).get("sklearn") or {}).get(
                "serialization_format", "pickle"
            )
            self.model = _load_pickle(pkl, fmt)
            self._maybe_linear_head()
            logger.info("mlflow sklearn flavor loaded natively: %s", pkl)
            return
        # Exotic flavor: only now does mlflow itself become a requirement.
        try:
            import mlflow.pyfunc
        except ImportError as e:
            flavors = sorted((desc.get("flavors") or {}).keys())
            raise RuntimeError(
                f"model at {self.model_uri!r} has flavors {flavors}, none "
                "servable natively (sklearn/python_function[mlflow.sklearn])"
                " and mlflow is not in this image"
            ) from e
        self.model = mlflow.pyfunc.load_model(local)
        self._is_pyfunc = True

    def _maybe_linear_head(self) -> None:
        """Linear-family estimators (LogisticRegression, Ridge, ...)
        become one f32 product (+softmax) on the device — the same path
        SKLearnServer gives npz exports."""
        m = self.model
        if not all(hasattr(m, a) for a in _LINEAR_ATTRS):
            return
        # Identity-link models only: GLMs (Poisson/Tweedie/Gamma) also
        # carry coef_/intercept_ but their predict() applies an inverse
        # link, and OvR-normalized linear classifiers don't softmax —
        # a raw matmul would silently return wrong values for those.
        if m.__class__.__name__ not in _LINEAR_FAST_PATH_CLASSES:
            return
        is_classifier = hasattr(m, "classes_")
        if is_classifier and not hasattr(m, "predict_proba"):
            # Margin-only classifiers (LinearSVC, hinge SGD): the
            # softmax/sigmoid mapping below would be wrong (and argmax
            # over a [B,1] decision column is constant 0) — serve through
            # the estimator's own predict instead.
            return
        self._head = LinearHead(m.coef_, m.intercept_,
                                classifier=is_classifier, device=self.device)

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None):
        if self.model is None:
            self.load()
        X = np.asarray(X)
        if self._head is not None:
            out = self._head.predict_numpy(X.astype(np.float32))
            if self.method == "predict" and hasattr(self.model, "classes_"):
                return np.asarray(self.model.classes_)[
                    np.argmax(out, axis=-1)
                ]
            if out.ndim == 2 and out.shape[1] == 1:
                return out[:, 0]
            return out
        if self._is_pyfunc:
            try:
                import pandas as pd

                df = pd.DataFrame(X, columns=list(names) or None)
                return np.asarray(self.model.predict(df))
            except ImportError:
                return np.asarray(self.model.predict(X))
        # Plain sklearn estimator without a linear fast path. Pipelines
        # with name-based column selection (ColumnTransformer on string
        # columns) need the DataFrame wrapping the reference applied.
        Xin = X
        names = list(names or [])
        if names and len(names) == X.shape[-1]:
            try:
                import pandas as pd

                Xin = pd.DataFrame(X, columns=names)
            except ImportError:
                pass
        if self.method == "predict_proba" and hasattr(
                self.model, "predict_proba"):
            return np.asarray(self.model.predict_proba(Xin))
        return np.asarray(self.model.predict(Xin))

    def tags(self) -> Dict:
        # "backend" names the route that ran (the JAX server has no such
        # tag): the device product, mlflow's pyfunc, or the estimator.
        backend = ("torch" if self._head is not None else
                   "mlflow-pyfunc" if self._is_pyfunc else "sklearn")
        return {"server": "mlflowserver", "backend": backend}
