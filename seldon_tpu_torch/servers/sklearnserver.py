"""SKLearn parity server — port of ``seldon_tpu/servers/sklearnserver.py``
(reference servers/sklearnserver/sklearnserver/SKLearnServer.py:15-44:
joblib-load model.joblib, predict_proba|predict).

Linear-family models export to ``model.npz`` (coef, intercept, classes,
kind) and predict as one f32 product plus sigmoid or softmax on the
device (:class:`LinearHead`, shared with the MLflow server).
``model.joblib`` loads through joblib and sklearn, as in the JAX package,
when they are installed."""

from __future__ import annotations

import os
import threading
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike, resolve_device
from seldon_tpu_torch.servers.storage import download

# Guards the process-wide f32 matmul precision while a head computes.
_PRECISION_LOCK = threading.Lock()


class LinearHead(torch.nn.Module):
    """``X @ coef.T + intercept`` in full f32 on one device, then a
    sigmoid (one logit column: ``[1 - p, p]``) or softmax for a
    classifier, raw outputs otherwise (the JAX servers' jitted ``fwd``).

    The product never runs on TF32 or a reduced-precision CPU route: when
    the process has lowered ``torch.get_float32_matmul_precision()`` the
    call raises it to "highest" for its own product and restores it."""

    def __init__(self, coef, intercept, classifier: bool,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        coef = np.atleast_2d(np.asarray(coef, np.float32))
        self.register_buffer("coef_t", torch.as_tensor(coef.T.copy(),
                                                       device=dev))
        self.register_buffer("intercept", torch.as_tensor(
            np.atleast_1d(np.asarray(intercept, np.float32)), device=dev))
        self.classifier = bool(classifier)

    @property
    def device(self) -> torch.device:
        return self.coef_t.device

    def _product(self, X: torch.Tensor) -> torch.Tensor:
        if torch.get_float32_matmul_precision() == "highest":
            return X @ self.coef_t + self.intercept
        with _PRECISION_LOCK:
            before = torch.get_float32_matmul_precision()
            torch.set_float32_matmul_precision("highest")
            try:
                return X @ self.coef_t + self.intercept
            finally:
                torch.set_float32_matmul_precision(before)

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        logits = self._product(X)
        if not self.classifier:
            return logits
        if logits.shape[-1] == 1:
            p1 = torch.sigmoid(logits[:, 0])
            return torch.stack([1 - p1, p1], dim=1)
        return torch.softmax(logits, dim=-1)

    def predict_numpy(self, X: np.ndarray) -> np.ndarray:
        """Host rows in, host outputs out (one upload, one read-back)."""
        Xd = torch.from_numpy(np.ascontiguousarray(X, np.float32)).to(
            self.device)
        return self(Xd).cpu().numpy()


class SKLearnServer:
    def __init__(self, model_uri: str = "", method: str = "predict_proba",
                 device: DeviceLike = None):
        self.model_uri = model_uri
        self.method = method
        self.device = resolve_device(device)
        self.model = None
        self._params: Optional[Dict[str, np.ndarray]] = None
        self._head: Optional[LinearHead] = None
        self._kind = "logistic"

    def load(self) -> None:
        local = download(self.model_uri)
        npz = os.path.join(local, "model.npz")
        joblib_path = os.path.join(local, "model.joblib")
        if os.path.exists(npz):
            data = np.load(npz, allow_pickle=False)
            self._params = {k: data[k] for k in data.files}
            self._build_head()
        elif os.path.exists(joblib_path):
            try:
                import joblib
            except ImportError as e:
                raise RuntimeError(
                    "model.joblib needs joblib/sklearn (not in this image); "
                    "export the model to model.npz (coef, intercept, classes)"
                ) from e
            self.model = joblib.load(joblib_path)
        else:
            raise FileNotFoundError(
                f"no model.npz or model.joblib under {local}"
            )

    def _build_head(self) -> None:
        kind = str(self._params.get("kind", np.array("logistic")))
        self._kind = kind
        self._head = LinearHead(self._params["coef"],
                                self._params["intercept"],
                                classifier="logistic" in kind,
                                device=self.device)

    def predict(self, X: np.ndarray, names: Iterable[str],
                meta: Optional[Dict] = None):
        if self.model is None and self._head is None:
            self.load()
        X = np.asarray(X, dtype=np.float32)
        if self._head is not None:
            out = self._head.predict_numpy(X)
            if self.method == "predict":
                if "logistic" not in self._kind:
                    # Regressor: sklearn's model.predict() returns the raw
                    # outputs, shape (n,) for single-target models.
                    return out[:, 0] if out.ndim == 2 and out.shape[1] == 1 else out
                idx = np.argmax(out, axis=-1)
                # Mirror sklearn's model.predict(): return class LABELS, not
                # argmax indices (labels may be strings / non-contiguous).
                if "classes" in self._params:
                    return np.asarray(self._params["classes"])[idx]
                return idx
            return out
        if self.method == "predict_proba" and hasattr(self.model, "predict_proba"):
            return self.model.predict_proba(X)
        return self.model.predict(X)

    def class_names(self) -> List[str]:
        if self._params is not None and "classes" in self._params:
            return [str(c) for c in self._params["classes"]]
        classes = getattr(self.model, "classes_", None)
        return [str(c) for c in classes] if classes is not None else []

    def tags(self) -> Dict:
        return {"server": "sklearnserver",
                "backend": "torch" if self._head is not None else "joblib"}


def export_linear_model(path: str, coef, intercept, classes=None,
                        kind: str = "logistic") -> str:
    """Save a linear/logistic model as the portable model.npz."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "model.npz")
    arrays = {
        "coef": np.atleast_2d(np.asarray(coef, np.float32)),
        "intercept": np.atleast_1d(np.asarray(intercept, np.float32)),
        "kind": np.array(kind),
    }
    if classes is not None:
        # Preserve the original label dtype (int/float/str): predict() maps
        # argmax indices through this array and must return what sklearn's
        # model.predict() would — integer labels stay integers. Object-dtype
        # arrays (sklearn's usual dtype for string labels) can't round-trip
        # through allow_pickle=False, so coerce those to fixed-width str.
        cls = np.asarray(classes)
        arrays["classes"] = cls.astype(str) if cls.dtype == object else cls
    np.savez(out, **arrays)
    return out
