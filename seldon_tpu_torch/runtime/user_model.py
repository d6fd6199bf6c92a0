"""User-facing component API.

Port of seldon_tpu/runtime/user_model.py: Seldon's `SeldonComponent`
(predict / transform_input / transform_output / route / aggregate /
send_feedback / metrics / tags / class_names / load) plus validated
`client_*` wrappers, and the serving extensions:

 * `supports_batching` + `max_batch_size` advertise dynamic batching to
   the orchestrator;
 * `generate(request) -> dict` and `generate_stream(request)` hooks for
   LLM text generation (the TextGen service).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np

from seldon_tpu_torch.core.metrics import validate_metrics

__all__ = ["SeldonComponent", "SeldonNotImplementedError", "client_predict",
           "client_transform_input", "client_transform_output", "client_route",
           "client_aggregate", "client_send_feedback", "client_custom_metrics",
           "client_custom_tags", "client_class_names"]


class SeldonNotImplementedError(Exception):
    """Raised by default hooks so dispatch can fall through to lower-level
    variants."""


class SeldonComponent:
    """Base class for models, routers, transformers, combiners and
    outlier detectors. Subclass and override the hooks you need."""

    # --- lifecycle ---------------------------------------------------------

    def load(self) -> None:
        """Heavy initialisation (weights, kernels). Called once in the
        serving process, before traffic."""

    def health_status(self) -> Any:
        """Optional payload returned by the health endpoint."""
        raise SeldonNotImplementedError()

    def init_metadata(self) -> Dict:
        """Optional model metadata dict served at /metadata."""
        raise SeldonNotImplementedError()

    # --- batching contract ------------------------------------------------

    supports_batching: bool = False
    max_batch_size: int = 0
    batch_timeout_ms: float = 2.0

    # --- MODEL --------------------------------------------------------------

    def predict(
        self, X: np.ndarray, names: Iterable[str], meta: Optional[Dict] = None
    ) -> Union[np.ndarray, List, str, bytes]:
        raise SeldonNotImplementedError()

    def predict_raw(self, msg: Any) -> Any:
        """Low-level hook: gets/returns the SeldonMessage proto (or dict on
        the REST path)."""
        raise SeldonNotImplementedError()

    # --- TRANSFORMER / OUTPUT_TRANSFORMER -----------------------------------

    def transform_input(
        self, X: np.ndarray, names: Iterable[str], meta: Optional[Dict] = None
    ) -> Union[np.ndarray, List, str, bytes]:
        raise SeldonNotImplementedError()

    def transform_input_raw(self, msg: Any) -> Any:
        raise SeldonNotImplementedError()

    def transform_output(
        self, X: np.ndarray, names: Iterable[str], meta: Optional[Dict] = None
    ) -> Union[np.ndarray, List, str, bytes]:
        raise SeldonNotImplementedError()

    def transform_output_raw(self, msg: Any) -> Any:
        raise SeldonNotImplementedError()

    # --- ROUTER -------------------------------------------------------------

    def route(
        self, features: np.ndarray, feature_names: Iterable[str]
    ) -> int:
        raise SeldonNotImplementedError()

    def route_raw(self, msg: Any) -> Any:
        raise SeldonNotImplementedError()

    def send_feedback(
        self,
        features: np.ndarray,
        feature_names: Iterable[str],
        reward: float,
        truth: Any,
        routing: Optional[int] = None,
    ) -> Any:
        raise SeldonNotImplementedError()

    def send_feedback_raw(self, feedback: Any) -> Any:
        raise SeldonNotImplementedError()

    # --- COMBINER -----------------------------------------------------------

    def aggregate(
        self, features_list: List[np.ndarray], feature_names_list: List[List[str]]
    ) -> Union[np.ndarray, List, str, bytes]:
        raise SeldonNotImplementedError()

    def aggregate_raw(self, msgs: Any) -> Any:
        raise SeldonNotImplementedError()

    # --- LLM text generation ------------------------------------------------

    def generate(self, request: Dict) -> Dict:
        """request: {prompt|prompt_token_ids, max_new_tokens, temperature,
        top_p, top_k, seed}. Returns {text?, token_ids, ttft_ms, ...}."""
        raise SeldonNotImplementedError()

    def generate_stream(self, request: Dict):
        """Iterator variant of `generate`: yield chunk dicts as tokens land."""
        raise SeldonNotImplementedError()
        yield  # pragma: no cover

    # --- metadata hooks -----------------------------------------------------

    def class_names(self) -> Iterable[str]:
        raise SeldonNotImplementedError()

    def feature_names(self) -> Iterable[str]:
        raise SeldonNotImplementedError()

    def metrics(self) -> List[Dict]:
        raise SeldonNotImplementedError()

    def tags(self) -> Dict:
        raise SeldonNotImplementedError()


# ---------------------------------------------------------------------------
# client_* wrappers: duck-typed dispatch with validation, so plain classes
# (no SeldonComponent inheritance) keep working.
# ---------------------------------------------------------------------------


def _call(user_model: Any, name: str, *args, **kwargs):
    fn = getattr(user_model, name, None)
    if fn is None or not callable(fn):
        raise SeldonNotImplementedError()
    return fn(*args, **kwargs)


def client_predict(user_model, X, names, meta=None):
    try:
        return _call(user_model, "predict", X, names, meta=meta)
    except TypeError:
        return _call(user_model, "predict", X, names)


def client_transform_input(user_model, X, names, meta=None):
    try:
        return _call(user_model, "transform_input", X, names, meta=meta)
    except TypeError:
        return _call(user_model, "transform_input", X, names)


def client_transform_output(user_model, X, names, meta=None):
    try:
        return _call(user_model, "transform_output", X, names, meta=meta)
    except TypeError:
        return _call(user_model, "transform_output", X, names)


def client_route(user_model, features, feature_names) -> int:
    branch = _call(user_model, "route", features, feature_names)
    if not isinstance(branch, (int, np.integer)):
        raise TypeError(f"route must return int, got {type(branch)}")
    return int(branch)


def client_aggregate(user_model, features_list, names_list):
    return _call(user_model, "aggregate", features_list, names_list)


def client_send_feedback(user_model, features, names, reward, truth, routing=None):
    try:
        return _call(
            user_model, "send_feedback", features, names, reward, truth, routing=routing
        )
    except TypeError:
        return _call(user_model, "send_feedback", features, names, reward, truth)


def client_custom_metrics(user_model) -> List[Dict]:
    try:
        m = _call(user_model, "metrics")
    except SeldonNotImplementedError:
        return []
    if m is None:
        return []
    if not validate_metrics(m):
        raise ValueError(f"invalid metrics from {type(user_model).__name__}: {m!r}")
    return list(m)


def client_custom_tags(user_model) -> Dict:
    try:
        t = _call(user_model, "tags")
    except SeldonNotImplementedError:
        return {}
    return dict(t or {})


def client_class_names(user_model) -> List[str]:
    try:
        n = _call(user_model, "class_names")
        return list(n or [])
    except SeldonNotImplementedError:
        return []
