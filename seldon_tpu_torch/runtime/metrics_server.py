"""Prometheus metrics for unit servers and the orchestrator.

Port of seldon_tpu/runtime/metrics_server.py: request counters and
latency histograms by method and transport, plus the unit's custom
metrics (`Meta.metrics`) folded into one registry. Without
`prometheus_client` the server still serves, with an empty exposition.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

try:
    import prometheus_client as prom
    from prometheus_client import CollectorRegistry, Counter, Gauge, Histogram

    _HAVE_PROM = True
except Exception:  # pragma: no cover
    _HAVE_PROM = False

_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.075, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)

import logging

logger = logging.getLogger(__name__)


class ServerMetrics:
    """Request counters/latency histograms + user custom metrics."""

    def __init__(self, registry: Optional["CollectorRegistry"] = None):
        self._lock = threading.Lock()
        if not _HAVE_PROM:  # pragma: no cover
            self._registry = None
            return
        self._registry = registry or CollectorRegistry()
        self._requests = Counter(
            "seldon_api_executor_server_requests_total",
            "Requests served, by method and transport",
            ["method", "transport"],
            registry=self._registry,
        )
        self._latency = Histogram(
            "seldon_api_executor_server_requests_seconds",
            "Request latency in seconds",
            ["method", "transport"],
            buckets=_BUCKETS,
            registry=self._registry,
        )
        # name -> (metric type, tag key tuple, collector)
        self._custom: dict = {}
        self._dropped: set = set()
        self._observe_cache: dict = {}
        self._reward = Counter(
            "seldon_api_model_feedback_reward_total",
            "Accumulated feedback reward",
            ["unit"],
            registry=self._registry,
        )
        self._reward_neg = Counter(
            "seldon_api_model_feedback_reward_negative_total",
            "Accumulated magnitude of negative feedback rewards",
            ["unit"],
            registry=self._registry,
        )
        self._feedback = Counter(
            "seldon_api_model_feedback_total",
            "Feedback messages seen",
            ["unit"],
            registry=self._registry,
        )
        self._graph_ready = Gauge(
            "seldon_graph_ready",
            "1 when the predictor graph passes its readiness probe",
            registry=self._registry,
        )

    def set_graph_ready(self, ready: bool) -> None:
        if _HAVE_PROM:
            self._graph_ready.set(1.0 if ready else 0.0)

    def observe(self, method: str, transport: str, seconds: float, response) -> None:
        if not _HAVE_PROM:  # pragma: no cover
            return
        children = self._observe_cache.get((method, transport))
        if children is None:
            # prometheus_client's labels() re-validates + locks per call;
            # the (method, transport) space is tiny, cache the children.
            children = (
                self._requests.labels(method, transport),
                self._latency.labels(method, transport),
            )
            self._observe_cache[(method, transport)] = children
        children[0].inc()
        children[1].observe(seconds)
        if response is not None and hasattr(response, "meta"):
            try:
                self.record_custom(response.meta.metrics)
            except Exception:  # metrics must never fail a served request
                logger.exception("custom metric recording failed")

    def record_custom(self, metrics) -> None:
        """Fold `Meta.metrics` entries into the registry (COUNTER inc,
        GAUGE set, TIMER observe-ms) — reference CustomMetricsManager
        semantics.

        Prometheus forbids re-registering a metric name with a different
        type or label set, so collectors are keyed by name; a later entry
        reusing a name with mismatched type/tags is dropped (logged once)
        instead of poisoning the request path with registry errors.
        """
        if not _HAVE_PROM or not metrics:
            return
        from seldon_tpu_torch.proto import prediction_pb2 as pb

        _CLS = {pb.Metric.COUNTER: Counter, pb.Metric.GAUGE: Gauge, pb.Metric.TIMER: Histogram}
        for m in metrics:
            tag_keys = tuple(sorted(m.tags))
            tag_vals = [m.tags[k] for k in tag_keys]
            with self._lock:
                entry = self._custom.get(m.key)
                if entry is None:
                    try:
                        if m.type == pb.Metric.TIMER:
                            coll = Histogram(
                                m.key, "custom timer (s)", list(tag_keys),
                                buckets=_BUCKETS, registry=self._registry,
                            )
                        else:
                            coll = _CLS[m.type](
                                m.key,
                                "custom metric",
                                list(tag_keys),
                                registry=self._registry,
                            )
                    except ValueError as e:  # name collides with built-ins
                        self._log_drop(m.key, str(e))
                        continue
                    entry = (m.type, tag_keys, coll)
                    self._custom[m.key] = entry
                mtype, keys, coll = entry
                if mtype != m.type or keys != tag_keys:
                    self._log_drop(
                        m.key,
                        f"type/tags mismatch: registered {mtype}/{keys}, got {m.type}/{tag_keys}",
                    )
                    continue
                target = coll.labels(*tag_vals) if tag_keys else coll
                if m.type == pb.Metric.COUNTER:
                    target.inc(m.value)
                elif m.type == pb.Metric.GAUGE:
                    target.set(m.value)
                else:  # TIMER, milliseconds
                    target.observe(m.value / 1000.0)

    def _log_drop(self, key: str, why: str) -> None:
        if key not in self._dropped:
            self._dropped.add(key)
            logger.warning("dropping custom metric %r: %s", key, why)

    def record_reward(self, unit: str, reward: float) -> None:
        """Feedback counters (reference PredictiveUnitBean.java:323-332).
        Counters can't decrease, so negative rewards accumulate on a
        separate series."""
        if not _HAVE_PROM:  # pragma: no cover
            return
        self._feedback.labels(unit).inc()
        if reward > 0:
            self._reward.labels(unit).inc(reward)
        elif reward < 0:
            self._reward_neg.labels(unit).inc(-reward)

    def export(self) -> Tuple[bytes, str]:
        if not _HAVE_PROM:  # pragma: no cover
            return b"", "text/plain"
        return prom.generate_latest(self._registry), prom.CONTENT_TYPE_LATEST


_default_metrics: Optional[ServerMetrics] = None
_default_lock = threading.Lock()


def get_default_metrics() -> ServerMetrics:
    """Process-wide ServerMetrics shared by REST and gRPC servers, so one
    /metrics scrape sees both transports."""
    global _default_metrics
    with _default_lock:
        if _default_metrics is None:
            _default_metrics = ServerMetrics()
        return _default_metrics
