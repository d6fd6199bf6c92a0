"""Custom-metrics helpers returned from user `metrics()` hooks.

Port of seldon_tpu/core/metrics.py. Metric dicts are propagated through
`Meta.metrics` and folded by the serving runtime into Prometheus
counters/gauges/histograms.
"""

from __future__ import annotations

from typing import Dict, List, Optional

COUNTER = "COUNTER"
GAUGE = "GAUGE"
TIMER = "TIMER"

_TYPES = (COUNTER, GAUGE, TIMER)


def create_counter(key: str, value: float, tags: Optional[Dict[str, str]] = None) -> dict:
    return _metric(key, COUNTER, value, tags)


def create_gauge(key: str, value: float, tags: Optional[Dict[str, str]] = None) -> dict:
    return _metric(key, GAUGE, value, tags)


def create_timer(key: str, value: float, tags: Optional[Dict[str, str]] = None) -> dict:
    """value is milliseconds, matching the reference's TIMER convention."""
    return _metric(key, TIMER, value, tags)


def _metric(key: str, mtype: str, value: float, tags: Optional[Dict[str, str]]) -> dict:
    m = {"key": key, "type": mtype, "value": float(value)}
    if tags:
        m["tags"] = {str(k): str(v) for k, v in tags.items()}
    return m


def validate_metrics(metrics: List[dict]) -> bool:
    """Schema check of a `metrics()` hook's list (Seldon's
    `validate_metrics`)."""
    if not isinstance(metrics, (list, tuple)):
        return False
    for m in metrics:
        if not isinstance(m, dict):
            return False
        if "key" not in m or "value" not in m:
            return False
        if m.get("type", COUNTER) not in _TYPES:
            return False
        try:
            float(m["value"])
        except (TypeError, ValueError):
            return False
    return True
