"""Distributed tracing: one trace spanning the transports, the server
and the engine's request lifecycle.

Port of seldon_tpu/core/tracing.py (standard library only). A small
tracer modelled on OpenTelemetry: W3C `traceparent` context propagation
(interoperable with any OTel collector at the wire level), contextvar
parenting (asyncio-safe), and pluggable exporters (in-memory for tests,
JSONL file for collection).

Enable with env `TRACING=1`. `TRACING_FILE` selects the JSONL sink
(default stderr). Spans carry: trace_id, span_id, parent_id, name,
service, start/end ns, attributes, status.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import json
import os
import secrets
import sys
import threading
import time
from typing import Any, Dict, List, Optional

_TRACEPARENT = "traceparent"  # W3C header/metadata key


@dataclasses.dataclass
class SpanContext:
    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars

    def to_traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-01"

    @staticmethod
    def from_traceparent(value: str) -> Optional["SpanContext"]:
        parts = value.strip().split("-")
        if len(parts) < 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return SpanContext(trace_id=parts[1], span_id=parts[2])


@dataclasses.dataclass
class Span:
    name: str
    context: SpanContext
    parent_id: Optional[str]
    service: str
    start_ns: int
    end_ns: int = 0
    attributes: Dict[str, Any] = dataclasses.field(default_factory=dict)
    status: str = "OK"

    @property
    def trace_id(self) -> str:
        return self.context.trace_id

    @property
    def span_id(self) -> str:
        return self.context.span_id

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def set_status(self, status: str) -> None:
        self.status = status

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "service": self.service,
            "start_ns": self.start_ns,
            "end_ns": self.end_ns,
            "duration_ms": round((self.end_ns - self.start_ns) / 1e6, 3),
            "attributes": self.attributes,
            "status": self.status,
        }


class InMemoryExporter:
    """Collects finished spans; the test exporter."""

    def __init__(self):
        self.spans: List[Span] = []
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        with self._lock:
            self.spans.append(span)

    def by_trace(self) -> Dict[str, List[Span]]:
        with self._lock:
            out: Dict[str, List[Span]] = {}
            for s in self.spans:
                out.setdefault(s.trace_id, []).append(s)
            return out

    def clear(self) -> None:
        with self._lock:
            self.spans.clear()


class JsonlExporter:
    """One JSON object per finished span, appended to a file (or stderr)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()

    def export(self, span: Span) -> None:
        line = json.dumps(span.to_dict())
        with self._lock:
            if self.path:
                with open(self.path, "a") as f:
                    f.write(line + "\n")
            else:
                print(line, file=sys.stderr)


_current_span: contextvars.ContextVar[Optional[Span]] = contextvars.ContextVar(
    "seldon_tpu_torch_current_span", default=None
)


class Tracer:
    def __init__(self, service: str, exporter=None, enabled: bool = True):
        self.service = service
        self.exporter = exporter or JsonlExporter(os.environ.get("TRACING_FILE"))
        self.enabled = enabled

    # -- span lifecycle ------------------------------------------------------

    def span(self, name: str, parent: Optional[SpanContext] = None,
             attributes: Optional[Dict[str, Any]] = None):
        """Context manager: opens a child of `parent`, else of the current
        contextvar span, else a new root. Disabled tracers return one
        shared nullcontext — a generator contextmanager per request is
        measurable overhead on the engine hot path."""
        if not self.enabled:
            return _NOOP_CM
        return self._span_cm(name, parent, attributes)

    @contextlib.contextmanager
    def _span_cm(self, name: str, parent: Optional[SpanContext],
                 attributes: Optional[Dict[str, Any]]):
        if parent is None:
            cur = _current_span.get()
            if cur is not None:
                parent = cur.context
        trace_id = parent.trace_id if parent else secrets.token_hex(16)
        span = Span(
            name=name,
            context=SpanContext(trace_id=trace_id, span_id=secrets.token_hex(8)),
            parent_id=parent.span_id if parent else None,
            service=self.service,
            start_ns=time.time_ns(),
            attributes=dict(attributes or {}),
        )
        token = _current_span.set(span)
        try:
            yield span
        except BaseException as e:
            span.set_status(f"ERROR: {type(e).__name__}")
            raise
        finally:
            _current_span.reset(token)
            span.end_ns = time.time_ns()
            try:
                self.exporter.export(span)
            except Exception:  # never let the sink break the request path
                pass

    # -- retro-emission ------------------------------------------------------

    def emit_span(
        self,
        name: str,
        start_ns: int,
        end_ns: int,
        parent: Optional[SpanContext] = None,
        context: Optional[SpanContext] = None,
        attributes: Optional[Dict[str, Any]] = None,
        status: str = "OK",
    ) -> Optional[SpanContext]:
        """Export a span after the fact, from recorded timestamps — no
        contextvars, no `with` scope. The engine scheduler uses this to
        reconstruct a request's lifecycle (queued/prefill/decode) at
        terminal time instead of holding open span objects on the hot
        path. Returns the span's context (for parenting children), or
        None when the tracer is disabled."""
        if not self.enabled:
            return None
        ctx = context or SpanContext(
            trace_id=parent.trace_id if parent else secrets.token_hex(16),
            span_id=secrets.token_hex(8),
        )
        span = Span(
            name=name,
            context=ctx,
            parent_id=parent.span_id if parent else None,
            service=self.service,
            start_ns=start_ns,
            end_ns=end_ns,
            attributes=dict(attributes or {}),
            status=status,
        )
        try:
            self.exporter.export(span)
        except Exception:  # never let the sink break the request path
            pass
        return ctx

    # -- propagation ---------------------------------------------------------

    def inject(self, carrier: Dict[str, str]) -> Dict[str, str]:
        """Write the current span's context into a header/metadata dict."""
        if self.enabled:
            cur = _current_span.get()
            if cur is not None:
                carrier[_TRACEPARENT] = cur.context.to_traceparent()
        return carrier

    @staticmethod
    def extract(carrier) -> Optional[SpanContext]:
        """Read a SpanContext from headers / gRPC metadata (any mapping or
        (key, value) iterable; keys case-insensitive)."""
        if carrier is None:
            return None
        items = carrier.items() if hasattr(carrier, "items") else carrier
        for k, v in items:
            if str(k).lower() == _TRACEPARENT:
                return SpanContext.from_traceparent(
                    v.decode() if isinstance(v, bytes) else str(v)
                )
        return None


class _NoopSpan:
    context = SpanContext(trace_id="0" * 32, span_id="0" * 16)
    parent_id = None

    def set_attribute(self, key, value):
        pass

    def set_status(self, status):
        pass


_NOOP_SPAN = _NoopSpan()
# nullcontext is stateless -> one shared instance serves every disabled
# span() call.
_NOOP_CM = contextlib.nullcontext(_NOOP_SPAN)
_NOOP_TRACER = Tracer("noop", enabled=False)


def tracing_enabled() -> bool:
    return os.environ.get("TRACING", "0") in ("1", "true", "True")


def get_tracer(service: str, exporter=None) -> Tracer:
    """Tracer for `service`; no-op unless TRACING=1 (or an explicit
    exporter is supplied, e.g. in tests)."""
    if exporter is not None:
        return Tracer(service, exporter=exporter, enabled=True)
    if not tracing_enabled():
        return _NOOP_TRACER
    return Tracer(service)


def current_span() -> Optional[Span]:
    return _current_span.get()

