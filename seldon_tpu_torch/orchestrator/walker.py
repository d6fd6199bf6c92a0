"""The graph walk — engine hot loop.

Port of seldon_tpu/orchestrator/walker.py. Seldon's algorithm (the
forward path; feedback mirrors it down the recorded route):

  1. record requestPath[unit] = image
  2. transformInput (== predict for MODEL units)
  3. leaf -> return
  4. route -> branch index (-1 = broadcast to all children)
  5. fan out children (async)
  6. aggregate children outputs (COMBINER)
  7. transformOutput (OUTPUT_TRANSFORMER)
  merging Meta tags/puid at each hop, accumulating routing{} and metrics.

One asyncio task tree; a per-request context object accumulates meta;
MODEL leaf calls can flow through the dynamic micro-batcher
(batcher.py)."""

from __future__ import annotations

import asyncio
import base64
import logging
import secrets
import time
from typing import Dict, List, Optional

from google.protobuf import json_format

from seldon_tpu_torch.core import payloads, tracing
from seldon_tpu_torch.orchestrator.client import (
    InternalClient,
    UnitCallError,
    identity_headers,
)
from seldon_tpu_torch.orchestrator.spec import (
    HARDCODED_IMPLEMENTATIONS,
    EndpointType,
    PredictiveUnit,
    PredictorSpec,
    UnitType,
)
from seldon_tpu_torch.orchestrator.units import make_hardcoded
from seldon_tpu_torch.proto import prediction_pb2 as pb

logger = logging.getLogger(__name__)


def make_puid() -> str:
    """Random request id (Seldon's SecureRandom base32)."""
    return base64.b32encode(secrets.token_bytes(15)).decode().lower()


class _RequestCtx:
    """Per-request accumulators threaded through the walk."""

    def __init__(self, puid: str):
        self.puid = puid
        self.tags: Dict[str, object] = {}
        self.routing: Dict[str, int] = {}
        self.request_path: Dict[str, str] = {}
        self.metrics: List[pb.Metric] = []
        self.lock = asyncio.Lock()

    async def merge_response_meta(self, meta: pb.Meta) -> None:
        async with self.lock:
            for k, v in meta.tags.items():
                self.tags[k] = v
            self.metrics.extend(meta.metrics)

    def stamp(self, meta: pb.Meta) -> None:
        meta.puid = self.puid
        for k, v in self.tags.items():
            if isinstance(v, type(meta.tags[k])):
                meta.tags[k].CopyFrom(v)
            else:
                json_format.ParseDict(v, meta.tags[k])
        for k, i in self.routing.items():
            meta.routing[k] = i
        for k, v in self.request_path.items():
            meta.requestPath[k] = v
        for m in self.metrics:
            meta.metrics.add().CopyFrom(m)


class PredictorEngine:
    """Walks one PredictorSpec graph."""

    def __init__(
        self,
        spec: PredictorSpec,
        client: Optional[InternalClient] = None,
        batcher=None,
        metrics_hook=None,
        reward_hook=None,
        tracer: Optional[tracing.Tracer] = None,
    ):
        self.spec = spec
        self.client = client or InternalClient()
        self.batcher = batcher
        self.metrics_hook = metrics_hook  # callable(metric: pb.Metric, unit)
        self.reward_hook = reward_hook  # callable(unit, reward: float)
        self.tracer = tracer or tracing.get_tracer("engine")
        self._hardcoded = {
            u.name: make_hardcoded(u.implementation, u.parameters)
            for u in spec.graph.walk()
            if u.implementation in HARDCODED_IMPLEMENTATIONS
        }
        # Per-unit span name + attributes are static per spec: building
        # the f-string + identity dict per request showed up in the hot
        # path profile even with tracing disabled.
        self._all_hardcoded = self.batcher is None and all(
            u.name in self._hardcoded for u in spec.graph.walk()
        )
        # A walk never suspends when every unit is in-process OR the
        # client itself blocks (SyncInternalClient) — fan-outs then run
        # sequentially instead of as gathered tasks.
        self._sequential = self._all_hardcoded or bool(
            getattr(self.client, "is_sync", False)
        )
        self._span_info = {
            u.name: (
                f"unit.{u.name}",
                {"unit_type": str(u.type), **identity_headers(u)},
            )
            for u in spec.graph.walk()
        }
        # Solo-MODEL fast walk: the single most common deployed graph is
        # one network MODEL unit; its full walk is ~10 coroutine frames +
        # a ctx object per request. predict_sync collapses that to one
        # driven client call with identical meta semantics.
        g = spec.graph
        self._solo_unit = (
            g if (self.batcher is None and not g.children
                  and g.type == UnitType.MODEL
                  and g.name not in self._hardcoded)
            else None
        )

    @property
    def all_hardcoded(self) -> bool:
        """True when every unit runs in-process (no network hops) and no
        micro-batcher is interposed — the graph walk then never suspends,
        so predict()/send_feedback() coroutines can be driven to
        completion without an event loop (predict_sync). Cached at
        __init__ (spec/batcher/_hardcoded are fixed): it's read per
        fan-out node per request on the serving hot path."""
        return self._all_hardcoded

    @staticmethod
    def sync_drivable(spec: PredictorSpec, batcher=None) -> bool:
        """True when an engine built over `spec` with a BLOCKING gRPC
        client (SyncInternalClient) can serve the sync thread-pool lane:
        no micro-batcher (its fuse-wait must suspend), no REST-endpoint
        unit (the blocking client only speaks gRPC), and no COMBINER
        fan-out over network subtrees — a combiner calls ALL children
        per request and wants the async lane's PARALLEL gather (three
        200 ms units must cost ~200 ms, not ~600 ms). ROUTER graphs stay
        sync-drivable: a routed request walks exactly one branch (a rare
        broadcast route of -1 runs its branches sequentially)."""
        if batcher is not None:
            return False
        for u in spec.graph.walk():
            if (u.type == UnitType.COMBINER and len(u.children) > 1
                    and any(
                        x.implementation not in HARDCODED_IMPLEMENTATIONS
                        for c in u.children for x in c.walk()
                    )):
                return False
            if u.implementation in HARDCODED_IMPLEMENTATIONS:
                continue
            ep = u.endpoint
            if ep is not None and ep.type != EndpointType.GRPC:
                return False
        return True

    @staticmethod
    def drive_sync(coro):
        """Run a coroutine that never actually awaits IO to completion on
        the calling thread. Raises RuntimeError if it suspends (a
        network unit sneaked into a supposedly in-process graph)."""
        try:
            coro.send(None)
        except StopIteration as e:
            return e.value
        coro.close()
        raise RuntimeError(
            "graph walk suspended: predict_sync requires an in-process "
            "(hardcoded, unbatched) graph or a blocking SyncInternalClient"
        )

    def predict_sync(self, request: pb.SeldonMessage,
                     trace_parent=None) -> pb.SeldonMessage:
        """Synchronous predict for sync-lane graphs (in-process, or over
        the blocking SyncInternalClient) — the sync gRPC servicer path
        (orchestrator/server.py) calls this from worker threads with zero
        event-loop involvement."""
        if (self._solo_unit is not None and trace_parent is None
                and not self.tracer.enabled):
            return self._predict_solo(request)
        return self.drive_sync(self.predict(request, trace_parent))

    def _predict_solo(self, request: pb.SeldonMessage) -> pb.SeldonMessage:
        """One-network-MODEL fast walk. Produces byte-identical meta to
        the generic walk: the unit's own tags/metrics survive (absorb +
        stamp round-trips them), any routing/requestPath a unit tried to
        inject is dropped (meta.Clear parity), puid + requestPath are
        engine-stamped."""
        unit = self._solo_unit
        puid = request.meta.puid or make_puid()
        request.meta.puid = puid  # engine owns the request (see predict)
        out = self.drive_sync(self.client.call(unit, "predict", request))
        meta = out.meta
        if self.metrics_hook is not None:
            for m in meta.metrics:
                self.metrics_hook(m, unit)
        meta.puid = puid
        meta.ClearField("routing")
        meta.ClearField("requestPath")
        meta.requestPath[unit.name] = unit.image or unit.name
        return out

    # --- forward path -------------------------------------------------------

    async def predict(
        self,
        request: pb.SeldonMessage,
        trace_parent: Optional[tracing.SpanContext] = None,
    ) -> pb.SeldonMessage:
        """Walk the graph for one request and return the merged response.

        OWNERSHIP: the engine takes ownership of `request` and stamps
        `meta.puid` on it IN PLACE (a fresh puid is minted only when the
        field is empty). Server paths hand over a per-request message, so
        this is free; a library caller reusing one SeldonMessage across
        calls must `request.meta.puid = ""` between calls or every call
        reuses the first call's puid.
        """
        puid = request.meta.puid or make_puid()
        ctx = _RequestCtx(puid)
        # The engine owns the request message (every caller — REST parse,
        # gRPC servicers — hands over a per-request object): stamping the
        # puid in place saves a full message copy per request on the hot
        # path, and the logged request then carries its puid like the
        # reference's.
        msg = request
        msg.meta.puid = puid
        with self.tracer.span(
            "engine.predict", parent=trace_parent, attributes={"puid": puid}
        ):
            out = await self._get_output(msg, self.spec.graph, ctx)
        # The engine owns every message on the walk (unit responses are
        # parsed per-call; hardcoded units build fresh ones), so the
        # response is stamped IN PLACE — the old copy-into-a-new-message
        # was a full payload copy per request on the hot path.
        out.meta.Clear()
        ctx.stamp(out.meta)
        return out

    async def _get_output(
        self, msg: pb.SeldonMessage, unit: PredictiveUnit, ctx: _RequestCtx
    ) -> pb.SeldonMessage:
        ctx.request_path[unit.name] = unit.image or unit.name
        hard = self._hardcoded.get(unit.name)
        if not self.tracer.enabled:
            # Zero-allocation disabled path: no span-info tuple unpack,
            # no context-manager entry (even the shared noop CM costs a
            # __enter__/__exit__ pair per unit per request).
            return await self._walk_unit(msg, unit, hard, ctx)
        span_name, span_attrs = self._span_info[unit.name]
        with self.tracer.span(span_name, attributes=span_attrs):
            return await self._walk_unit(msg, unit, hard, ctx)

    async def _walk_unit(
        self, msg: pb.SeldonMessage, unit: PredictiveUnit, hard, ctx
    ) -> pb.SeldonMessage:

        # (2) transformInput / predict
        transformed = await self._transform_input(msg, unit, hard, ctx)

        # (3) leaf
        if not unit.children:
            return transformed

        # (4) route
        branch = await self._route(transformed, unit, hard, ctx)

        # (5) children fan-out
        if branch == -1:
            selected = unit.children
        else:
            if not 0 <= branch < len(unit.children):
                # -1 is the only legal sentinel; other negatives would hit
                # Python negative indexing and silently pick a wrong child.
                raise UnitCallError(
                    unit.name, "route",
                    f"branch {branch} out of range ({len(unit.children)} children)",
                )
            selected = [unit.children[branch]]
        if len(selected) == 1:
            # Direct await: no task/future churn for the common
            # single-branch case (routers, chains).
            child_outputs = [
                await self._get_output(transformed, selected[0], ctx)
            ]
        elif self._sequential:
            # In-process graph, or a blocking (sync-lane) client: awaits
            # complete without suspending either way, so sequential
            # iteration keeps the whole predict() coroutine synchronously
            # drivable (predict_sync) with identical results.
            child_outputs = [
                await self._get_output(transformed, c, ctx) for c in selected
            ]
        else:
            child_outputs = await asyncio.gather(
                *(self._get_output(transformed, c, ctx) for c in selected)
            )

        # (6) aggregate
        merged = await self._aggregate(list(child_outputs), unit, hard, ctx)

        # (7) transformOutput
        return await self._transform_output(merged, unit, hard, ctx)

    async def _transform_input(
        self, msg, unit: PredictiveUnit, hard, ctx
    ) -> pb.SeldonMessage:
        if unit.type == UnitType.MODEL:
            if hard is not None:
                out = hard.transform_input(msg)
            elif self.batcher is not None:
                out = await self.batcher.call(unit, msg, self.client)
            else:
                out = await self.client.call(unit, "predict", msg)
        elif unit.type == UnitType.TRANSFORMER:
            if hard is not None:
                out = hard.transform_input(msg)
            else:
                out = await self.client.call(unit, "transform_input", msg)
        else:
            return msg
        await self._absorb(out, unit, ctx)
        return out

    async def _route(self, msg, unit: PredictiveUnit, hard, ctx) -> int:
        if unit.type != UnitType.ROUTER:
            return -1
        if hard is not None:
            branch = hard.route(msg, len(unit.children))
        else:
            resp = await self.client.call(unit, "route", msg)
            branch = _extract_route(resp)
            await self._absorb(resp, unit, ctx)
        async with ctx.lock:
            ctx.routing[unit.name] = branch
        return branch

    async def _aggregate(
        self, outputs: List[pb.SeldonMessage], unit: PredictiveUnit, hard, ctx
    ) -> pb.SeldonMessage:
        if unit.type == UnitType.COMBINER:
            if hard is not None:
                out = hard.aggregate(outputs)
            else:
                req = pb.SeldonMessageList()
                req.seldonMessages.extend(outputs)
                out = await self.client.call(unit, "aggregate", req)
            await self._absorb(out, unit, ctx)
            return out
        if len(outputs) == 1:
            return outputs[0]
        raise UnitCallError(
            unit.name, "aggregate",
            f"{len(outputs)} child outputs but unit is not a COMBINER",
        )

    async def _transform_output(self, msg, unit: PredictiveUnit, hard, ctx):
        if unit.type != UnitType.OUTPUT_TRANSFORMER:
            return msg
        if hard is not None:
            out = hard.transform_output(msg)
        else:
            out = await self.client.call(unit, "transform_output", msg)
        await self._absorb(out, unit, ctx)
        return out

    async def _absorb(self, out: pb.SeldonMessage, unit: PredictiveUnit, ctx):
        """Merge a unit response's meta into the request context; surface
        custom metrics (Seldon's PredictiveUnitBean)."""
        await ctx.merge_response_meta(out.meta)
        if self.metrics_hook is not None:
            for m in out.meta.metrics:
                self.metrics_hook(m, unit)

    # --- feedback mirror ----------------------------------------------------

    async def send_feedback(self, feedback: pb.Feedback) -> pb.SeldonMessage:
        """Follows stored meta.routing down the tree (Seldon's
        feedback mirror)."""
        await self._send_feedback(feedback, self.spec.graph)
        resp = pb.SeldonMessage()
        resp.meta.puid = feedback.response.meta.puid or make_puid()
        return resp

    async def _send_feedback(self, feedback: pb.Feedback, unit: PredictiveUnit):
        hard = self._hardcoded.get(unit.name)
        if unit.type in (UnitType.MODEL, UnitType.ROUTER):
            if hard is not None:
                hard.send_feedback(feedback)
            else:
                try:
                    await self.client.call(unit, "send_feedback", feedback)
                except UnitCallError:
                    logger.warning("feedback to %s failed", unit.name,
                                   exc_info=True)
            if self.reward_hook is not None:
                # A dedicated hook, NOT a fabricated custom pb.Metric: the
                # name would collide with the built-in reward counter in
                # the prometheus registry and be dropped on every
                # feedback (engine-level rewards were never recorded).
                self.reward_hook(unit, feedback.reward)
        routing = feedback.response.meta.routing
        if unit.name in routing:
            branch = routing[unit.name]
            children = (
                unit.children if branch == -1
                else [unit.children[branch]]
                if 0 <= branch < len(unit.children)
                else []
            )
        else:
            children = unit.children
        if len(children) == 1 or self._sequential:
            # Mirrors the predict-path rule: keeps the coroutine
            # synchronously drivable for in-process/sync-lane graphs (the
            # sync gRPC servicer) and skips task churn for single-branch
            # mirrors.
            for c in children:
                await self._send_feedback(feedback, c)
        elif children:
            await asyncio.gather(
                *(self._send_feedback(feedback, c) for c in children)
            )

    async def close(self):
        await self.client.close()


def _extract_route(msg: pb.SeldonMessage) -> int:
    """Routers return the branch as the first element of their data payload
    (Seldon's routing semantics). A malformed router response is an
    error, NOT broadcast — silently fanning out to every branch would run
    all models and mask the router bug."""
    import numpy as np

    data = payloads.get_data_from_message(msg)
    try:
        arr = np.asarray(data).ravel()
        if arr.size == 0:
            raise ValueError("empty payload")
        return int(arr[0])
    except (TypeError, ValueError) as e:
        raise UnitCallError(
            "router", "route",
            f"malformed route response ({e}); expected branch index as "
            f"first data element",
        )
