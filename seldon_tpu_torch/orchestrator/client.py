"""Async internal client: engine -> unit microservice calls.

Port of seldon_tpu/orchestrator/client.py: cached gRPC channels and one
aiohttp session on the engine's event loop, per-call deadlines, retries
on connection failure only, and the framed fast lane where a unit
declares one. REST carries binary proto (`application/x-protobuf`) by
default, JSON only where a unit's endpoint asks for it."""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional

import grpc
import grpc.aio

from seldon_tpu_torch.core import payloads, tracing
from seldon_tpu_torch.orchestrator.spec import Endpoint, EndpointType, PredictiveUnit
from seldon_tpu_torch.proto import prediction_grpc
from seldon_tpu_torch.proto import prediction_pb2 as pb

logger = logging.getLogger(__name__)

from seldon_tpu_torch.core.http import (  # noqa: F401 (shared constants)
    JSON_CONTENT_TYPE,
    PROTO_CONTENT_TYPE,
    to_json_bytes,
)

# engine-side call name -> (service, rpc) — typed per-unit stubs, as in
# Seldon's engine.
_GRPC_METHODS = {
    "predict": ("Model", "Predict"),
    "transform_input": ("Generic", "TransformInput"),
    "transform_output": ("Generic", "TransformOutput"),
    "route": ("Router", "Route"),
    "aggregate": ("Combiner", "Aggregate"),
    "send_feedback": ("Generic", "SendFeedback"),
}

_REST_PATHS = {
    "predict": "/predict",
    "transform_input": "/transform-input",
    "transform_output": "/transform-output",
    "route": "/route",
    "aggregate": "/aggregate",
    "send_feedback": "/send-feedback",
}


def identity_headers(unit: PredictiveUnit) -> Dict[str, str]:
    """Engine -> unit hop-identity headers, Seldon's
    `Seldon-model-name/image/version` contract: downstream logging/tracing
    systems recover WHICH unit (and which image build) served each hop
    without parsing the graph. Keys are lowercase so the same dict is
    valid gRPC metadata (gRPC requires lowercase ASCII keys; HTTP headers
    are case-insensitive)."""
    image, sep, version = (unit.image or "").rpartition(":")
    # A tag colon always follows the last '/': "localhost:5000/img" is an
    # UNtagged image on a port-qualified registry, and "img@sha256:..." is
    # a digest ref — in both, the suffix after ':' contains no tag.
    if not sep or "/" in version or "@" in image:
        image, version = (unit.image or ""), ""
    return {
        "seldon-model-name": unit.name,
        "seldon-model-image": image,
        "seldon-model-version": version,
    }


class UnitCallError(Exception):
    def __init__(self, unit: str, method: str, detail: str, status: int = 500):
        super().__init__(f"{unit}.{method}: {detail}")
        self.unit = unit
        self.method = method
        self.detail = detail
        self.status = status


class InternalClient:
    """Cached-channel async client for unit calls."""

    def __init__(
        self,
        timeout_s: float = 30.0,
        retries: int = 3,
        max_message_bytes: int = 512 * 1024 * 1024,
    ):
        self.timeout_s = timeout_s
        self.retries = retries
        self._options = [
            ("grpc.max_send_message_length", max_message_bytes),
            ("grpc.max_receive_message_length", max_message_bytes),
        ]
        self._channels: Dict[str, grpc.aio.Channel] = {}
        self._http = None  # lazy aiohttp session
        # Per-call construction of stubs, identity dicts, and metadata
        # tuples showed up in the async hot-path profile (a stub __init__
        # builds a multicallable per RPC method); everything static per
        # (endpoint, method) or per unit is cached here.
        self._rpcs: Dict[tuple, object] = {}
        self._unit_metadata: Dict[str, tuple] = {}
        self._rest_static: Dict[tuple, tuple] = {}
        # Framed-proto fast-lane state (runtime/fastpath.py), shared by
        # the async and sync variants: endpoints that refused or
        # repeatedly failed the lane fall back to gRPC until a retry-
        # after deadline (a TIMED write-off, not permanent: a refused
        # connect during a unit's restart window must not demote the
        # lane for the process lifetime; re-probing costs one failed
        # connect per minute).
        self._fast_dead: Dict[tuple, float] = {}  # key -> retry-after ts
        self._fast_errs: Dict[tuple, int] = {}
        self._afast = None  # lazy AsyncFastClient

    # --- transport plumbing -------------------------------------------------

    def _channel(self, endpoint: Endpoint) -> grpc.aio.Channel:
        addr = f"{endpoint.service_host}:{endpoint.service_port}"
        ch = self._channels.get(addr)
        if ch is None:
            ch = grpc.aio.insecure_channel(addr, options=self._options)
            self._channels[addr] = ch
        return ch

    async def _http_session(self):
        if self._http is None:
            import aiohttp

            self._http = aiohttp.ClientSession()
        return self._http

    async def close(self):
        for ch in self._channels.values():
            await ch.close()
        self._channels.clear()
        self._rpcs.clear()  # bound to the closed channels
        if self._http is not None:
            await self._http.close()
            self._http = None
        if self._afast is not None:
            await self._afast.close()
            self._afast = None

    # --- calls --------------------------------------------------------------

    async def call(
        self,
        unit: PredictiveUnit,
        method: str,
        request,
        response_cls=pb.SeldonMessage,
    ):
        """Invoke `method` on the unit's microservice with retries."""
        ep = unit.endpoint or Endpoint()
        last_err: Optional[Exception] = None
        identity = self._identity_metadata(unit)
        for attempt in range(self.retries + 1):
            try:
                if ep.type == EndpointType.GRPC:
                    return await self._call_grpc(ep, method, request, identity)
                return await self._call_rest(
                    ep, method, request, response_cls, identity
                )
            except (grpc.RpcError, OSError, asyncio.TimeoutError) as e:
                # grpc.aio.AioRpcError (async lane) and the sync lane's
                # _InactiveRpcError are both grpc.RpcError with .code().
                last_err = e
                # Only connection-level failures retry (as in Seldon's
                # engine) — NOT timeouts: the unit may already be doing the work, and
                # retrying a slow call duplicates it.
                if isinstance(e, grpc.RpcError):
                    retryable = e.code() == grpc.StatusCode.UNAVAILABLE
                else:
                    import aiohttp

                    # ConnectionError covers the fast lane's framed
                    # transport failures (stale persistent socket).
                    retryable = isinstance(
                        e, (ConnectionError, BrokenPipeError,
                            aiohttp.ClientConnectorError)
                    )
                if not retryable:
                    break
                if attempt < self.retries:
                    await self._backoff(attempt)
        detail = str(last_err)
        if isinstance(last_err, grpc.RpcError):
            detail = f"{last_err.code().name}: {last_err.details()}"
        raise UnitCallError(unit.name, method, detail)

    async def _backoff(self, attempt: int) -> None:
        await asyncio.sleep(0.05 * (attempt + 1))

    def _rpc(self, ep: Endpoint, method: str):
        """Bound multicallable for (endpoint, method) — cached: stub
        construction builds one multicallable per RPC of the service."""
        addr = f"{ep.service_host}:{ep.service_port}"
        key = (addr, method)
        rpc = self._rpcs.get(key)
        if rpc is None:
            service, rpc_name = _GRPC_METHODS[method]
            stub = prediction_grpc.STUBS[service](self._channel(ep))
            rpc = getattr(stub, rpc_name)
            self._rpcs[key] = rpc
        return rpc

    _FAST_RETRY_AFTER_S = 60.0

    def _fast_usable(self, ep: Endpoint) -> bool:
        """Fast lane applies when the endpoint declares it, it isn't in
        a write-off window, and the request is untraced (the frame
        carries no metadata — traced requests ride full gRPC so
        traceparent + identity headers reach the unit)."""
        if not ep.fast_port or tracing._current_span.get() is not None:
            return False
        import time

        deadline = self._fast_dead.get((ep.service_host, ep.fast_port))
        if deadline is not None:
            if time.monotonic() < deadline:
                return False
            # pop, not del: sync-lane worker threads share this client
            # unlocked and may race past the same expired window.
            self._fast_dead.pop((ep.service_host, ep.fast_port), None)
        return True

    def _fast_fail(self, ep: Endpoint, refused: bool) -> None:
        import time

        key = (ep.service_host, ep.fast_port)
        if refused:
            self._fast_dead[key] = time.monotonic() + self._FAST_RETRY_AFTER_S
            logger.warning(
                "fastPort %d refused on %s — gRPC for the next %.0fs",
                ep.fast_port, ep.service_host, self._FAST_RETRY_AFTER_S,
            )
            return
        n = self._fast_errs.get(key, 0) + 1
        self._fast_errs[key] = n
        if n >= 3:
            # e.g. the port is actually some OTHER server that accepts
            # and then drops the framed bytes: connect never refuses, so
            # repeated transport failures are the write-off signal.
            self._fast_dead[key] = time.monotonic() + self._FAST_RETRY_AFTER_S
            self._fast_errs.pop(key, None)
            logger.warning(
                "fastPort %d failed %d consecutive transports on %s — "
                "gRPC for the next %.0fs",
                ep.fast_port, n, ep.service_host, self._FAST_RETRY_AFTER_S,
            )

    async def _fast_transport(self, ep: Endpoint, method: str, request):
        """The lane's transport call — the ONLY thing the sync variant
        overrides; error policy lives once in _fast_attempt."""
        if self._afast is None:
            from seldon_tpu_torch.runtime.fastpath import AsyncFastClient

            self._afast = AsyncFastClient(timeout_s=self.timeout_s)
        return await self._afast.call(
            ep.service_host, ep.fast_port, method, request
        )

    async def _fast_attempt(self, ep: Endpoint, method: str, request,
                            identity: tuple):
        """One fast-lane attempt. Returns (handled, out); handled False
        means fall through to gRPC for this call. Error policy:
        - framed unit error -> UnitCallError (attributed to the unit)
        - refused connect -> gRPC fallback for the write-off window
          (_FAST_RETRY_AFTER_S), handled False
        - stale pooled connection died -> retryable, NOT counted toward
          the write-off (the unit just restarted; a fresh connect works)
        - timeout -> not retried, not counted (slow unit, healthy lane)
        - fresh-connection transport failure -> counted; 3 in a row
          start a write-off window."""
        from seldon_tpu_torch.runtime.fastpath import StaleConnection

        try:
            out = await self._fast_transport(ep, method, request)
            self._fast_errs.pop((ep.service_host, ep.fast_port), None)
            return True, out
        except RuntimeError as e:
            raise UnitCallError(
                _unit_name_of(identity, ep), method, str(e)
            ) from e
        except ConnectionRefusedError:
            self._fast_fail(ep, refused=True)
            return False, None
        except StaleConnection:
            raise  # retryable in call(); reconnects on the next attempt
        except TimeoutError:
            raise  # slow unit, not a broken lane: no write-off count
        except (ConnectionError, OSError):
            self._fast_fail(ep, refused=False)
            raise  # retryable in call(); next attempt may fall back

    async def _call_grpc(self, ep: Endpoint, method: str, request,
                         identity: tuple = ()):
        if self._fast_usable(ep):
            handled, out = await self._fast_attempt(
                ep, method, request, identity
            )
            if handled:
                return out
        rpc = self._rpc(ep, method)
        cur = tracing._current_span.get()
        if cur is None:  # tracing off: the static per-unit tuple as-is
            metadata = identity or None
        else:
            d = dict(identity)
            d[tracing._TRACEPARENT] = cur.context.to_traceparent()
            metadata = tuple(d.items())
        return await rpc(request, timeout=self.timeout_s, metadata=metadata)

    def _rest_parts(self, ep: Endpoint, method: str, identity: tuple):
        # identity is in the key: two units may share one endpoint, and
        # each hop must carry ITS unit's seldon-model-* headers.
        key = (ep.service_host, ep.service_port, method, ep.content,
               identity)
        parts = self._rest_static.get(key)
        if parts is None:
            url = (f"http://{ep.service_host}:{ep.service_port}"
                   f"{_REST_PATHS[method]}")
            ctype = (JSON_CONTENT_TYPE if ep.content == "json"
                     else PROTO_CONTENT_TYPE)
            headers = {"Content-Type": ctype, **dict(identity)}
            parts = (url, headers)
            self._rest_static[key] = parts
        return parts

    def _identity_metadata(self, unit: PredictiveUnit) -> tuple:
        md = self._unit_metadata.get(unit.name)
        if md is None:
            md = tuple(identity_headers(unit).items())
            self._unit_metadata[unit.name] = md
        return md

    async def _call_rest(self, ep: Endpoint, method: str, request,
                         response_cls, identity: tuple = ()):
        session = await self._http_session()
        url, headers = self._rest_parts(ep, method, identity)
        if ep.content == "json":
            # Foreign-language units (docs/wrappers.md) speak JSON; our
            # own units prefer the binary-proto body (zero-copy dense).
            body_out = to_json_bytes(request)
        else:
            body_out = request.SerializeToString()
        if tracing._current_span.get() is not None:
            headers = tracing.inject_current(dict(headers))
        async with session.post(
            url,
            data=body_out,
            headers=headers,
            timeout=self.timeout_s,
        ) as resp:
            body = await resp.read()
            if resp.status != 200:
                raise UnitCallError(
                    ep.service_host, method, body.decode("utf-8", "replace"),
                    resp.status,
                )
            ctype = resp.headers.get("Content-Type", "")
            try:
                if ctype.startswith(PROTO_CONTENT_TYPE):
                    return response_cls.FromString(body)
                return payloads.dict_to_message(body.decode(), response_cls)
            except Exception as e:
                # A 200 with an unparseable body (buggy foreign unit) is
                # a unit failure, not an engine crash — callers promise
                # ENGINE_UNIT_FAILURE semantics (docs/wrappers.md §2).
                raise UnitCallError(
                    ep.service_host, method,
                    f"unparseable {ctype or 'response'} body: {e}",
                ) from e


def _unit_name_of(identity: tuple, ep: Endpoint) -> str:
    """Unit name from the cached identity metadata (seldon-model-name);
    the endpoint host only as a last resort — failures must attribute to
    the UNIT, consistently across lanes."""
    for k, v in identity:
        if k == "seldon-model-name" and v:
            return v
    return ep.service_host


class SyncInternalClient(InternalClient):
    """BLOCKING gRPC variant for the sync servicer lane.

    The async walker code runs unchanged: these overrides are `async def`
    that complete without ever suspending (the blocking happens inside the
    call, on the gRPC worker thread), so `PredictorEngine.drive_sync` can
    drive a graph walk that leaves the process — the whole request then
    rides C-level completion queues (sync gRPC server + sync stubs) with
    no event loop anywhere on the hot path (the JAX package measured ~2x
    requests per engine core against the asyncio lane on linear graphs,
    on the host). Graphs that need
    fan-out parallelism (multi-child COMBINER) or REST/batched units stay
    on the async lane (see PredictorEngine.sync_drivable).
    """

    is_sync = True

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from seldon_tpu_torch.runtime.fastpath import FastClient

        self._fast = FastClient(timeout_s=self.timeout_s)

    def _channel(self, endpoint: Endpoint):
        addr = f"{endpoint.service_host}:{endpoint.service_port}"
        ch = self._channels.get(addr)
        if ch is None:
            ch = grpc.insecure_channel(addr, options=self._options)
            self._channels[addr] = ch
        return ch

    async def _fast_transport(self, ep: Endpoint, method: str, request):
        # Blocking (never-suspending) variant: per-thread persistent
        # sockets; error policy is the shared _fast_attempt.
        return self._fast.call(
            ep.service_host, ep.fast_port, method, request
        )

    async def _call_grpc(self, ep: Endpoint, method: str, request,
                         identity: tuple = ()):
        if self._fast_usable(ep):
            # awaiting _fast_attempt completes without suspending: the
            # overridden transport blocks instead of yielding.
            handled, out = await self._fast_attempt(
                ep, method, request, identity
            )
            if handled:
                return out
        rpc = self._rpc(ep, method)
        cur = tracing._current_span.get()
        if cur is None:
            metadata = identity or None
        else:
            d = dict(identity)
            d[tracing._TRACEPARENT] = cur.context.to_traceparent()
            metadata = tuple(d.items())
        return rpc(request, timeout=self.timeout_s, metadata=metadata)

    async def _backoff(self, attempt: int) -> None:
        import time

        time.sleep(0.05 * (attempt + 1))  # worker thread, not the loop

    async def _call_rest(self, ep: Endpoint, method: str, request,
                         response_cls, identity: tuple = ()):
        raise UnitCallError(
            _unit_name_of(identity, ep), method,
            "REST unit on the sync lane (sync_drivable should have "
            "excluded this graph)",
        )

    async def close(self):
        for ch in self._channels.values():
            ch.close()  # sync channels: close() is not awaitable
        self._channels.clear()
        self._rpcs.clear()
        self._fast.close()
