"""Request/response logging: CloudEvents pairs POSTed to a logging sink.

Port of seldon_tpu/orchestrator/reqlogger.py. The engine optionally (a)
dumps raw request/response JSON to stdout (`SELDON_LOG_REQUESTS/
RESPONSES`) and (b) POSTs CloudEvents-style message pairs to
`SELDON_MESSAGE_LOGGING_SERVICE` with `CE-*` headers, consumed by the
flattening sink below (Seldon's request logger). The CloudEvents headers
and documents are the JAX package's, byte for byte.

Logging must NEVER stall the serving hot loop — a
bounded asyncio queue with a single drainer task; events are dropped
(and counted) when the sink can't keep up, instead of backpressuring
prediction latency. Payloads ship as SeldonMessage JSON, one event for
the request and one for the response, correlated by puid.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import time
from typing import Optional

from seldon_tpu_torch.core import payloads
from seldon_tpu_torch.proto import prediction_pb2 as pb

logger = logging.getLogger(__name__)

ENV_SINK = "SELDON_MESSAGE_LOGGING_SERVICE"
ENV_LOG_REQUESTS = "SELDON_LOG_REQUESTS"
ENV_LOG_RESPONSES = "SELDON_LOG_RESPONSES"

CE_TYPE_REQUEST = "io.seldon.serving.inference.request"
CE_TYPE_RESPONSE = "io.seldon.serving.inference.response"


class RequestLogger:
    """Fire-and-forget CloudEvents shipper + optional stdout raw logs."""

    def __init__(
        self,
        sink_url: Optional[str] = None,
        log_requests: Optional[bool] = None,
        log_responses: Optional[bool] = None,
        deployment: str = "",
        predictor: str = "",
        max_queue: int = 1024,
    ):
        def env_flag(name):
            return os.environ.get(name, "false").lower() in ("1", "true")

        self.sink_url = sink_url if sink_url is not None else os.environ.get(ENV_SINK, "")
        self.log_requests = (
            log_requests if log_requests is not None else env_flag(ENV_LOG_REQUESTS)
        )
        self.log_responses = (
            log_responses if log_responses is not None else env_flag(ENV_LOG_RESPONSES)
        )
        self.deployment = deployment
        self.predictor = predictor
        self.max_queue = max_queue
        self.dropped = 0
        self.sent = 0
        self._queue: Optional[asyncio.Queue] = None
        self._drainer: Optional[asyncio.Task] = None
        self._session = None

    @property
    def enabled(self) -> bool:
        return bool(self.sink_url) or self.log_requests or self.log_responses

    # --- hot-path entry (sync, never blocks) --------------------------------

    def log_pair(self, request: pb.SeldonMessage, response: pb.SeldonMessage,
                 puid: str) -> None:
        """Called from the serving path after each prediction."""
        if not self.enabled:
            return
        if self.log_requests:
            print("Request: "
                  + json.dumps(payloads.message_to_dict(request)), flush=True)
        if self.log_responses:
            print("Response: "
                  + json.dumps(payloads.message_to_dict(response)), flush=True)
        if not self.sink_url:
            return
        if self._queue is None:
            self._queue = asyncio.Queue(maxsize=self.max_queue)
            self._drainer = asyncio.get_running_loop().create_task(
                self._drain()
            )
        for ce_type, msg in (
            (CE_TYPE_REQUEST, request),
            (CE_TYPE_RESPONSE, response),
        ):
            try:
                # Serialize with the proto C++ fast path only; the O(payload)
                # python dict conversion happens in the drainer, off the
                # serving hot loop.
                self._queue.put_nowait(
                    (ce_type, msg.SerializeToString(), puid)
                )
            except asyncio.QueueFull:
                self.dropped += 1

    # --- drainer ------------------------------------------------------------

    async def _drain(self) -> None:
        try:
            import aiohttp

            self._session = aiohttp.ClientSession()
        except Exception:
            logger.exception("request-logger drainer failed to start; "
                             "events will be dropped")
            while True:  # keep consuming so close() can flush
                await self._queue.get()
                self.dropped += 1
        while True:
            ce_type, raw, puid = await self._queue.get()
            body = payloads.message_to_dict(pb.SeldonMessage.FromString(raw))
            # CloudEvents ids must be unique per (source, id): dedup-capable
            # sinks drop one of a same-id pair, losing half the record. The
            # request/response correlation rides Ce-Requestid (= puid),
            # matching Seldon's request logger.
            kind = "request" if ce_type == CE_TYPE_REQUEST else "response"
            headers = {
                "Content-Type": "application/json",
                "CE-SpecVersion": "0.2",
                "CE-Type": ce_type,
                "CE-Source": "seldon-tpu-engine",
                "CE-Id": f"{puid}-{kind}",
                "CE-Time": time.strftime(
                    "%Y-%m-%dT%H:%M:%SZ", time.gmtime()
                ),
                "Ce-Requestid": puid,
                "Ce-Deploymentname": self.deployment,
                "Ce-Predictorname": self.predictor,
            }
            try:
                async with self._session.post(
                    self.sink_url, json=body, headers=headers, timeout=2
                ) as resp:
                    await resp.read()
                    if resp.status < 400:
                        self.sent += 1
                    else:
                        self.dropped += 1
            except Exception as e:
                self.dropped += 1
                logger.debug("request-logger sink unreachable: %s", e)

    async def close(self, flush_timeout_s: float = 2.0) -> None:
        if self._drainer is not None:
            # Best-effort flush with a deadline: never let a dead drainer
            # or a slow sink hold up server shutdown.
            deadline = time.monotonic() + flush_timeout_s
            while (
                self._queue is not None
                and not self._queue.empty()
                and not self._drainer.done()
                and time.monotonic() < deadline
            ):
                await asyncio.sleep(0.01)
            self._drainer.cancel()
            try:
                await self._drainer
            except asyncio.CancelledError:
                pass
            self._drainer = None
        if self._session is not None:
            await self._session.close()
            self._session = None


def build_sink_app(store=None, echo: bool = False):
    """The logging SINK: an aiohttp app accepting the engine's CloudEvents
    and flattening tensor payloads into per-row JSON docs for fluentd/ELK
    (Seldon's request logger).

    `store`: optional list to collect flattened docs (tests / in-process
    pipelines); docs also print to stdout when echo=True.
    """
    from aiohttp import web

    docs = store if store is not None else []

    async def handle(request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except Exception:
            return web.json_response({"error": "bad json"}, status=400)
        ce_type = request.headers.get("CE-Type", "")
        puid = request.headers.get("Ce-Requestid",
                                   request.headers.get("CE-Id", ""))
        flat = _flatten(body, ce_type, puid, dict(request.headers))
        for doc in flat:
            docs.append(doc)
            if echo:
                print(json.dumps(doc), flush=True)
        return web.json_response({"ingested": len(flat)})

    async def dump(request: web.Request) -> web.Response:
        return web.json_response(list(docs)[-1000:])

    async def healthz(request: web.Request) -> web.Response:
        return web.json_response({"docs": len(docs)})

    app = web.Application()
    app.router.add_post("/", handle)
    app.router.add_get("/dump", dump)
    app.router.add_get("/healthz", healthz)
    app["docs"] = docs
    return app


def _flatten(body: dict, ce_type: str, puid: str, headers: dict):
    """SeldonMessage JSON -> one doc per batch row (tensor/ndarray data);
    non-tensor payloads pass through as a single doc."""
    base = {
        "ce_type": ce_type,
        "request_id": puid,
        "deployment": headers.get("Ce-Deploymentname", ""),
        "predictor": headers.get("Ce-Predictorname", ""),
        "kind": "request" if ce_type.endswith(".request") else "response",
    }
    data = body.get("data")
    if not isinstance(data, dict):
        out = dict(base)
        out["payload"] = {
            k: v for k, v in body.items() if k not in ("meta", "status")
        }
        return [out]
    names = data.get("names") or []
    rows = None
    if "ndarray" in data:
        rows = data["ndarray"]
    elif "tensor" in data:
        shape = data["tensor"].get("shape", [])
        values = data["tensor"].get("values", [])
        if len(shape) == 2:
            rows = [
                values[i * shape[1]: (i + 1) * shape[1]]
                for i in range(shape[0])
            ]
    elif "dense" in data:
        # bf16 dense payloads arrive base64-packed; keep shape info only
        # (the sink is a CPU text pipeline — decoding bf16 here would
        # just re-encode it as text anyway).
        out = dict(base)
        out["dense_shape"] = data["dense"].get("shape", [])
        return [out]
    if rows is None:
        out = dict(base)
        out["data"] = data
        return [out]
    docs = []
    for i, row in enumerate(rows):
        doc = dict(base)
        doc["batch_index"] = i
        if isinstance(row, list) and names and len(names) == len(row):
            doc.update({str(n): v for n, v in zip(names, row)})
        else:
            doc["row"] = row
        docs.append(doc)
    return docs


def main(argv=None) -> None:  # pragma: no cover - CLI entry
    """Run the flattening sink standalone (Seldon's request-logger
    container): engines POST CloudEvents here.
    The durable output is the stdout echo (fluentd/ELK pick it up); the
    in-memory store is a BOUNDED ring so a long-lived pod can't OOM."""
    import argparse
    import collections

    from aiohttp import web

    parser = argparse.ArgumentParser(description="seldon-tpu request logger")
    parser.add_argument("--port", type=int,
                        default=int(os.environ.get("PORT", "8080")))
    parser.add_argument("--quiet", action="store_true",
                        help="don't echo flattened docs to stdout")
    parser.add_argument("--keep", type=int, default=1000,
                        help="docs retained for /dump")
    args = parser.parse_args(argv)

    async def run():
        store = collections.deque(maxlen=args.keep)
        runner = web.AppRunner(
            build_sink_app(store=store, echo=not args.quiet)
        )
        await runner.setup()
        await web.TCPSite(runner, "0.0.0.0", args.port).start()
        logger.info("request-logger sink on :%d", args.port)
        while True:
            await asyncio.sleep(3600)

    logging.basicConfig(level=logging.INFO)
    asyncio.run(run())


if __name__ == "__main__":  # pragma: no cover
    main()
