"""Engine external API: REST + gRPC + admin surface.

Port of seldon_tpu/orchestrator/server.py: REST /api/v0.1/predictions,
/feedback, /ping, /ready, /live, /pause, /unpause, /prometheus and
/seldon.json; gRPC Seldon.Predict / SendFeedback, on the sync
thread-pool lane where the graph allows it and on grpc.aio otherwise.
One asyncio process serves all of it; `--workers N` runs N of them on
one port (SO_REUSEPORT).

    ENGINE_PREDICTOR=<base64 spec JSON> python -m \
        seldon_tpu_torch.orchestrator.server --http-port 8000 --grpc-port 5001
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Optional

import grpc
import grpc.aio
from aiohttp import web

from seldon_tpu_torch.core import payloads, tracing
from seldon_tpu_torch.core.annotations import AnnotationsConfig
from seldon_tpu_torch.core.http import PROTO_CONTENT_TYPE, parse_message, reply
from seldon_tpu_torch.orchestrator.batcher import MicroBatcher
from seldon_tpu_torch.orchestrator.client import (
    InternalClient,
    SyncInternalClient,
    UnitCallError,
)
from seldon_tpu_torch.orchestrator.reqlogger import RequestLogger
from seldon_tpu_torch.orchestrator.spec import (
    HARDCODED_IMPLEMENTATIONS,
    PredictorSpec,
    load_predictor_spec,
)
from seldon_tpu_torch.orchestrator.walker import PredictorEngine
from seldon_tpu_torch.proto import prediction_grpc
from seldon_tpu_torch.proto import prediction_pb2 as pb
from seldon_tpu_torch.runtime.metrics_server import ServerMetrics, get_default_metrics

logger = logging.getLogger(__name__)

class GraphReadyChecker:
    """Recursive TCP ping of every microservice endpoint (Seldon's graph
    readiness check: 3 attempts x 500ms)."""

    def __init__(self, spec: PredictorSpec, attempts: int = 3,
                 timeout_s: float = 0.5):
        self.endpoints = [
            (u.endpoint.service_host, u.endpoint.service_port)
            for u in spec.graph.walk()
            if u.endpoint is not None
            and u.implementation not in HARDCODED_IMPLEMENTATIONS
        ]
        self.attempts = attempts
        self.timeout_s = timeout_s

    async def ready(self) -> bool:
        for host, port in self.endpoints:
            ok = False
            for _ in range(self.attempts):
                try:
                    _, writer = await asyncio.wait_for(
                        asyncio.open_connection(host, port), self.timeout_s
                    )
                    writer.close()
                    ok = True
                    break
                except (OSError, asyncio.TimeoutError):
                    await asyncio.sleep(0.05)
            if not ok:
                return False
        return True


class EngineServer:
    """The per-predictor orchestrator process."""

    def __init__(
        self,
        spec: Optional[PredictorSpec] = None,
        http_port: int = 8000,
        grpc_port: int = 5001,
        enable_batching: bool = True,
        metrics: Optional[ServerMetrics] = None,
    ):
        self.spec = spec or load_predictor_spec()
        self.http_port = http_port
        self.grpc_port = grpc_port
        self.metrics = metrics or get_default_metrics()
        self.reqlogger = RequestLogger(predictor=self.spec.name)
        self.batcher = MicroBatcher() if enable_batching else None
        # Runtime knobs from CR annotations via the downward-API podinfo
        # mount (Seldon's AnnotationsConfig; no-op outside a pod).
        self.annotations = AnnotationsConfig()
        self.grpc_max_msg = self.annotations.grpc_max_msg_bytes()
        self.engine = PredictorEngine(
            self.spec,
            client=InternalClient(
                timeout_s=self.annotations.rest_timeout_s(30000),
                retries=self.annotations.connect_retries(3),
                max_message_bytes=self.grpc_max_msg,
            ),
            batcher=self.batcher,
            metrics_hook=self._on_custom_metric,
            reward_hook=self._on_reward,
        )
        # A second engine over a BLOCKING gRPC client backs the sync
        # thread-pool gRPC lane whenever the graph allows it (linear or
        # router graphs with gRPC-endpoint units, unbatched) — the lane
        # used to require a fully in-process graph; now every deployed
        # gRPC-unit graph rides C completion queues instead of asyncio.
        # The asyncio engine still serves REST and any non-eligible graph.
        self.engine_sync: Optional[PredictorEngine] = None
        if PredictorEngine.sync_drivable(self.spec, self.batcher):
            self.engine_sync = PredictorEngine(
                self.spec,
                client=SyncInternalClient(
                    timeout_s=self.annotations.rest_timeout_s(30000),
                    retries=self.annotations.connect_retries(3),
                    max_message_bytes=self.grpc_max_msg,
                ),
                batcher=None,
                metrics_hook=self._on_custom_metric,
                reward_hook=self._on_reward,
            )
        self.ready_checker = GraphReadyChecker(self.spec)
        self.paused = False  # /pause drains traffic before pod kill
        self._grpc_server: Optional[grpc.aio.Server] = None
        self._runner: Optional[web.AppRunner] = None

    def _on_custom_metric(self, metric: pb.Metric, unit) -> None:
        self.metrics.record_custom([metric])

    def _on_reward(self, unit, reward: float) -> None:
        self.metrics.record_reward(unit.name, reward)

    # --- REST ---------------------------------------------------------------

    def build_app(self) -> web.Application:
        app = web.Application(client_max_size=1024**3)
        parse = parse_message  # shared proto/JSON negotiation (core/http.py)

        async def predictions(request: web.Request) -> web.Response:
            if self.paused:
                return web.json_response({"error": "paused"}, status=503)
            t0 = time.perf_counter()
            try:
                msg, enc = await parse(request, pb.SeldonMessage)
            except web.HTTPBadRequest:
                raise
            except Exception as e:
                return web.json_response({"error": str(e)}, status=400)
            try:
                out = await self.engine.predict(
                    msg, trace_parent=tracing.Tracer.extract(request.headers)
                )
            except UnitCallError as e:
                return web.json_response(
                    {"status": {"status": 1, "info": str(e), "code": -1,
                                "reason": "ENGINE_UNIT_FAILURE"}},
                    status=500,
                )
            self.metrics.observe("predictions", "rest",
                                 time.perf_counter() - t0, out)
            self.reqlogger.log_pair(msg, out, out.meta.puid)
            return reply(out, enc)

        async def feedback(request: web.Request) -> web.Response:
            if self.paused:
                return web.json_response({"error": "paused"}, status=503)
            t0 = time.perf_counter()
            try:
                fb, enc = await parse(request, pb.Feedback)
            except Exception as e:
                return web.json_response({"error": str(e)}, status=400)
            out = await self.engine.send_feedback(fb)
            self.metrics.observe("feedback", "rest",
                                 time.perf_counter() - t0, out)
            return reply(out, enc)

        async def ready(request: web.Request) -> web.Response:
            if self.paused:
                return web.Response(status=503, text="paused")
            is_ready = await self.ready_checker.ready()
            self.metrics.set_graph_ready(is_ready)  # seldon_graph_ready gauge
            if is_ready:
                return web.Response(text="ready")
            return web.Response(status=503, text="graph not ready")

        async def live(request: web.Request) -> web.Response:
            return web.Response(text="live")

        async def pause(request: web.Request) -> web.Response:
            self.paused = True
            return web.Response(text="paused")

        async def unpause(request: web.Request) -> web.Response:
            self.paused = False
            return web.Response(text="unpaused")

        async def metrics_handler(request: web.Request) -> web.Response:
            body, ctype = self.metrics.export()
            return web.Response(body=body, content_type=ctype.split(";")[0])

        app.router.add_post("/api/v0.1/predictions", predictions)
        app.router.add_post("/api/v1.0/predictions", predictions)
        app.router.add_post("/predict", predictions)
        app.router.add_post("/api/v0.1/feedback", feedback)
        app.router.add_post("/api/v1.0/feedback", feedback)
        app.router.add_get("/ping", live)
        app.router.add_get("/live", live)
        app.router.add_get("/ready", ready)
        app.router.add_get("/pause", pause)
        app.router.add_post("/pause", pause)
        app.router.add_get("/unpause", unpause)
        app.router.add_post("/unpause", unpause)
        app.router.add_get("/prometheus", metrics_handler)
        app.router.add_get("/metrics", metrics_handler)

        async def openapi_handler(request: web.Request) -> web.Response:
            from seldon_tpu_torch.core.openapi import engine_openapi

            return web.json_response(engine_openapi(self.spec.name))

        app.router.add_get("/seldon.json", openapi_handler)
        return app

    # --- gRPC ---------------------------------------------------------------

    class _SeldonServicer:
        def __init__(self, outer: "EngineServer"):
            self.outer = outer

        async def Predict(self, request, context):
            if self.outer.paused:
                await context.abort(grpc.StatusCode.UNAVAILABLE, "paused")
            t0 = time.perf_counter()
            try:
                out = await self.outer.engine.predict(
                    request,
                    trace_parent=tracing.Tracer.extract(
                        context.invocation_metadata()
                    ),
                )
            except UnitCallError as e:
                await context.abort(grpc.StatusCode.INTERNAL, str(e))
                return
            self.outer.metrics.observe(
                "predictions", "grpc", time.perf_counter() - t0, out
            )
            self.outer.reqlogger.log_pair(request, out, out.meta.puid)
            return out

        async def SendFeedback(self, request, context):
            if self.outer.paused:
                await context.abort(grpc.StatusCode.UNAVAILABLE, "paused")
            t0 = time.perf_counter()
            out = await self.outer.engine.send_feedback(request)
            self.outer.metrics.observe(
                "feedback", "grpc", time.perf_counter() - t0, out
            )
            return out

    class _SeldonServicerSync:
        """Thread-pool servicer for fully in-process graphs.

        grpc.aio's per-call task/future machinery costs more CPU than the
        entire graph walk when no unit leaves the process; the sync
        server's C completion queues + worker threads drive the (never-
        suspending) walker coroutine directly (PredictorEngine.drive_sync)
        (the JAX package measured ~2x requests per server-core on the
        host). Network graphs that fan out keep the asyncio servicer:
        their parallelism needs the loop."""

        def __init__(self, outer: "EngineServer", loop):
            self.outer = outer
            self._loop = loop  # for thread-safe reqlogger handoff

        def Predict(self, request, context):
            outer = self.outer
            if outer.paused:
                context.abort(grpc.StatusCode.UNAVAILABLE, "paused")
            t0 = time.perf_counter()
            try:
                out = outer.engine_sync.predict_sync(
                    request,
                    trace_parent=(
                        tracing.Tracer.extract(context.invocation_metadata())
                        if outer.engine_sync.tracer.enabled else None
                    ),
                )
            except UnitCallError as e:
                context.abort(grpc.StatusCode.INTERNAL, str(e))
                return
            outer.metrics.observe(
                "predictions", "grpc", time.perf_counter() - t0, out
            )
            if outer.reqlogger.enabled:
                # log_pair touches the asyncio sink queue — marshal onto
                # the loop; no-op cost when logging is off.
                self._loop.call_soon_threadsafe(
                    outer.reqlogger.log_pair, request, out, out.meta.puid
                )
            return out

        def SendFeedback(self, request, context):
            # Mirrors the async servicer exactly: pause semantics and the
            # feedback counter must not depend on which lane a graph rides.
            if self.outer.paused:
                context.abort(grpc.StatusCode.UNAVAILABLE, "paused")
            t0 = time.perf_counter()
            out = self.outer.engine_sync.drive_sync(
                self.outer.engine_sync.send_feedback(request)
            )
            self.outer.metrics.observe(
                "feedback", "grpc", time.perf_counter() - t0, out
            )
            return out

    async def start(self, host: str = "0.0.0.0", reuse_port: bool = False):
        app = self.build_app()
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host, self.http_port,
                           reuse_port=reuse_port or None)
        await site.start()
        self.http_port = site._server.sockets[0].getsockname()[1]

        grpc_options = [
            ("grpc.max_send_message_length", self.grpc_max_msg),
            ("grpc.max_receive_message_length", self.grpc_max_msg),
            # Worker processes share the port (kernel load-balanced).
            ("grpc.so_reuseport", 1 if reuse_port else 0),
        ]
        if self.engine_sync is not None:
            from concurrent import futures

            self._grpc_server = grpc.server(
                futures.ThreadPoolExecutor(
                    # The JAX package's setting (its CPU benchmark of this
                    # lane); more workers convoy on the GIL, and blocking
                    # unit hops release it, so 8 still overlaps plenty of
                    # in-flight requests.
                    max_workers=int(
                        os.environ.get("SELDON_TPU_GRPC_WORKERS", "8")
                    )
                ),
                options=grpc_options,
            )
            prediction_grpc.add_servicer(
                self._grpc_server, "Seldon",
                self._SeldonServicerSync(self, asyncio.get_running_loop()),
            )
            self.grpc_port = self._grpc_server.add_insecure_port(
                f"{host}:{self.grpc_port}"
            )
            self._grpc_server.start()
        else:
            self._grpc_server = grpc.aio.server(options=grpc_options)
            prediction_grpc.add_servicer(
                self._grpc_server, "Seldon", self._SeldonServicer(self)
            )
            self.grpc_port = self._grpc_server.add_insecure_port(
                f"{host}:{self.grpc_port}"
            )
            await self._grpc_server.start()
        logger.info(
            "engine up: http=%d grpc=%d graph=%s",
            self.http_port, self.grpc_port, self.spec.graph.name,
        )

    async def stop(self):
        if self._grpc_server is not None:
            stopping = self._grpc_server.stop(grace=1.0)
            if asyncio.iscoroutine(stopping):
                await stopping  # aio server
            else:
                # Sync server returns a threading.Event; waiting inline
                # would block the loop (and /ready answers) during drain.
                await asyncio.get_running_loop().run_in_executor(
                    None, stopping.wait, 5
                )
        if self._runner is not None:
            await self._runner.cleanup()
        await self.reqlogger.close()
        await self.engine.close()
        if self.engine_sync is not None:
            await self.engine_sync.close()


def _worker_main(http_port: int, grpc_port: int, enable_batching: bool,
                 reuse_port: bool) -> None:
    logging.basicConfig(level=logging.INFO)
    server = EngineServer(
        http_port=http_port, grpc_port=grpc_port,
        enable_batching=enable_batching,
    )

    async def run():
        await server.start(reuse_port=reuse_port)
        while True:
            await asyncio.sleep(3600)

    asyncio.run(run())


def main():  # pragma: no cover - CLI entry
    import argparse
    import os

    parser = argparse.ArgumentParser(description="seldon-tpu engine")
    parser.add_argument("--http-port", type=int, default=8000)
    parser.add_argument("--grpc-port", type=int, default=5001)
    parser.add_argument("--no-batching", action="store_true")
    parser.add_argument(
        "--workers", type=int,
        default=int(os.environ.get("ENGINE_WORKERS", "1")),
        help="event-loop processes sharing the ports via SO_REUSEPORT "
             "(the asyncio engine is single-core; Seldon's Java "
             "engine used every core of its n1-standard-16)",
    )
    args = parser.parse_args()

    if args.workers > 1:
        import multiprocessing as mp
        import signal

        procs = [
            mp.Process(
                target=_worker_main,
                args=(args.http_port, args.grpc_port,
                      not args.no_batching, True),
                daemon=False,
            )
            for _ in range(args.workers)
        ]
        for p in procs:
            p.start()

        def shutdown(signum, frame):
            # Propagate termination: otherwise SIGTERM (k8s pod stop)
            # kills only the supervisor and orphans bound workers.
            for p in procs:
                if p.is_alive():
                    p.terminate()

        signal.signal(signal.SIGTERM, shutdown)
        signal.signal(signal.SIGINT, shutdown)
        try:
            for p in procs:
                p.join()
        finally:
            shutdown(None, None)
            for p in procs:
                p.join(timeout=5)
    else:
        _worker_main(args.http_port, args.grpc_port,
                     not args.no_batching, False)


if __name__ == "__main__":  # pragma: no cover
    main()
