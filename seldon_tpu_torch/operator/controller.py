"""Operator entrypoint: watch SeldonDeployments, reconcile, serve webhooks.

Port of seldon_tpu/operator/controller.py (Seldon's operator/main.go:
controller-runtime manager registering the reconciler + admission
webhooks), reconciling into the port's pods. A plain list+watch loop
over the KubeStore REST client — no informer cache machinery; the
reconciler is already idempotent, so at-least-once event delivery plus a
periodic full resync gives the same convergence guarantees with ~100
lines instead of a framework.

Run: `python -m seldon_tpu_torch.operator.controller` (in-cluster), flags for
namespace / resync period / webhook port. The admission webhook server
implements AdmissionReview v1 over the SAME pure functions the CLI path
uses (webhook.py default_deployment/validate_deployment), so cluster and
library behavior can never drift.
"""

from __future__ import annotations

import base64
import copy
import json
import logging
import threading
import time
from typing import Dict, Optional

from seldon_tpu_torch.operator import types as T
from seldon_tpu_torch.operator.kubestore import KubeApiError, KubeStore
from seldon_tpu_torch.operator.reconciler import Reconciler
from seldon_tpu_torch.operator.webhook import default_deployment, validate_deployment

logger = logging.getLogger(__name__)


class ControllerLoop:
    """List+watch+reconcile until stopped."""

    def __init__(self, store: KubeStore, namespace: str = "default",
                 resync_s: float = 30.0, istio_enabled: bool = True):
        self.store = store
        self.namespace = namespace
        self.resync_s = resync_s
        self.reconciler = Reconciler(store, istio_enabled=istio_enabled)
        self._stop = threading.Event()
        self.reconcile_count = 0
        self._list_rv = ""

    def stop(self) -> None:
        self._stop.set()

    # -- one reconcile ------------------------------------------------------

    def reconcile_object(self, obj: Dict) -> Optional[T.DeploymentStatus]:
        try:
            sdep = T.SeldonDeployment.from_dict(obj)
        except Exception:
            logger.exception("unparseable SeldonDeployment: %s",
                             obj.get("metadata", {}).get("name"))
            return None
        status = self.reconciler.reconcile(sdep)
        self.reconcile_count += 1
        try:
            self.store.update_status(
                "SeldonDeployment", sdep.namespace, sdep.name,
                {"state": status.state, "description": status.description},
            )
        except KubeApiError as e:
            logger.warning("status update failed for %s: %s", sdep.name, e)
        return status

    def resync(self) -> int:
        """Full list + reconcile; returns number of objects handled.
        Remembers the list's resourceVersion so the following watch
        starts after it (no synthetic ADDED replay)."""
        lister = getattr(self.store, "list_with_version", None)
        if lister is not None:
            objs, self._list_rv = lister("SeldonDeployment", self.namespace)
        else:
            objs = self.store.list("SeldonDeployment", self.namespace)
            self._list_rv = ""
        for obj in objs:
            self.reconcile_object(obj)
        return len(objs)

    # -- the loop ------------------------------------------------------------

    def run(self) -> None:
        while not self._stop.is_set():
            try:
                self.resync()
                # timeout_s makes the SERVER close the watch at the resync
                # period, so quiet clusters still resync on schedule
                # instead of blocking in a long read.
                for event in self.store.watch(
                    "SeldonDeployment", self.namespace,
                    resource_version=self._list_rv,
                    timeout_s=self.resync_s,
                ):
                    if self._stop.is_set():
                        return
                    etype = event.get("type")
                    obj = event.get("object", {})
                    if etype in ("ADDED", "MODIFIED"):
                        self.reconcile_object(obj)
                    elif etype == "DELETED":
                        # ownerReferences cascade in-cluster; this explicit
                        # sweep covers stores without GC and pre-ownerRef
                        # resources.
                        meta = obj.get("metadata", {})
                        if meta.get("name"):
                            self.reconciler.delete_all(
                                meta["name"],
                                meta.get("namespace", self.namespace),
                            )
            except KubeApiError as e:
                logger.warning("watch/list failed (%s); retrying", e)
                self._stop.wait(2.0)
            except Exception:
                logger.exception("controller loop error; retrying")
                self._stop.wait(2.0)


# ---------------------------------------------------------------------------
# Admission webhooks (AdmissionReview v1)
# ---------------------------------------------------------------------------


def handle_admission_review(review: Dict, mutate: bool) -> Dict:
    """Pure AdmissionReview v1 handler shared by tests and the server.

    mutate=True -> defaulting webhook (JSONPatch response);
    mutate=False -> validating webhook (allowed true/false)."""
    req = review.get("request", {})
    uid = req.get("uid", "")
    obj = req.get("object", {}) or {}
    resp: Dict = {"uid": uid, "allowed": True}
    try:
        sdep = T.SeldonDeployment.from_dict(obj)
        if mutate:
            default_deployment(sdep)
            patched = sdep.to_dict()
            # Replace spec+metadata wholesale; k8s applies RFC-6902 patches.
            patch = [
                {"op": "replace", "path": "/spec", "value": patched["spec"]},
            ]
            resp["patchType"] = "JSONPatch"
            resp["patch"] = base64.b64encode(
                json.dumps(patch).encode()
            ).decode()
        else:
            default_deployment(sdep)  # validate what would actually deploy
            problems = validate_deployment(sdep)
            if problems:
                resp["allowed"] = False
                resp["status"] = {"message": "; ".join(problems)}
    except Exception as e:
        resp["allowed"] = False
        resp["status"] = {"message": f"malformed SeldonDeployment: {e}"}
    return {
        "apiVersion": "admission.k8s.io/v1",
        "kind": "AdmissionReview",
        "response": resp,
    }


def build_webhook_app():
    """aiohttp app serving /mutate and /validate."""
    from aiohttp import web

    async def mutate(request: web.Request) -> web.Response:
        return web.json_response(
            handle_admission_review(await request.json(), mutate=True)
        )

    async def validate(request: web.Request) -> web.Response:
        return web.json_response(
            handle_admission_review(await request.json(), mutate=False)
        )

    async def healthz(request: web.Request) -> web.Response:
        return web.Response(text="ok")

    app = web.Application()
    app.router.add_post("/mutate", mutate)
    app.router.add_post("/validate", validate)
    app.router.add_get("/healthz", healthz)
    return app


def main(argv=None) -> None:  # pragma: no cover - CLI entry
    import argparse

    parser = argparse.ArgumentParser(description="seldon-tpu operator")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--resync-seconds", type=float, default=30.0)
    parser.add_argument("--istio", type=int, default=1)
    parser.add_argument("--webhook-port", type=int, default=0,
                        help="serve admission webhooks when > 0")
    parser.add_argument("--api-server", default="",
                        help="override API server URL (tests)")
    args = parser.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    store = KubeStore(base_url=args.api_server or None)
    loop = ControllerLoop(store, namespace=args.namespace,
                          resync_s=args.resync_seconds,
                          istio_enabled=bool(args.istio))

    if args.webhook_port:
        import asyncio
        import os
        import ssl

        from aiohttp import web

        # The apiserver only calls webhooks over HTTPS; cert-manager (or
        # the operator chart) mounts the serving cert at WEBHOOK_CERT_DIR
        # (default: the conventional controller-runtime path).
        cert_dir = os.environ.get(
            "WEBHOOK_CERT_DIR", "/tmp/k8s-webhook-server/serving-certs"
        )
        crt = os.path.join(cert_dir, "tls.crt")
        key = os.path.join(cert_dir, "tls.key")
        ssl_ctx = None
        if os.path.exists(crt) and os.path.exists(key):
            ssl_ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ssl_ctx.load_cert_chain(crt, key)
        else:
            logger.warning(
                "no webhook TLS cert at %s — serving PLAINTEXT "
                "(dev only; the apiserver requires HTTPS)", cert_dir,
            )

        def serve_webhooks():
            async def run():
                runner = web.AppRunner(build_webhook_app())
                await runner.setup()
                await web.TCPSite(
                    runner, "0.0.0.0", args.webhook_port, ssl_context=ssl_ctx
                ).start()
                while True:
                    await asyncio.sleep(3600)

            asyncio.run(run())

        threading.Thread(target=serve_webhooks, daemon=True).start()

    loop.run()


if __name__ == "__main__":  # pragma: no cover
    main()
