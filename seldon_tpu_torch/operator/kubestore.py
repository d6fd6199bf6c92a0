"""KubeStore: the reconciler's Store protocol over the real k8s API.

Port of seldon_tpu/operator/kubestore.py, unchanged (its requests are the
JAX store's, byte for byte). Seldon's Go operator uses controller-runtime's
client; the operator needs only five verbs, so this speaks the k8s REST
API directly (requests + bearer token) with no kubernetes package:

  apply  -> GET; 404 ? POST : PUT (resourceVersion carried over)
  delete -> DELETE
  list   -> GET ?labelSelector=
  is_ready -> GET status (readyReplicas >= replicas for workloads)
  watch  -> GET ?watch=true chunked JSON stream (controller loop)

Config resolution: in-cluster service account
(/var/run/secrets/kubernetes.io/serviceaccount) first, then
$KUBECONFIG/~/.kube/config (token / client-cert auth).
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, Dict, Iterator, List, Optional, Tuple

logger = logging.getLogger(__name__)

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"

# kind -> (api prefix, plural). Everything the reconciler emits.
KIND_ROUTES: Dict[str, Tuple[str, str]] = {
    "Deployment": ("apis/apps/v1", "deployments"),
    "StatefulSet": ("apis/apps/v1", "statefulsets"),
    "Service": ("api/v1", "services"),
    "HorizontalPodAutoscaler": ("apis/autoscaling/v2",
                                "horizontalpodautoscalers"),
    "VirtualService": ("apis/networking.istio.io/v1beta1",
                       "virtualservices"),
    "DestinationRule": ("apis/networking.istio.io/v1beta1",
                        "destinationrules"),
    "SeldonDeployment": ("apis/machinelearning.seldon.io/v1alpha3",
                         "seldondeployments"),
    # Read-only kinds for credential injection (operator/credentials.py).
    "ConfigMap": ("api/v1", "configmaps"),
    "Secret": ("api/v1", "secrets"),
    "ServiceAccount": ("api/v1", "serviceaccounts"),
}


class KubeApiError(Exception):
    def __init__(self, status: int, body: str):
        super().__init__(f"k8s API {status}: {body[:200]}")
        self.status = status
        self.body = body


class KubeStore:
    """Store protocol (reconciler.py) against a live API server."""

    def __init__(self, base_url: Optional[str] = None,
                 token: Optional[str] = None,
                 verify: Any = None,
                 session=None):
        import requests

        self.session = session or requests.Session()
        cert = None
        if base_url is None:
            base_url, token, verify, cert = self._resolve_config(
                token, verify
            )
        self.base_url = base_url.rstrip("/")
        if token:
            self.session.headers["Authorization"] = f"Bearer {token}"
        if cert is not None:
            self.session.cert = cert
        if verify is not None:
            self.session.verify = verify

    @staticmethod
    def _resolve_config(token, verify):
        """In-cluster service account, else kubeconfig.
        Returns (base_url, token, verify, client_cert_pair)."""
        token_path = os.path.join(SA_DIR, "token")
        if os.path.exists(token_path):
            host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
            port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            with open(token_path) as f:
                token = token or f.read().strip()
            ca = os.path.join(SA_DIR, "ca.crt")
            return (f"https://{host}:{port}", token,
                    ca if os.path.exists(ca) else verify, None)
        import yaml

        path = os.environ.get("KUBECONFIG",
                              os.path.expanduser("~/.kube/config"))
        with open(path) as f:
            cfg = yaml.safe_load(f)
        ctx_name = cfg.get("current-context")
        ctx = next(c["context"] for c in cfg["contexts"]
                   if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in cfg["clusters"]
                       if c["name"] == ctx["cluster"])
        user = next(u["user"] for u in cfg["users"]
                    if u["name"] == ctx["user"])
        token = token or user.get("token")
        verify = cluster.get("certificate-authority",
                             not cluster.get("insecure-skip-tls-verify",
                                             False))
        cert = user.get("client-certificate")
        key = user.get("client-key")
        if not token and not (cert and key):
            raise RuntimeError(
                "kubeconfig user has neither a token nor client-certificate/"
                "client-key; embedded *-data credentials are not supported — "
                "use file paths or a token"
            )
        return cluster["server"], token, verify, (
            (cert, key) if cert and key else None
        )

    # -- plumbing ------------------------------------------------------------

    def _url(self, kind: str, namespace: str, name: str = "") -> str:
        prefix, plural = KIND_ROUTES[kind]
        url = f"{self.base_url}/{prefix}/namespaces/{namespace}/{plural}"
        return f"{url}/{name}" if name else url

    def _req(self, method: str, url: str, **kw):
        r = self.session.request(method, url, timeout=30, **kw)
        if r.status_code >= 400:
            raise KubeApiError(r.status_code, r.text)
        return r.json() if r.content else {}

    # -- Store protocol ------------------------------------------------------

    def apply(self, manifest: Dict) -> None:
        kind = manifest["kind"]
        meta = manifest["metadata"]
        ns = meta.get("namespace", "default")
        name = meta["name"]
        url = self._url(kind, ns, name)
        try:
            existing = self._req("GET", url)
        except KubeApiError as e:
            if e.status != 404:
                raise
            self._req("POST", self._url(kind, ns), json=manifest)
            return
        # Update: carry the live resourceVersion (k8s optimistic locking).
        manifest = dict(manifest)
        manifest["metadata"] = dict(meta)
        rv = existing.get("metadata", {}).get("resourceVersion")
        if rv:
            manifest["metadata"]["resourceVersion"] = rv
        # Workloads whose manifest omits spec.replicas (HPA owns scaling)
        # must keep the LIVE count: a PUT with nil replicas would let the
        # apiserver default it to 1, stomping the autoscaler every resync.
        if kind in ("Deployment", "StatefulSet"):
            spec = manifest.get("spec", {})
            live = existing.get("spec", {}).get("replicas")
            if "replicas" not in spec and live is not None:
                manifest["spec"] = dict(spec, replicas=live)
        self._req("PUT", url, json=manifest)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        try:
            self._req("DELETE", self._url(kind, namespace, name))
        except KubeApiError as e:
            if e.status != 404:
                raise

    def get(self, kind: str, namespace: str, name: str) -> Optional[Dict]:
        """Single-object GET (None on 404) — credential injection reads
        ConfigMap/ServiceAccount/Secret by name without the O(namespace)
        payload of a LIST."""
        try:
            obj = self._req("GET", self._url(kind, namespace, name))
        except KubeApiError as e:
            if e.status == 404:
                return None
            raise
        obj.setdefault("kind", kind)
        return obj

    def list(self, kind: str, namespace: str,
             label_selector: Optional[Dict[str, str]] = None) -> List[Dict]:
        items, _ = self.list_with_version(kind, namespace, label_selector)
        return items

    def list_with_version(
        self, kind: str, namespace: str,
        label_selector: Optional[Dict[str, str]] = None,
    ) -> Tuple[List[Dict], str]:
        """(items, list resourceVersion) — feed the version into watch()
        so the stream starts AFTER this list instead of replaying ADDED
        for every existing object."""
        params = {}
        if label_selector:
            params["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items())
            )
        out = self._req("GET", self._url(kind, namespace), params=params)
        items = out.get("items", [])
        for item in items:  # list items omit kind/apiVersion in k8s
            item.setdefault("kind", kind)
        return items, out.get("metadata", {}).get("resourceVersion", "")

    def is_ready(self, kind: str, namespace: str, name: str) -> bool:
        try:
            obj = self._req("GET", self._url(kind, namespace, name))
        except KubeApiError:
            return False
        if kind in ("Deployment", "StatefulSet"):
            spec_replicas = obj.get("spec", {}).get("replicas", 1)
            ready = obj.get("status", {}).get("readyReplicas", 0)
            return ready >= spec_replicas
        return True

    # -- CR access (controller loop) ----------------------------------------

    def get_status(self, kind: str, namespace: str, name: str) -> Dict:
        return self._req("GET", self._url(kind, namespace, name))

    def update_status(self, kind: str, namespace: str, name: str,
                      status: Dict) -> None:
        url = self._url(kind, namespace, name) + "/status"
        try:
            self._req(
                "PATCH", url, json={"status": status},
                headers={"Content-Type": "application/merge-patch+json"},
            )
        except KubeApiError as e:
            if e.status == 404:
                # CRD without a status subresource: patch the main object.
                self._req(
                    "PATCH", self._url(kind, namespace, name),
                    json={"status": status},
                    headers={"Content-Type": "application/merge-patch+json"},
                )
            else:
                raise

    def watch(self, kind: str, namespace: str,
              resource_version: str = "",
              timeout_s: float = 300.0) -> Iterator[Dict]:
        """Yield {type: ADDED|MODIFIED|DELETED, object: {...}} events from a
        chunked watch stream; returns when the server closes it (the
        controller loop re-lists and re-watches). `timeout_s` is sent as
        k8s `timeoutSeconds` so the SERVER ends the watch cleanly at the
        caller's resync period."""
        params: Dict[str, Any] = {
            "watch": "true",
            "timeoutSeconds": max(1, int(timeout_s)),
        }
        if resource_version:
            params["resourceVersion"] = resource_version
        r = self.session.get(
            self._url(kind, namespace), params=params, stream=True,
            timeout=(10, timeout_s + 10),
        )
        if r.status_code >= 400:
            raise KubeApiError(r.status_code, r.text)
        try:
            for line in r.iter_lines():
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    logger.warning("unparseable watch line: %r", line[:200])
        finally:
            r.close()
