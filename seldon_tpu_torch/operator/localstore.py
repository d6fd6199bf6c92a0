"""LocalProcessStore: reconciler manifests become REAL local processes.

Port of seldon_tpu/operator/localstore.py. Seldon's e2e tier runs a kind
cluster and asserts HTTP responses through the full control->data plane.
This store gives the same assurance one level down: `apply` of a
Deployment manifest SPAWNS the pod's containers as subprocesses (the
port's engine + unit microservices, the commands the images would run),
`delete` terminates them, and readiness means the processes' ports
actually accept connections (the engine's graph spec is rewritten to the
units' live localhost ports — the job kube DNS + Services do
in-cluster).

Where it differs from the JAX store (the translation table of
`operator/__init__.py`): pods run `seldon_tpu_torch` modules; a pod's
environment is the caller's (no `JAX_PLATFORMS=cpu`), so a `TorchServer`
unit serves on the card unless its unit parameters name `{"name":
"device", "value": "cpu"}`; a container command's `python` is the
caller's interpreter (`sys.executable`), as the store already runs for
custom images and the engine.

The reconciler emits the same manifests whether the store is k8s,
in-memory, or this, so the e2e tests drive `SeldonDeployment ->
reconcile -> running processes -> HTTP predict` with zero mocks in the
data path.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _free_port_pair() -> int:
    """A port p where p+1 is ALSO free — unit processes serve gRPC on p
    and the framed-proto fast lane on p+1, and p+1 must not be handed to
    the next unit/engine by a later ephemeral allocation (the engine
    would then frame bytes at a foreign gRPC socket: connect succeeds,
    so the refused-connect fallback never fires)."""
    for _ in range(64):
        with socket.socket() as a:
            a.bind(("127.0.0.1", 0))
            p = a.getsockname()[1]
            with socket.socket() as b:
                try:
                    b.bind(("127.0.0.1", p + 1))
                except OSError:
                    continue
                return p
    return _free_port()  # degenerate host: fall back, fast lane may miss


def _proc_sink():
    """SELDON_TPU_LOCALSTORE_DEBUG=1 lets spawned pods inherit stdio
    (debugging a pod that never becomes ready); default devnull."""
    if os.environ.get("SELDON_TPU_LOCALSTORE_DEBUG") == "1":
        return None
    return subprocess.DEVNULL


def _port_open(port: int) -> bool:
    with socket.socket() as s:
        s.settimeout(0.2)
        return s.connect_ex(("127.0.0.1", port)) == 0


class _Pod:
    def __init__(self):
        self.procs: List[subprocess.Popen] = []
        self.ports: Dict[str, int] = {}  # container name -> host port

    def alive(self) -> bool:
        return all(p.poll() is None for p in self.procs)

    def terminate(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        for p in self.procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:  # pragma: no cover
                p.kill()


class LocalProcessStore:
    """Store protocol over local subprocesses."""

    def __init__(self, repo_root: Optional[str] = None):
        self.repo_root = repo_root or os.getcwd()
        self.manifests: Dict[Tuple[str, str, str], Dict] = {}
        self.pods: Dict[str, _Pod] = {}  # workload name -> pod

    # -- Store protocol ------------------------------------------------------

    def apply(self, manifest: Dict) -> None:
        kind = manifest["kind"]
        meta = manifest["metadata"]
        key = (kind, meta.get("namespace", "default"), meta["name"])
        if kind in ("Deployment", "StatefulSet"):
            existing = self.pods.get(meta["name"])
            unchanged = (
                key in self.manifests
                and self.manifests[key]["spec"] == manifest["spec"]
            )
            if unchanged and existing is not None and existing.alive():
                self.manifests[key] = manifest
                return
            # Spec changed OR the pod is (even partially) dead: always
            # stop before relaunch so no old process survives unowned.
            self._stop_workload(meta["name"])
            self._launch_workload(manifest)
        self.manifests[key] = manifest

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self.manifests.pop((kind, namespace, name), None)
        if kind in ("Deployment", "StatefulSet"):
            self._stop_workload(name)

    def list(self, kind: str, namespace: str,
             label_selector: Optional[Dict[str, str]] = None) -> List[Dict]:
        out = []
        for (k, ns, _), m in self.manifests.items():
            if k != kind or ns != namespace:
                continue
            labels = m["metadata"].get("labels", {})
            if label_selector and any(
                labels.get(a) != b for a, b in label_selector.items()
            ):
                continue
            out.append(m)
        return out

    def is_ready(self, kind: str, namespace: str, name: str) -> bool:
        if kind not in ("Deployment", "StatefulSet"):
            return True
        pod = self.pods.get(name)
        if pod is None or not pod.alive():
            return False
        return all(_port_open(p) for p in pod.ports.values())

    # -- process management --------------------------------------------------

    def _env_list_to_dict(self, env_list) -> Dict[str, str]:
        return {e["name"]: e.get("value", "") for e in (env_list or [])}

    def _launch_workload(self, manifest: Dict) -> None:
        name = manifest["metadata"]["name"]
        pod = _Pod()
        pod_spec = manifest["spec"]["template"]["spec"]
        containers = pod_spec["containers"]
        base_env = dict(os.environ)
        base_env["PYTHONPATH"] = (
            self.repo_root + os.pathsep + base_env.get("PYTHONPATH", "")
        )

        # initContainers: the model-initializer downloads modelUri into the
        # shared volume; here each becomes a local dir the unit env is
        # rewritten to (file:// URIs resolve in place).
        from seldon_tpu_torch.servers.storage import download

        model_dirs: Dict[str, str] = {}  # volume mount path stays /mnt/models
        for init in pod_spec.get("initContainers", []):
            uri, mount = init["args"][0], init["args"][1]
            vol = init["volumeMounts"][0]["name"]
            model_dirs[vol] = download(uri)

        def local_model_dir(c) -> Optional[str]:
            for vm in c.get("volumeMounts", []) or []:
                if vm["name"] in model_dirs:
                    return model_dirs[vm["name"]]
            return None

        # Units first: the engine's graph spec is rewritten to their ports
        # (the job kube DNS + Services do in-cluster).
        unit_ports: Dict[str, int] = {}
        engine_container = None
        for c in containers:
            if c["name"] == "seldon-container-engine":
                engine_container = c
                continue
            env = self._env_list_to_dict(c.get("env"))
            port = _free_port_pair()
            unit_ports[c["name"]] = port
            pod.ports[c["name"]] = port
            mdir = local_model_dir(c)
            if mdir and "PREDICTIVE_UNIT_PARAMETERS" in env:
                env["PREDICTIVE_UNIT_PARAMETERS"] = env[
                    "PREDICTIVE_UNIT_PARAMETERS"
                ].replace("/mnt/models", mdir)
            if c.get("command"):
                # The container's real entrypoint (prepackaged servers);
                # its `python` is this interpreter.
                cmd = list(c["command"]) + [
                    "--api-type", "GRPC",
                    "--grpc-port", str(port), "--http-port", "0",
                ]
                if cmd[0] == "python":
                    cmd[0] = sys.executable
            else:
                # Custom image: MODEL_NAME env names the user class (the
                # packaging entrypoint contract — always wins). Images
                # named `local/<module.Class>:<tag>` carry the class as a
                # fallback so manifests stay self-contained for this store.
                image = c.get("image", "")
                if env.get("MODEL_NAME"):
                    model = env["MODEL_NAME"]
                elif image.startswith("local/"):
                    model = image[len("local/"):].rsplit(":", 1)[0]
                else:
                    model = "seldon_tpu_torch.orchestrator.units.SimpleModel"
                cmd = [
                    sys.executable, "-m", "seldon_tpu_torch.runtime.microservice",
                    model, "--api-type", "GRPC",
                    "--grpc-port", str(port), "--http-port", "0",
                ]
            env["PREDICTIVE_UNIT_SERVICE_PORT"] = str(port)
            pod.procs.append(subprocess.Popen(
                cmd, env={**base_env, **env}, cwd=self.repo_root,
                stdout=_proc_sink(), stderr=_proc_sink(),
            ))

        if engine_container is not None:
            env = self._env_list_to_dict(engine_container.get("env"))
            http_port = _free_port()
            grpc_port = _free_port()
            pod.ports["engine-http"] = http_port
            pod.ports["engine-grpc"] = grpc_port
            raw = env.get("ENGINE_PREDICTOR", "")
            if raw:
                spec = json.loads(base64.b64decode(raw))

                def patch(unit: Dict) -> None:
                    if unit.get("name") in unit_ports:
                        uport = unit_ports[unit["name"]]
                        unit["endpoint"] = {
                            "service_host": "127.0.0.1",
                            "service_port": uport,
                            "type": "GRPC",
                            # The microservice serves the framed-proto
                            # fast lane on grpc_port+1 — same contract
                            # as the webhook's fastPort defaulting.
                            "fast_port": uport + 1,
                        }
                    for child in unit.get("children", []) or []:
                        patch(child)

                patch(spec.get("graph", {}))
                env["ENGINE_PREDICTOR"] = base64.b64encode(
                    json.dumps(spec).encode()
                ).decode()
            cmd = [
                sys.executable, "-m", "seldon_tpu_torch.orchestrator.server",
                "--http-port", str(http_port), "--grpc-port", str(grpc_port),
            ]
            pod.procs.append(subprocess.Popen(
                cmd, env={**base_env, **env}, cwd=self.repo_root,
                stdout=_proc_sink(), stderr=_proc_sink(),
            ))
        self.pods[name] = pod
        logger.info("launched workload %s: ports=%s", name, pod.ports)

    def _stop_workload(self, name: str) -> None:
        pod = self.pods.pop(name, None)
        if pod is not None:
            pod.terminate()

    # -- e2e helpers ---------------------------------------------------------

    def engine_port(self, workload: str) -> Optional[int]:
        pod = self.pods.get(workload)
        return pod.ports.get("engine-http") if pod else None

    def wait_ready(self, timeout_s: float = 60.0) -> bool:
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            workloads = [
                m for (k, _, _), m in self.manifests.items()
                if k in ("Deployment", "StatefulSet")
            ]
            if workloads and all(
                self.is_ready(m["kind"], "default", m["metadata"]["name"])
                for m in workloads
            ):
                return True
            time.sleep(0.25)
        return False

    def close(self) -> None:
        for name in list(self.pods):
            self._stop_workload(name)
