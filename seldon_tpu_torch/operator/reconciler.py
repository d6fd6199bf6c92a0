"""Reconciler: SeldonDeployment -> k8s manifests -> cluster store.

Port of seldon_tpu/operator/reconciler.py (Seldon's
seldondeployment_controller.go — createComponents, createDeployments +
stale-generation cleanup with svc-orch deleted LAST so in-flight traffic
drains through the old engine until the new graph is ready, Istio
resources; engine injection (seldondeployment_engine.go); prepackaged
servers; model-initializer (model_initializer_injector.go)).

Manifests are plain dicts (yaml.safe_dump-able), equal to the JAX
package's under the translation table of `operator/__init__.py` and
nowhere else: the containers run the port's modules, and accelerator
placement asks for NVIDIA cards (`nvidia.com/gpu`, one GPU node
selector) where the JAX package asks for TPU chips and GKE TPU node
pools. The cluster is a pluggable Store; InMemoryStore gives hermetic
tests the same semantics envtest gave Seldon."""

from __future__ import annotations

import base64
import copy
import json
import logging
from typing import Any, Dict, List, Optional, Protocol, Tuple

from seldon_tpu_torch.operator import types as T
from seldon_tpu_torch.operator.webhook import (
    PREPACKAGED,
    PREPACKAGED_CLASSES,
    default_deployment,
    validate_deployment,
)
from seldon_tpu_torch.orchestrator.spec import (
    HARDCODED_IMPLEMENTATIONS,
    PredictiveUnit,
    UnitImplementation,
)

logger = logging.getLogger(__name__)

# Accelerator placement on NVIDIA cards: the device plugin's resource
# name, and the GKE node label naming a node's GPU (one selector where the
# JAX package sets the TPU topology and accelerator labels). A predictor's
# accelerator (`tpu.accelerator` or the `seldon.io/tpu-accelerator`
# annotation) is the label's value when it names a GPU; a TPU value
# ("tpu-...", a CR written for the JAX package) or none selects the H100.
GPU_RESOURCE = "nvidia.com/gpu"
GPU_NODE_LABEL = "cloud.google.com/gke-accelerator"
DEFAULT_GPU_ACCELERATOR = "nvidia-h100-80gb"


def gpu_accelerator(accelerator: str) -> str:
    """The GPU node label value for a predictor's accelerator."""
    if not accelerator or accelerator.startswith("tpu-"):
        return DEFAULT_GPU_ACCELERATOR
    return accelerator


GENERATION_LABEL = "seldon.io/generation"
ENGINE_LABEL = "seldon.io/svcorch"
DEPLOYMENT_LABEL = "seldon-deployment-id"


class Store(Protocol):  # pragma: no cover - interface
    def apply(self, manifest: Dict) -> None: ...

    def delete(self, kind: str, namespace: str, name: str) -> None: ...

    def list(self, kind: str, namespace: str,
             label_selector: Optional[Dict[str, str]] = None) -> List[Dict]: ...

    def is_ready(self, kind: str, namespace: str, name: str) -> bool: ...


class InMemoryStore:
    """Dict-backed store; everything applied is instantly 'ready' unless
    the test marks it otherwise."""

    def __init__(self):
        self.objects: Dict[Tuple[str, str, str], Dict] = {}
        self.not_ready: set = set()

    def _key(self, kind, ns, name):
        return (kind, ns, name)

    def apply(self, manifest: Dict) -> None:
        kind = manifest["kind"]
        ns = manifest["metadata"].get("namespace", "default")
        name = manifest["metadata"]["name"]
        self.objects[self._key(kind, ns, name)] = copy.deepcopy(manifest)

    def delete(self, kind: str, namespace: str, name: str) -> None:
        self.objects.pop(self._key(kind, namespace, name), None)

    def list(self, kind, namespace, label_selector=None) -> List[Dict]:
        out = []
        for (k, ns, _), obj in self.objects.items():
            if k != kind or ns != namespace:
                continue
            labels = obj["metadata"].get("labels", {})
            if label_selector and any(
                labels.get(lk) != lv for lk, lv in label_selector.items()
            ):
                continue
            out.append(obj)
        return out

    def is_ready(self, kind, namespace, name) -> bool:
        return (
            self._key(kind, namespace, name) in self.objects
            and self._key(kind, namespace, name) not in self.not_ready
        )


# ---------------------------------------------------------------------------
# Manifest builders
# ---------------------------------------------------------------------------


def _unit_container(sdep: T.SeldonDeployment, pred: T.PredictorExt,
                    unit: PredictiveUnit) -> Dict:
    params = [
        {"name": p.name, "value": p.value, "type": p.type}
        for p in unit.parameters
    ]
    if unit.implementation in PREPACKAGED:
        cls = PREPACKAGED_CLASSES[unit.implementation]
        if unit.model_uri:
            params.append(
                {"name": "model_uri", "value": "/mnt/models", "type": "STRING"}
            )
        command = ["python", "-m", "seldon_tpu_torch.runtime.microservice", cls]
    else:
        command = None  # user image brings its own entrypoint
    port = unit.endpoint.service_port if unit.endpoint else T.FIRST_UNIT_PORT
    # The engine dials service_port with the endpoint's type, so the
    # container must bind THAT protocol on THAT port: without pinning
    # API_TYPE, the microservice defaults to REST,GRPC and puts gRPC on
    # port+1 while a GRPC-type endpoint dials port (latent mismatch).
    # The fast lane (fastPort = port+1, webhook stride 2) lands on
    # grpc_port+1 either way.
    api_type = (unit.endpoint.type.value if unit.endpoint else "GRPC")
    container: Dict[str, Any] = {
        "name": unit.name,
        "image": unit.image or T.DEFAULT_SERVER_IMAGE,
        "env": [
            {"name": T.ENV_PREDICTIVE_UNIT_SERVICE_PORT, "value": str(port)},
            {"name": "API_TYPE", "value": api_type},
            {"name": T.ENV_PREDICTIVE_UNIT_ID, "value": unit.name},
            {"name": T.ENV_PREDICTOR_ID, "value": pred.spec.name},
            {"name": T.ENV_SELDON_DEPLOYMENT_ID, "value": sdep.name},
            {"name": T.ENV_PREDICTIVE_UNIT_PARAMETERS,
             "value": json.dumps(params)},
        ],
        "ports": [{"containerPort": port, "name": "grpc", "protocol": "TCP"}],
        "readinessProbe": {
            "tcpSocket": {"port": port},
            "initialDelaySeconds": 5,
            "periodSeconds": 5,
            "failureThreshold": 3,
        },
        "livenessProbe": {
            "tcpSocket": {"port": port},
            "initialDelaySeconds": 10,
            "periodSeconds": 5,
        },
        "lifecycle": {
            "preStop": {"exec": {"command": ["/bin/sh", "-c", "sleep 10"]}}
        },
    }
    if command:
        container["command"] = command
    resources = dict(pred.resources.get(unit.name, {}))
    if pred.tpu.chips and unit.implementation == UnitImplementation.JAX_SERVER:
        resources.setdefault("limits", {})[GPU_RESOURCE] = pred.tpu.chips
        resources.setdefault("requests", {})[GPU_RESOURCE] = pred.tpu.chips
    if resources:
        container["resources"] = resources
    if unit.model_uri:
        # Per-unit volume: two prepackaged units in one graph must never
        # clobber each other's /mnt/models downloads.
        container["volumeMounts"] = [
            {"name": _model_volume_name(unit), "mountPath": "/mnt/models",
             "readOnly": True}
        ]
    return container


def _model_volume_name(unit: PredictiveUnit) -> str:
    return T.machine_name("model-volume", unit.name)


def _model_initializer(unit: PredictiveUnit) -> Dict:
    """initContainer downloading modelUri into the unit's volume
    (reference model_initializer_injector.go:65-228)."""
    return {
        "name": f"{unit.name}-model-initializer",
        "image": T.DEFAULT_SERVER_IMAGE,
        "command": ["python", "-m", "seldon_tpu_torch.servers.storage"],
        "args": [unit.model_uri, "/mnt/models"],
        "volumeMounts": [
            {"name": _model_volume_name(unit), "mountPath": "/mnt/models"}
        ],
    }


def _engine_container(sdep: T.SeldonDeployment, pred: T.PredictorExt) -> Dict:
    predictor_json = json.dumps(pred.spec.to_dict()).encode()
    return {
        "name": "seldon-container-engine",
        "image": T.DEFAULT_ENGINE_IMAGE,
        "command": ["python", "-m", "seldon_tpu_torch.orchestrator.server"],
        "env": [
            {"name": T.ENV_ENGINE_PREDICTOR,
             "value": base64.b64encode(predictor_json).decode()},
            {"name": T.ENV_PREDICTOR_ID, "value": pred.spec.name},
            {"name": T.ENV_SELDON_DEPLOYMENT_ID, "value": sdep.name},
        ],
        "ports": [
            {"containerPort": T.ENGINE_HTTP_PORT, "name": "rest"},
            {"containerPort": T.ENGINE_GRPC_PORT, "name": "grpc"},
        ],
        # Downward-API podinfo: CR annotations reach the engine at runtime
        # (timeouts/retries/grpc caps — core/annotations.py; reference
        # seldondeployment_controller.go:627-633 + AnnotationsConfig.java).
        "volumeMounts": [
            {"name": "podinfo", "mountPath": "/etc/podinfo", "readOnly": True}
        ],
        "readinessProbe": {
            "httpGet": {"path": "/ready", "port": T.ENGINE_HTTP_PORT},
            "initialDelaySeconds": 5,
            "periodSeconds": 5,
        },
        "livenessProbe": {
            "httpGet": {"path": "/live", "port": T.ENGINE_HTTP_PORT},
            "initialDelaySeconds": 10,
            "periodSeconds": 5,
        },
        "lifecycle": {
            "preStop": {
                "exec": {
                    "command": [
                        "/bin/sh", "-c",
                        f"curl -s localhost:{T.ENGINE_HTTP_PORT}/pause; sleep 10",
                    ]
                }
            }
        },
    }


def build_predictor_manifests(
    sdep: T.SeldonDeployment, pred: T.PredictorExt,
    credentials: Optional["CredentialBuilder"] = None,
) -> List[Dict]:
    """Deployment(+engine) + Services for one predictor. `credentials`
    (operator/credentials.py) injects storage secrets into the
    model-initializer initContainers for private gs://-/s3:// model URIs."""
    manifests: List[Dict] = []
    dep_name = T.predictor_deployment_name(sdep, pred)
    labels = {
        DEPLOYMENT_LABEL: sdep.name,
        "seldon-predictor": pred.spec.name,
        GENERATION_LABEL: str(sdep.generation),
    }
    separate_engine = (
        sdep.annotations.get(T.ANNOTATION_SEPARATE_ENGINE, "false") == "true"
    )

    containers = []
    init_containers = []
    volumes = []
    for unit in pred.spec.graph.walk():
        if unit.implementation in HARDCODED_IMPLEMENTATIONS:
            continue
        containers.append(_unit_container(sdep, pred, unit))
        if unit.model_uri:
            init = _model_initializer(unit)
            if credentials is not None:
                credentials.inject(
                    sdep.namespace, pred.service_account_name, init, volumes
                )
            init_containers.append(init)
            volumes.append(
                {"name": _model_volume_name(unit), "emptyDir": {}}
            )

    engine = _engine_container(sdep, pred)
    engine_labels = dict(labels)
    engine_labels[ENGINE_LABEL] = "true"

    podinfo_volume = {
        "name": "podinfo",
        "downwardAPI": {
            "items": [
                {"path": "annotations",
                 "fieldRef": {"fieldPath": "metadata.annotations"}}
            ]
        },
    }

    pod_spec: Dict[str, Any] = {"containers": list(containers)}
    if pred.service_account_name:
        # The pod runs AS this SA too — identity-based bucket access
        # (GKE Workload Identity) works without any key secrets; the
        # secret walk above only adds long-lived-key credentials when
        # the SA actually carries them.
        pod_spec["serviceAccountName"] = pred.service_account_name
    if init_containers:
        pod_spec["initContainers"] = init_containers
    if not separate_engine:
        volumes = volumes + [podinfo_volume]
    if volumes:
        pod_spec["volumes"] = volumes
    if pred.tpu.chips:
        pod_spec["nodeSelector"] = {
            GPU_NODE_LABEL: gpu_accelerator(
                pred.tpu.accelerator or sdep.annotations.get(
                    T.ANNOTATION_TPU_ACCELERATOR, ""))
        }

    if not separate_engine:
        pod_spec["containers"].append(engine)
        pod_labels = engine_labels
    else:
        pod_labels = labels

    multi_host = pred.tpu.hosts > 1
    workload_kind = "StatefulSet" if multi_host else "Deployment"
    workload: Dict[str, Any] = {
        "apiVersion": "apps/v1",
        "kind": workload_kind,
        "metadata": {
            "name": dep_name,
            "namespace": sdep.namespace,
            "labels": pod_labels,
        },
        "spec": {
            "selector": {"matchLabels": {"app": dep_name}},
            "template": {
                "metadata": {
                    "labels": {"app": dep_name, **pod_labels},
                    # CR annotations ride the pod template so the downward
                    # API exposes them at /etc/podinfo/annotations for the
                    # engine's runtime knobs (core/annotations.py) — the
                    # reference copies deployment annotations the same way.
                    "annotations": {
                        **sdep.annotations,
                        "prometheus.io/scrape": "true",
                        "prometheus.io/path": "/prometheus",
                        "prometheus.io/port": str(T.ENGINE_HTTP_PORT),
                    },
                },
                "spec": pod_spec,
            },
        },
    }
    # When an HPA owns the replica count, omitting .spec.replicas stops
    # every reconcile PUT from resetting what the autoscaler set
    # (reference omits replicas when hpaSpec is present).
    if pred.hpa is None:
        workload["spec"]["replicas"] = (
            pred.spec.replicas * pred.tpu.hosts
            if multi_host
            else pred.spec.replicas
        )
    if multi_host:
        # Stable ordinals for the rank group (parallel/distributed.py):
        # pod-0..pod-(hosts-1) form one replica; the headless service gives
        # them DNS identity. The env goes on the container(s) holding the
        # cards (all units if none do); its names are the JAX package's.
        headless_name = f"{dep_name}-hosts"
        workload["spec"]["serviceName"] = headless_name
        gpu_containers = [
            c for c in containers
            if GPU_RESOURCE in c.get("resources", {}).get("limits", {})
        ] or containers
        for c in gpu_containers:
            c.setdefault("env", []).extend(
                [
                    {"name": "TPU_WORKER_HOSTNAMES_SVC",
                     "value": headless_name},
                    {"name": "TPU_WORKER_COUNT",
                     "value": str(pred.tpu.hosts)},
                ]
            )
        manifests.append(
            {
                "apiVersion": "v1",
                "kind": "Service",
                "metadata": {
                    "name": headless_name,
                    "namespace": sdep.namespace,
                    "labels": labels,
                },
                "spec": {
                    "clusterIP": "None",
                    "selector": {"app": dep_name},
                    "ports": [{"port": T.FIRST_UNIT_PORT, "name": "grpc"}],
                },
            }
        )
    else:
        workload["spec"]["strategy"] = {
            "type": "RollingUpdate",
            "rollingUpdate": {"maxUnavailable": "10%"},
        }
    manifests.append(workload)

    if separate_engine:
        engine_dep_name = machine_engine_name(sdep, pred)
        manifests.append(
            {
                "apiVersion": "apps/v1",
                "kind": "Deployment",
                "metadata": {
                    "name": engine_dep_name,
                    "namespace": sdep.namespace,
                    "labels": engine_labels,
                },
                "spec": {
                    "replicas": pred.spec.replicas,
                    "selector": {"matchLabels": {"app": engine_dep_name}},
                    "template": {
                        "metadata": {
                            "labels": {"app": engine_dep_name,
                                       **engine_labels},
                            "annotations": dict(sdep.annotations),
                        },
                        "spec": {"containers": [engine],
                                 "volumes": [podinfo_volume]},
                    },
                },
            }
        )
        # Per-unit container Services so the remote engine reaches them.
        for unit in pred.spec.graph.walk():
            if unit.implementation in HARDCODED_IMPLEMENTATIONS:
                continue
            svc = T.container_service_name(sdep, pred, unit)
            port = (
                unit.endpoint.service_port if unit.endpoint
                else T.FIRST_UNIT_PORT
            )
            manifests.append(
                {
                    "apiVersion": "v1",
                    "kind": "Service",
                    "metadata": {
                        "name": svc,
                        "namespace": sdep.namespace,
                        "labels": labels,
                    },
                    "spec": {
                        "selector": {"app": dep_name},
                        "ports": [{"port": port, "name": "grpc"}],
                    },
                }
            )

    # Predictor service fronting the engine.
    engine_app = (
        machine_engine_name(sdep, pred) if separate_engine else dep_name
    )
    manifests.append(
        {
            "apiVersion": "v1",
            "kind": "Service",
            "metadata": {
                "name": T.predictor_service_name(sdep, pred),
                "namespace": sdep.namespace,
                "labels": labels,
            },
            "spec": {
                "selector": {"app": engine_app},
                "ports": [
                    {"port": T.ENGINE_HTTP_PORT, "name": "http"},
                    {"port": T.ENGINE_GRPC_PORT, "name": "grpc"},
                ],
            },
        }
    )
    return manifests


def machine_engine_name(sdep: T.SeldonDeployment, pred: T.PredictorExt) -> str:
    return T.machine_name(sdep.name, pred.spec.name, "svc-orch")


def build_hpa_manifest(sdep: T.SeldonDeployment,
                       pred: T.PredictorExt) -> Dict:
    """HorizontalPodAutoscaler targeting the predictor workload (reference
    createHpa, seldondeployment_controller.go:87-109). Defaults to a CPU
    utilization metric when the CR gives none — scale signals for a card
    serving pod come from the engine's req/s via custom metrics when
    configured."""
    dep_name = T.predictor_deployment_name(sdep, pred)
    hpa = pred.hpa
    assert hpa is not None, "build_hpa_manifest requires pred.hpa"
    metrics = hpa.metrics or [
        {
            "type": "Resource",
            "resource": {
                "name": "cpu",
                "target": {"type": "Utilization", "averageUtilization": 80},
            },
        }
    ]
    spec: Dict[str, Any] = {
        "scaleTargetRef": {
            "apiVersion": "apps/v1",
            # Multi-host slices deploy as StatefulSets of the same name.
            "kind": "StatefulSet" if pred.tpu.hosts > 1 else "Deployment",
            "name": dep_name,
        },
        "maxReplicas": hpa.max_replicas,
        "metrics": metrics,
    }
    if hpa.min_replicas is not None:
        spec["minReplicas"] = hpa.min_replicas
    return {
        "apiVersion": "autoscaling/v2",
        "kind": "HorizontalPodAutoscaler",
        "metadata": {
            "name": dep_name,
            "namespace": sdep.namespace,
            "labels": {DEPLOYMENT_LABEL: sdep.name},
        },
        "spec": spec,
    }


def build_explainer_manifests(sdep: T.SeldonDeployment,
                              pred: T.PredictorExt) -> List[Dict]:
    """Explainer Deployment + Service pointing back at the predictor
    (reference seldondeployment_explainers.go:33-194: separate deployment
    running the explainer against the predictor's endpoint, with its own
    `-explainer` ingress route)."""
    exp = pred.explainer
    if exp is None or not exp.type:
        return []
    dep_name = T.explainer_deployment_name(sdep, pred)
    pred_svc = T.predictor_service_name(sdep, pred)
    port_name = "grpc" if exp.endpoint_type.upper() == "GRPC" else "http"
    predictor_host = (
        f"{pred_svc}.{sdep.namespace}.svc.cluster.local:"
        + str(T.ENGINE_GRPC_PORT if port_name == "grpc"
              else T.ENGINE_HTTP_PORT)
    )
    args = [
        f"--model-name={sdep.name}",
        f"--predictor-host={predictor_host}",
        f"--protocol=seldon.{port_name}",
        f"--http-port={exp.service_port}",
        exp.type.lower(),
    ]
    container: Dict[str, Any] = {
        "name": dep_name,
        "image": exp.image or T.DEFAULT_EXPLAINER_IMAGE,
        "imagePullPolicy": "IfNotPresent",
        "args": args,
        "ports": [
            {"name": port_name, "containerPort": exp.service_port,
             "protocol": "TCP"},
        ],
        "livenessProbe": {
            "tcpSocket": {"port": port_name},
            "initialDelaySeconds": 60, "periodSeconds": 5,
            "failureThreshold": 5,
        },
        "readinessProbe": {
            "tcpSocket": {"port": port_name},
            "initialDelaySeconds": 20, "periodSeconds": 5,
            "failureThreshold": 7,
        },
        "lifecycle": {
            "preStop": {
                "exec": {"command": ["/bin/sh", "-c", "/bin/sleep 10"]}
            }
        },
    }
    volumes = []
    if exp.model_uri:
        container["args"].insert(-1, "--storage-uri=/mnt/models")
        vol = f"{dep_name}-model"
        container["volumeMounts"] = [
            {"name": vol, "mountPath": "/mnt/models", "readOnly": True}
        ]
        volumes.append({"name": vol, "emptyDir": {}})
    labels = {DEPLOYMENT_LABEL: sdep.name,
              "seldon-predictor": pred.spec.name}
    pod_spec: Dict[str, Any] = {"containers": [container]}
    if exp.model_uri:
        pod_spec["initContainers"] = [
            {
                "name": "model-initializer",
                "image": "seldon-tpu/storage-initializer:0.1.0",
                "args": [exp.model_uri, "/mnt/models"],
                "volumeMounts": container["volumeMounts"],
            }
        ]
        pod_spec["volumes"] = volumes
    deployment = {
        "apiVersion": "apps/v1",
        "kind": "Deployment",
        "metadata": {
            "name": dep_name,
            "namespace": sdep.namespace,
            "labels": labels,
        },
        "spec": {
            "replicas": 1,
            "selector": {"matchLabels": {"app": dep_name}},
            "template": {
                "metadata": {"labels": {"app": dep_name, **labels}},
                "spec": pod_spec,
            },
        },
    }
    service = {
        "apiVersion": "v1",
        "kind": "Service",
        "metadata": {
            "name": dep_name,
            "namespace": sdep.namespace,
            "labels": labels,
        },
        "spec": {
            "selector": {"app": dep_name},
            "ports": [{"port": exp.service_port, "name": port_name}],
        },
    }
    return [deployment, service]


def build_istio_manifests(sdep: T.SeldonDeployment) -> List[Dict]:
    """VirtualService with per-predictor traffic weights + DestinationRules
    (reference seldondeployment_controller.go:113-224)."""
    http_routes = []
    drs = []
    for pred in sdep.predictors:
        svc = T.predictor_service_name(sdep, pred)
        host = f"{svc}.{sdep.namespace}.svc.cluster.local"
        http_routes.append(
            {
                "destination": {
                    "host": host,
                    "port": {"number": T.ENGINE_HTTP_PORT},
                },
                "weight": pred.spec.traffic,
            }
        )
        drs.append(
            {
                "apiVersion": "networking.istio.io/v1beta1",
                "kind": "DestinationRule",
                "metadata": {
                    "name": svc,
                    "namespace": sdep.namespace,
                    "labels": {DEPLOYMENT_LABEL: sdep.name},
                },
                "spec": {
                    "host": host,
                    "trafficPolicy": {"tls": {"mode": "ISTIO_MUTUAL"}},
                },
            }
        )
    http_blocks = [
        {
            "match": [
                {"uri": {"prefix": f"/seldon/{sdep.namespace}/{sdep.name}/"}}
            ],
            "rewrite": {"uri": "/"},
            "route": http_routes,
        }
    ]
    # Explainer routes: own `-explainer` prefix per predictor (reference
    # seldondeployment_explainers.go ingress wiring).
    for pred in sdep.predictors:
        if pred.explainer is None or not pred.explainer.type:
            continue
        exp_svc = T.explainer_deployment_name(sdep, pred)
        http_blocks.insert(0, {
            "match": [
                {"uri": {"prefix":
                         f"/seldon/{sdep.namespace}/{sdep.name}-explainer/"
                         f"{pred.spec.name}/"}}
            ],
            "rewrite": {"uri": "/"},
            "route": [
                {
                    "destination": {
                        "host": (f"{exp_svc}.{sdep.namespace}"
                                 ".svc.cluster.local"),
                        "port": {"number": pred.explainer.service_port},
                    },
                    "weight": 100,
                }
            ],
        })
    vs = {
        "apiVersion": "networking.istio.io/v1beta1",
        "kind": "VirtualService",
        "metadata": {
            "name": T.machine_name(sdep.name, "http"),
            "namespace": sdep.namespace,
            "labels": {DEPLOYMENT_LABEL: sdep.name},
        },
        "spec": {
            "hosts": ["*"],
            "gateways": ["seldon-gateway"],
            "http": http_blocks,
        },
    }
    return [vs] + drs


def _parse_header_annotation(value: str) -> Dict[str, str]:
    """'key1:val1:key2:val2' -> dict (reference ambassador.go:100-117).

    The wire format is inherently ambiguous when a VALUE contains ':'
    (a regex like 'x-ver:v[12]:x-env:prod.*' still parses, but
    'x-match:a:b' would mis-pair) — same limitation as the reference's
    strings.Split. Each key may appear once; a trailing unpaired token
    (odd part count) is dropped rather than silently becoming a key
    with the next pair's key as its value."""
    parts = value.split(":")
    out: Dict[str, str] = {}
    for i in range(0, len(parts) - 1, 2):
        out[parts[i].strip()] = parts[i + 1].strip()
    return out


def ambassador_annotations(sdep: T.SeldonDeployment) -> str:
    """Ambassador v1 Mapping YAML block (reference ambassador.go:50-263).

    Behavior knobs via deployment annotations:
      seldon.io/ambassador-config        — verbatim override of the config
      seldon.io/ambassador-shadow        — non-empty: predictors become
        SHADOW mappings (traffic mirrored to them, responses discarded —
        canary testing against production load, ambassador.go:119-133)
      seldon.io/ambassador-header        — 'k:v[:k2:v2]' exact-match header
        routing; the mapping only serves requests carrying the headers
      seldon.io/ambassador-regex-header  — same, regex match
      seldon.io/ambassador-service-name  — external path name override
      seldon.io/ambassador-id            — restrict to one ambassador
        instance (ambassador_id)
    """
    custom = sdep.annotations.get(T.ANNOTATION_AMBASSADOR_CUSTOM, "")
    if custom:
        return custom
    shadow = sdep.annotations.get(T.ANNOTATION_AMBASSADOR_SHADOW, "")
    svc_external = sdep.annotations.get(
        T.ANNOTATION_AMBASSADOR_SERVICE, sdep.name
    )
    header = _parse_header_annotation(
        sdep.annotations.get(T.ANNOTATION_AMBASSADOR_HEADER, "")
    )
    regex_header = _parse_header_annotation(
        sdep.annotations.get(T.ANNOTATION_AMBASSADOR_REGEX_HEADER, "")
    )
    instance_id = sdep.annotations.get(T.ANNOTATION_AMBASSADOR_ID, "")

    def header_yaml(tag: str, headers: Dict[str, str]) -> str:
        if not headers:
            return ""
        # json.dumps double-quotes values (valid YAML scalars), so regex
        # patterns with ':', '{', or leading specials can't malform the
        # emitted Mapping.
        lines = "".join(
            f"  {k}: {json.dumps(str(v))}\n" for k, v in headers.items()
        )
        return f"{tag}:\n{lines}"

    extras = ""
    if shadow:
        extras += "shadow: true\n"
    extras += header_yaml("headers", header)
    extras += header_yaml("regex_headers", regex_header)
    if instance_id:
        extras += f"ambassador_id: {instance_id}\n"

    blocks = []
    for pred in sdep.predictors:
        svc = T.predictor_service_name(sdep, pred)
        timeout = sdep.annotations.get(T.ANNOTATION_REST_READ_TIMEOUT, "3000")
        grpc_timeout = sdep.annotations.get(
            T.ANNOTATION_GRPC_READ_TIMEOUT, "3000"
        )
        weight = pred.spec.traffic if len(sdep.predictors) > 1 else 100
        blocks.append(
            "---\n"
            "apiVersion: ambassador/v1\n"
            "kind: Mapping\n"
            f"name: seldon_{sdep.namespace}_{sdep.name}_{pred.spec.name}_rest\n"
            f"prefix: /seldon/{sdep.namespace}/{svc_external}/\n"
            f"service: {svc}.{sdep.namespace}:{T.ENGINE_HTTP_PORT}\n"
            f"timeout_ms: {timeout}\n"
            f"weight: {weight}\n"
            "retry_policy:\n"
            "  retry_on: connect-failure\n"
            "  num_retries: 3\n"
            + extras
        )
        grpc_headers = {"seldon": svc_external, "namespace": sdep.namespace,
                        **header}
        blocks.append(
            "---\n"
            "apiVersion: ambassador/v1\n"
            "kind: Mapping\n"
            f"name: seldon_{sdep.namespace}_{sdep.name}_{pred.spec.name}_grpc\n"
            "grpc: true\n"
            f"prefix: /seldon.protos.Seldon/\n"
            + header_yaml("headers", grpc_headers)
            + f"service: {svc}.{sdep.namespace}:{T.ENGINE_GRPC_PORT}\n"
            f"timeout_ms: {grpc_timeout}\n"
            f"weight: {weight}\n"
            + ("shadow: true\n" if shadow else "")
            + header_yaml("regex_headers", regex_header)
            + (f"ambassador_id: {instance_id}\n" if instance_id else "")
        )
    return "".join(blocks)


# ---------------------------------------------------------------------------
# Reconciler
# ---------------------------------------------------------------------------


class Reconciler:
    def __init__(self, store: Store, istio_enabled: bool = True):
        self.store = store
        self.istio_enabled = istio_enabled

    def desired_manifests(self, sdep: T.SeldonDeployment) -> List[Dict]:
        from seldon_tpu_torch.operator.credentials import CredentialBuilder

        credentials = CredentialBuilder.from_store(
            self.store, namespaces=("seldon-system", sdep.namespace)
        )
        manifests: List[Dict] = []
        for pred in sdep.predictors:
            manifests.extend(
                build_predictor_manifests(sdep, pred, credentials)
            )
            if pred.hpa is not None:
                manifests.append(build_hpa_manifest(sdep, pred))
            manifests.extend(build_explainer_manifests(sdep, pred))
        if self.istio_enabled:
            manifests.extend(build_istio_manifests(sdep))
        return manifests

    def reconcile(self, sdep: T.SeldonDeployment) -> T.DeploymentStatus:
        """Default, validate, apply desired state, GC stale generations
        (svc-orch LAST, only once the new generation is ready — reference
        :952-1044)."""
        default_deployment(sdep)
        problems = validate_deployment(sdep)
        if problems:
            sdep.status = T.DeploymentStatus(
                state="Failed", description="; ".join(problems)
            )
            return sdep.status

        desired = self.desired_manifests(sdep)
        for m in desired:
            m["metadata"].setdefault("labels", {})[GENERATION_LABEL] = str(
                sdep.generation
            )
            if sdep.uid:
                # In-cluster cascade GC: deleting the CR deletes everything
                # it owns (reference: controller refs, :1129-1198).
                m["metadata"]["ownerReferences"] = [
                    {
                        "apiVersion": "machinelearning.seldon.io/v1alpha3",
                        "kind": "SeldonDeployment",
                        "name": sdep.name,
                        "uid": sdep.uid,
                        "controller": True,
                        "blockOwnerDeletion": True,
                    }
                ]
            self.store.apply(m)

        all_ready = all(
            self.store.is_ready(
                m["kind"], m["metadata"].get("namespace", "default"),
                m["metadata"]["name"],
            )
            for m in desired
            if m["kind"] in ("Deployment", "StatefulSet")
        )

        if all_ready:
            self._gc_stale(sdep, desired)
            sdep.status = T.DeploymentStatus(state="Available")
        else:
            sdep.status = T.DeploymentStatus(
                state="Creating", description="waiting for workloads"
            )
        return sdep.status

    def delete_all(self, name: str, namespace: str) -> int:
        """Remove every resource labeled for `name` (CR deleted). With
        in-cluster ownerReferences this is redundant (cascade GC), but it
        is the only cleanup path for stores without GC and a belt-and-
        braces fallback when the CR predates ownerReference stamping."""
        kinds = ["Deployment", "StatefulSet", "Service",
                 "HorizontalPodAutoscaler"]
        if self.istio_enabled:
            kinds += ["VirtualService", "DestinationRule"]
        n = 0
        for kind in kinds:
            for obj in self.store.list(
                kind, namespace, {DEPLOYMENT_LABEL: name}
            ):
                self.store.delete(
                    obj.get("kind", kind),
                    obj["metadata"].get("namespace", namespace),
                    obj["metadata"]["name"],
                )
                n += 1
        return n

    def _gc_stale(self, sdep: T.SeldonDeployment, desired: List[Dict]) -> None:
        desired_names = {
            (m["kind"], m["metadata"]["name"]) for m in desired
        }
        stale: List[Dict] = []
        kinds = ["Deployment", "StatefulSet", "Service",
                 "HorizontalPodAutoscaler"]
        if self.istio_enabled:
            # Istio kinds only exist as API routes when Istio is installed;
            # listing them on a bare cluster would 404.
            kinds += ["VirtualService", "DestinationRule"]
        for kind in kinds:
            for obj in self.store.list(
                kind, sdep.namespace, {DEPLOYMENT_LABEL: sdep.name}
            ):
                name = obj["metadata"]["name"]
                gen = obj["metadata"].get("labels", {}).get(GENERATION_LABEL)
                if (kind, name) in desired_names:
                    continue
                if gen != str(sdep.generation):
                    stale.append(obj)
        # Non-engine resources first; the old svc-orch drains last so
        # in-flight requests finish (reference ordering :976-1043).
        stale.sort(
            key=lambda o: o["metadata"].get("labels", {}).get(ENGINE_LABEL)
            == "true"
        )
        for obj in stale:
            self.store.delete(
                obj["kind"], obj["metadata"].get("namespace", "default"),
                obj["metadata"]["name"],
            )
