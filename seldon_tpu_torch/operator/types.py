"""SeldonDeployment CR types + k8s naming helpers.

Port of seldon_tpu/operator/types.py, unchanged in what it parses and
emits: the CR JSON shape matches Seldon's CRD so existing
SeldonDeployment manifests parse as they are, and the predictor's `tpu`
block and the `seldon.io/tpu-*` annotations keep their wire names (a CR
written for the JAX package parses here as it is). On the port the `tpu`
block places a predictor on NVIDIA cards (`reconciler.py`): `chips` is
the `nvidia.com/gpu` count per pod, `hosts` the pods of one multi-host
replica, `accelerator` the GPU node label's value."""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Dict, List, Optional

from seldon_tpu_torch.orchestrator.spec import PredictorSpec, PredictiveUnit

# Env vars injected into unit containers (Seldon's seldondeployment_types.go).
ENV_PREDICTIVE_UNIT_SERVICE_PORT = "PREDICTIVE_UNIT_SERVICE_PORT"
ENV_PREDICTIVE_UNIT_PARAMETERS = "PREDICTIVE_UNIT_PARAMETERS"
ENV_PREDICTIVE_UNIT_ID = "PREDICTIVE_UNIT_ID"
ENV_PREDICTOR_ID = "PREDICTOR_ID"
ENV_SELDON_DEPLOYMENT_ID = "SELDON_DEPLOYMENT_ID"
ENV_ENGINE_PREDICTOR = "ENGINE_PREDICTOR"

# Annotations (Seldon's seldondeployment_types.go + ambassador.go).
ANNOTATION_SEPARATE_ENGINE = "seldon.io/engine-separate-pod"
ANNOTATION_HEADLESS_SVC = "seldon.io/headless-svc"
ANNOTATION_REST_READ_TIMEOUT = "seldon.io/rest-read-timeout"
ANNOTATION_GRPC_READ_TIMEOUT = "seldon.io/grpc-read-timeout"
ANNOTATION_GRPC_MAX_MSG = "seldon.io/grpc-max-message-size"
# Ambassador behavior knobs (Seldon's ambassador.go).
ANNOTATION_FASTPATH = "seldon.io/fastpath"
ANNOTATION_AMBASSADOR_CUSTOM = "seldon.io/ambassador-config"
ANNOTATION_AMBASSADOR_SHADOW = "seldon.io/ambassador-shadow"
ANNOTATION_AMBASSADOR_SERVICE = "seldon.io/ambassador-service-name"
ANNOTATION_AMBASSADOR_HEADER = "seldon.io/ambassador-header"
ANNOTATION_AMBASSADOR_REGEX_HEADER = "seldon.io/ambassador-regex-header"
ANNOTATION_AMBASSADOR_ID = "seldon.io/ambassador-id"
# Accelerator placement annotations (wire names of the JAX package).
ANNOTATION_TPU_TOPOLOGY = "seldon.io/tpu-topology"
ANNOTATION_TPU_ACCELERATOR = "seldon.io/tpu-accelerator"

DEFAULT_ENGINE_IMAGE = "seldon-tpu/engine:0.1.0"
DEFAULT_SERVER_IMAGE = "seldon-tpu/microservice:0.1.0"
FIRST_UNIT_PORT = 9000
ENGINE_HTTP_PORT = 8000
ENGINE_GRPC_PORT = 5001
ENGINE_ADMIN_PORT = 8082


@dataclasses.dataclass
class TPUSpec:
    """Accelerator placement for a predictor (the CR's `tpu` block; its
    wire name is kept, the port reads it as cards)."""

    chips: int = 0  # nvidia.com/gpu resource request per pod
    topology: str = ""  # a TPU slice shape; no GPU node label takes it
    accelerator: str = ""  # GPU node label value, e.g. "nvidia-h100-80gb"
    hosts: int = 1  # multi-host replica size (pods per replica)

    @staticmethod
    def from_dict(d: Dict) -> "TPUSpec":
        return TPUSpec(
            chips=int(d.get("chips", 0)),
            topology=d.get("topology", ""),
            accelerator=d.get("accelerator", ""),
            hosts=int(d.get("hosts", 1)),
        )

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class HpaSpec:
    """Autoscaling knobs (reference SeldonPodSpec.HpaSpec, consumed by
    createHpa, seldondeployment_controller.go:87-109)."""

    max_replicas: int = 1
    min_replicas: Optional[int] = None
    metrics: List[Dict] = dataclasses.field(default_factory=list)

    @staticmethod
    def from_dict(d: Dict) -> "HpaSpec":
        return HpaSpec(
            max_replicas=int(d.get("maxReplicas", 1)),
            min_replicas=(
                int(d["minReplicas"]) if "minReplicas" in d else None
            ),
            metrics=list(d.get("metrics", [])),
        )

    def to_dict(self) -> Dict:
        out: Dict[str, Any] = {"maxReplicas": self.max_replicas}
        if self.min_replicas is not None:
            out["minReplicas"] = self.min_replicas
        if self.metrics:
            out["metrics"] = self.metrics
        return out


DEFAULT_EXPLAINER_IMAGE = "seldon-tpu/explainer:0.1.0"


@dataclasses.dataclass
class ExplainerSpec:
    """Explainer sidecar deployment (reference PredictorSpec.Explainer,
    seldondeployment_explainers.go:33-194)."""

    type: str = ""  # anchor_tabular | anchor_images | ...
    model_uri: str = ""
    image: str = ""
    endpoint_type: str = "GRPC"
    service_port: int = 9000
    config: Dict[str, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict) -> "ExplainerSpec":
        ep = d.get("endpoint") or {}  # tolerate explicit null
        return ExplainerSpec(
            type=d.get("type", ""),
            model_uri=d.get("modelUri", d.get("model_uri", "")),
            image=d.get("image", ""),
            endpoint_type=ep.get("type", "GRPC"),
            service_port=int(ep.get("servicePort", 9000)),
            config=dict(d.get("config") or {}),
        )

    def to_dict(self) -> Dict:
        out: Dict[str, Any] = {"type": self.type}
        if self.model_uri:
            out["modelUri"] = self.model_uri
        if self.image:
            out["image"] = self.image
        out["endpoint"] = {
            "type": self.endpoint_type, "servicePort": self.service_port,
        }
        if self.config:
            out["config"] = self.config
        return out


@dataclasses.dataclass
class PredictorExt:
    """PredictorSpec plus operator-level fields the orchestrator spec
    doesn't carry (componentSpecs images, tpu, hpa, explainer)."""

    spec: PredictorSpec
    tpu: TPUSpec = dataclasses.field(default_factory=TPUSpec)
    component_images: Dict[str, str] = dataclasses.field(default_factory=dict)
    # unit name -> container resources overrides
    resources: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    hpa: Optional[HpaSpec] = None
    explainer: Optional[ExplainerSpec] = None
    # ServiceAccount whose secrets carry model-storage credentials
    # (operator/credentials.py; reference service_account_credentials.go).
    service_account_name: str = ""

    @staticmethod
    def from_dict(d: Dict) -> "PredictorExt":
        return PredictorExt(
            spec=PredictorSpec.from_dict(d),
            tpu=TPUSpec.from_dict(d.get("tpu", {})),
            component_images=dict(d.get("componentImages", {})),
            resources=dict(d.get("resources", {})),
            service_account_name=d.get("serviceAccountName", ""),
            hpa=(
                HpaSpec.from_dict(d["hpaSpec"]) if d.get("hpaSpec") else None
            ),
            explainer=(
                ExplainerSpec.from_dict(d["explainer"])
                if (d.get("explainer") or {}).get("type")
                else None
            ),
        )

    def to_dict(self) -> Dict:
        out = self.spec.to_dict()
        if self.tpu.chips:
            out["tpu"] = self.tpu.to_dict()
        if self.component_images:
            out["componentImages"] = self.component_images
        if self.resources:
            out["resources"] = self.resources
        if self.hpa is not None:
            out["hpaSpec"] = self.hpa.to_dict()
        if self.explainer is not None:
            out["explainer"] = self.explainer.to_dict()
        if self.service_account_name:
            out["serviceAccountName"] = self.service_account_name
        return out


@dataclasses.dataclass
class DeploymentStatus:
    state: str = "Creating"  # Creating | Available | Failed
    description: str = ""
    deployment_status: Dict[str, Dict] = dataclasses.field(default_factory=dict)
    service_status: Dict[str, Dict] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SeldonDeployment:
    name: str
    namespace: str = "default"
    predictors: List[PredictorExt] = dataclasses.field(default_factory=list)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    generation: int = 1
    uid: str = ""  # cluster UID; enables ownerReference GC
    oauth_key: str = ""
    status: DeploymentStatus = dataclasses.field(default_factory=DeploymentStatus)

    @staticmethod
    def from_dict(d: Dict) -> "SeldonDeployment":
        meta = d.get("metadata", {})
        spec = d.get("spec", {})
        return SeldonDeployment(
            name=meta.get("name", spec.get("name", "seldon")),
            namespace=meta.get("namespace", "default"),
            predictors=[
                PredictorExt.from_dict(p) for p in spec.get("predictors", [])
            ],
            annotations=dict(meta.get("annotations") or {}),
            labels=dict(meta.get("labels") or {}),
            generation=int(meta.get("generation", 1)),
            uid=meta.get("uid", ""),
        )

    def to_dict(self) -> Dict:
        return {
            "apiVersion": "machinelearning.seldon.io/v1alpha3",
            "kind": "SeldonDeployment",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                "annotations": self.annotations,
                "labels": self.labels,
                "generation": self.generation,
            },
            "spec": {
                "name": self.name,
                "predictors": [p.to_dict() for p in self.predictors],
            },
        }


# ---------------------------------------------------------------------------
# Naming (reference seldondeployment_types.go:75-133)
# ---------------------------------------------------------------------------


def _hash_suffix(s: str) -> str:
    return hashlib.md5(s.encode()).hexdigest()[:8]


def machine_name(*parts: str, limit: int = 63) -> str:
    """Deterministic k8s-safe resource name: joined parts, md5-suffixed when
    truncation is needed (mirrors GetSeldonDeploymentName semantics)."""
    name = "-".join(p for p in parts if p).lower().replace("_", "-")
    if len(name) <= limit:
        return name
    return name[: limit - 9] + "-" + _hash_suffix(name)


def predictor_deployment_name(sdep: SeldonDeployment, pred: PredictorExt,
                              component_idx: int = 0) -> str:
    return machine_name(sdep.name, pred.spec.name, str(component_idx))


def predictor_service_name(sdep: SeldonDeployment, pred: PredictorExt) -> str:
    return machine_name(sdep.name, pred.spec.name)


def container_service_name(sdep: SeldonDeployment, pred: PredictorExt,
                           unit: PredictiveUnit) -> str:
    return machine_name(sdep.name, pred.spec.name, unit.name)


def explainer_deployment_name(sdep: SeldonDeployment,
                              pred: PredictorExt) -> str:
    """Reference GetExplainerDeploymentName semantics."""
    return machine_name(sdep.name, pred.spec.name, "explainer")
