"""Inference-graph spec: PredictorSpec / PredictiveUnit.

Port of seldon_tpu/orchestrator/spec.py: Seldon's CRD graph schema
(PredictorSpec{graph, replicas, traffic, ...}, PredictiveUnit{name,
children, type, implementation, methods, endpoint, parameters,
modelUri}) in the JSON shape the engine receives through the base64
`ENGINE_PREDICTOR` env. The enum values (`JAX_SERVER` included) are the
wire contract the operator's manifests name, and stay as they are."""

from __future__ import annotations

import base64
import dataclasses
import enum
import json
import os
from typing import Any, Dict, List, Optional


class UnitType(str, enum.Enum):
    UNKNOWN_TYPE = "UNKNOWN_TYPE"
    ROUTER = "ROUTER"
    COMBINER = "COMBINER"
    MODEL = "MODEL"
    TRANSFORMER = "TRANSFORMER"
    OUTPUT_TRANSFORMER = "OUTPUT_TRANSFORMER"


class UnitImplementation(str, enum.Enum):
    UNKNOWN_IMPLEMENTATION = "UNKNOWN_IMPLEMENTATION"
    SIMPLE_MODEL = "SIMPLE_MODEL"
    SIMPLE_ROUTER = "SIMPLE_ROUTER"
    RANDOM_ABTEST = "RANDOM_ABTEST"
    AVERAGE_COMBINER = "AVERAGE_COMBINER"
    # Prepackaged servers (materialized into containers by the operator;
    # Seldon's operator constants).
    SKLEARN_SERVER = "SKLEARN_SERVER"
    XGBOOST_SERVER = "XGBOOST_SERVER"
    TENSORFLOW_SERVER = "TENSORFLOW_SERVER"
    MLFLOW_SERVER = "MLFLOW_SERVER"
    JAX_SERVER = "JAX_SERVER"  # the JAX package's LLM server (wire name)


class EndpointType(str, enum.Enum):
    REST = "REST"
    GRPC = "GRPC"


@dataclasses.dataclass
class Endpoint:
    service_host: str = "localhost"
    service_port: int = 9000
    type: EndpointType = EndpointType.GRPC
    # REST body encoding: "proto" (binary SeldonMessage — the zero-copy
    # default between our own units) or "json" (the lingua
    # franca for foreign-language units, e.g. examples/wrappers/go —
    # docs/wrappers.md).
    content: str = "proto"
    # Optional framed-proto fast lane (runtime/fastpath.py): the
    # package's own units serve it on gRPC-port+1 alongside gRPC/REST; 0 =
    # absent, the engine uses `type` as usual. Sync-lane only.
    fast_port: int = 0

    @staticmethod
    def from_dict(d: Dict) -> "Endpoint":
        content = str(d.get("content", "proto")).lower()
        if content not in ("proto", "json"):
            # Fail at spec-load time like EndpointType does — a typo here
            # would otherwise surface as an opaque parse error when the
            # engine POSTs proto bytes at a JSON-only unit.
            raise ValueError(
                f"endpoint content must be 'proto' or 'json', got {content!r}"
            )
        return Endpoint(
            service_host=d.get("service_host", d.get("serviceHost", "localhost")),
            service_port=int(d.get("service_port", d.get("servicePort", 9000))),
            type=EndpointType(d.get("type", "GRPC")),
            content=content,
            fast_port=int(d.get("fast_port", d.get("fastPort", 0))),
        )

    def to_dict(self) -> Dict:
        out = {
            "service_host": self.service_host,
            "service_port": self.service_port,
            "type": self.type.value,
        }
        if self.content != "proto":
            out["content"] = self.content
        if self.fast_port:
            out["fast_port"] = self.fast_port
        return out


@dataclasses.dataclass
class Parameter:
    name: str
    value: str
    type: str = "STRING"  # STRING|INT|FLOAT|DOUBLE|BOOL

    def typed_value(self) -> Any:
        if self.type == "INT":
            return int(self.value)
        if self.type in ("FLOAT", "DOUBLE"):
            return float(self.value)
        if self.type == "BOOL":
            return str(self.value).lower() in ("1", "true", "yes")
        return self.value


@dataclasses.dataclass
class PredictiveUnit:
    name: str
    type: UnitType = UnitType.UNKNOWN_TYPE
    implementation: UnitImplementation = UnitImplementation.UNKNOWN_IMPLEMENTATION
    children: List["PredictiveUnit"] = dataclasses.field(default_factory=list)
    endpoint: Optional[Endpoint] = None
    parameters: List[Parameter] = dataclasses.field(default_factory=list)
    model_uri: str = ""
    service_account: str = ""
    # Serving image name/version recorded into meta.requestPath (Seldon's
    # PredictiveUnitState parses it from the container spec).
    image: str = ""

    @staticmethod
    def from_dict(d: Dict) -> "PredictiveUnit":
        return PredictiveUnit(
            name=d["name"],
            type=UnitType(d.get("type", "UNKNOWN_TYPE")),
            implementation=UnitImplementation(
                d.get("implementation", "UNKNOWN_IMPLEMENTATION")
            ),
            children=[PredictiveUnit.from_dict(c) for c in d.get("children", [])],
            endpoint=Endpoint.from_dict(d["endpoint"]) if d.get("endpoint") else None,
            parameters=[
                Parameter(p["name"], str(p["value"]), p.get("type", "STRING"))
                for p in d.get("parameters", [])
            ],
            model_uri=d.get("modelUri", d.get("model_uri", "")),
            service_account=d.get("serviceAccountName", ""),
            image=d.get("image", ""),
        )

    def to_dict(self) -> Dict:
        out: Dict[str, Any] = {"name": self.name, "type": self.type.value}
        if self.implementation != UnitImplementation.UNKNOWN_IMPLEMENTATION:
            out["implementation"] = self.implementation.value
        if self.children:
            out["children"] = [c.to_dict() for c in self.children]
        if self.endpoint:
            out["endpoint"] = self.endpoint.to_dict()
        if self.parameters:
            out["parameters"] = [
                {"name": p.name, "value": p.value, "type": p.type}
                for p in self.parameters
            ]
        if self.model_uri:
            out["modelUri"] = self.model_uri
        if self.image:
            out["image"] = self.image
        return out

    def walk(self):
        yield self
        for c in self.children:
            yield from c.walk()

    def find(self, name: str) -> Optional["PredictiveUnit"]:
        for u in self.walk():
            if u.name == name:
                return u
        return None


@dataclasses.dataclass
class PredictorSpec:
    name: str
    graph: PredictiveUnit
    replicas: int = 1
    traffic: int = 100
    labels: Dict[str, str] = dataclasses.field(default_factory=dict)
    annotations: Dict[str, str] = dataclasses.field(default_factory=dict)

    @staticmethod
    def from_dict(d: Dict) -> "PredictorSpec":
        return PredictorSpec(
            name=d.get("name", "default"),
            graph=PredictiveUnit.from_dict(d["graph"]),
            replicas=int(d.get("replicas", 1)),
            # 0 = unset (proto3 default); the operator webhook distributes
            # traffic across predictors at defaulting time.
            traffic=int(d.get("traffic", 0)),
            labels=dict(d.get("labels", {})),
            annotations=dict(d.get("annotations", {})),
        )

    def to_dict(self) -> Dict:
        return {
            "name": self.name,
            "graph": self.graph.to_dict(),
            "replicas": self.replicas,
            "traffic": self.traffic,
            "labels": self.labels,
            "annotations": self.annotations,
        }


# Method sets per unit type (Seldon's PredictorConfigBean).
TYPE_METHODS = {
    UnitType.MODEL: ("transform_input", "send_feedback"),
    UnitType.ROUTER: ("route", "send_feedback"),
    UnitType.COMBINER: ("aggregate",),
    UnitType.TRANSFORMER: ("transform_input",),
    UnitType.OUTPUT_TRANSFORMER: ("transform_output",),
    UnitType.UNKNOWN_TYPE: (),
}

# Implementations the engine runs in-process, no microservice call
# (Seldon's hardcoded units).
HARDCODED_IMPLEMENTATIONS = {
    UnitImplementation.SIMPLE_MODEL,
    UnitImplementation.SIMPLE_ROUTER,
    UnitImplementation.RANDOM_ABTEST,
    UnitImplementation.AVERAGE_COMBINER,
}


def default_unit_types(unit: PredictiveUnit) -> None:
    """Fill in unit types from implementations (Seldon's webhook
    defaulting)."""
    impl_types = {
        UnitImplementation.SIMPLE_MODEL: UnitType.MODEL,
        UnitImplementation.SIMPLE_ROUTER: UnitType.ROUTER,
        UnitImplementation.RANDOM_ABTEST: UnitType.ROUTER,
        UnitImplementation.AVERAGE_COMBINER: UnitType.COMBINER,
        UnitImplementation.SKLEARN_SERVER: UnitType.MODEL,
        UnitImplementation.XGBOOST_SERVER: UnitType.MODEL,
        UnitImplementation.TENSORFLOW_SERVER: UnitType.MODEL,
        UnitImplementation.MLFLOW_SERVER: UnitType.MODEL,
        UnitImplementation.JAX_SERVER: UnitType.MODEL,
    }
    for u in unit.walk():
        if u.type == UnitType.UNKNOWN_TYPE:
            u.type = impl_types.get(u.implementation, UnitType.MODEL)


def validate_spec(spec: PredictorSpec) -> List[str]:
    """Graph sanity checks (Seldon's validating webhook). Returns list of
    problems."""
    problems: List[str] = []
    names: Dict[str, int] = {}
    for u in spec.graph.walk():
        names[u.name] = names.get(u.name, 0) + 1
        if u.type == UnitType.COMBINER and not u.children:
            problems.append(f"combiner {u.name!r} has no children")
        if u.type == UnitType.ROUTER and not u.children:
            problems.append(f"router {u.name!r} has no children")
        if (
            u.implementation == UnitImplementation.UNKNOWN_IMPLEMENTATION
            and u.endpoint is None
            and u.type in (UnitType.MODEL, UnitType.TRANSFORMER,
                           UnitType.OUTPUT_TRANSFORMER, UnitType.ROUTER,
                           UnitType.COMBINER)
        ):
            problems.append(f"unit {u.name!r} has neither implementation nor endpoint")
        if u.implementation in (
            UnitImplementation.SKLEARN_SERVER,
            UnitImplementation.XGBOOST_SERVER,
            UnitImplementation.TENSORFLOW_SERVER,
            UnitImplementation.MLFLOW_SERVER,
            UnitImplementation.JAX_SERVER,
        ) and not u.model_uri:
            problems.append(f"prepackaged unit {u.name!r} requires modelUri")
    for n, c in names.items():
        if c > 1:
            problems.append(f"duplicate unit name {n!r}")
    return problems


def load_predictor_spec(
    env_var: str = "ENGINE_PREDICTOR",
    fallback_path: str = "./deploymentdef.json",
) -> PredictorSpec:
    """Seldon's predictor loading: base64(JSON) env, then file, then a
    hardwired SIMPLE_MODEL spec."""
    raw = os.environ.get(env_var)
    if raw:
        d = json.loads(base64.b64decode(raw).decode("utf-8"))
    elif os.path.exists(fallback_path):
        with open(fallback_path) as f:
            d = json.load(f)
    else:
        d = {
            "name": "default",
            "graph": {
                "name": "simple-model",
                "type": "MODEL",
                "implementation": "SIMPLE_MODEL",
            },
        }
    spec = PredictorSpec.from_dict(d)
    default_unit_types(spec.graph)
    problems = validate_spec(spec)
    if problems:
        raise ValueError(f"invalid predictor spec: {problems}")
    return spec
