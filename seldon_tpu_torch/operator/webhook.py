"""Defaulting + validating webhooks as pure functions.

Port of seldon_tpu/operator/webhook.py (Seldon's seldondeployment_webhook.go
— DefaultSeldonDeployment: port assignment from 9000+, endpoint service
hosts, prepackaged-server container materialization, type defaulting;
ValidateCreate: graph/container match, modelUri required for prepack,
unique predictor names, traffic sums to 100). Defaulting and validation
match the JAX package's, messages included; only `PREPACKAGED_CLASSES`
differs: each implementation names the port's server
(`JAX_SERVER` -> `TorchServer`)."""

from __future__ import annotations

from typing import Dict, List

from seldon_tpu_torch.operator import types as T
from seldon_tpu_torch.orchestrator.spec import (
    Endpoint,
    EndpointType,
    PredictiveUnit,
    UnitImplementation,
    default_unit_types,
    validate_spec,
)

PREPACKAGED = {
    UnitImplementation.SKLEARN_SERVER,
    UnitImplementation.XGBOOST_SERVER,
    UnitImplementation.TENSORFLOW_SERVER,
    UnitImplementation.MLFLOW_SERVER,
    UnitImplementation.JAX_SERVER,
}

# Server class loaded by the microservice CLI per implementation (Seldon
# materializes docker images; here one image + class selection). The
# implementation names are the CRD's wire names; JAX_SERVER, the JAX
# package's LLM server, is served by the port's TorchServer.
PREPACKAGED_CLASSES = {
    UnitImplementation.SKLEARN_SERVER: "seldon_tpu_torch.servers.sklearnserver.SKLearnServer",
    UnitImplementation.XGBOOST_SERVER: "seldon_tpu_torch.servers.xgboostserver.XGBoostServer",
    UnitImplementation.MLFLOW_SERVER: "seldon_tpu_torch.servers.mlflowserver.MLFlowServer",
    UnitImplementation.TENSORFLOW_SERVER: "seldon_tpu_torch.servers.tfproxy.TFServingProxy",
    UnitImplementation.JAX_SERVER: "seldon_tpu_torch.servers.torchserver.TorchServer",
}


def default_deployment(sdep: T.SeldonDeployment) -> T.SeldonDeployment:
    """Fill defaults in place (and return it): traffic split, unit types,
    ports, service hosts, prepackaged images/classes."""
    _default_traffic(sdep)
    for pred in sdep.predictors:
        default_unit_types(pred.spec.graph)
        separate_engine = (
            sdep.annotations.get(T.ANNOTATION_SEPARATE_ENGINE, "false")
            == "true"
        )
        port = T.FIRST_UNIT_PORT
        for unit in pred.spec.graph.walk():
            if unit.implementation in PREPACKAGED and not unit.image:
                unit.image = T.DEFAULT_SERVER_IMAGE
                pred.component_images.setdefault(unit.name, unit.image)
            needs_endpoint = (
                unit.implementation
                not in (
                    UnitImplementation.SIMPLE_MODEL,
                    UnitImplementation.SIMPLE_ROUTER,
                    UnitImplementation.RANDOM_ABTEST,
                    UnitImplementation.AVERAGE_COMBINER,
                )
            )
            if not needs_endpoint:
                continue
            if unit.endpoint is None:
                unit.endpoint = Endpoint(type=EndpointType.GRPC)
            if unit.endpoint.service_port in (0, T.FIRST_UNIT_PORT) and (
                unit.endpoint.service_port != port
            ):
                unit.endpoint.service_port = port
            # Stride 2: seldon-tpu-native units serve the framed-proto
            # fast lane on service_port+1 (runtime/fastpath.py), so
            # consecutive allocation would collide with the next unit.
            port = max(port, unit.endpoint.service_port) + 2
            if not unit.endpoint.fast_port and _serves_fastpath(sdep, unit):
                unit.endpoint.fast_port = unit.endpoint.service_port + 1
            # Engine shares the pod with units unless separate-pod: then
            # units resolve via their container service DNS
            # (webhook.go:224-231).
            if not unit.endpoint.service_host or unit.endpoint.service_host == "localhost":
                if separate_engine:
                    unit.endpoint.service_host = (
                        f"{T.container_service_name(sdep, pred, unit)}."
                        f"{sdep.namespace}.svc.cluster.local."
                    )
                else:
                    unit.endpoint.service_host = "localhost"
    return sdep


def _serves_fastpath(sdep: T.SeldonDeployment, unit) -> bool:
    """Native images (our microservice runtime) serve the fast lane on
    gRPC-port+1; foreign images don't unless they opt in via the
    `seldon.io/fastpath: "true"` annotation ("false" opts native units
    out — e.g. when a NetworkPolicy only admits the gRPC port)."""
    override = sdep.annotations.get(T.ANNOTATION_FASTPATH, "")
    if override in ("true", "false"):
        return override == "true"
    image = unit.image or ""
    return (image.startswith("seldon-tpu/") or image.startswith("local/")
            or unit.implementation in PREPACKAGED)


def _default_traffic(sdep: T.SeldonDeployment) -> None:
    """Distribute unset (0) traffic: single predictor gets 100; with
    multiple, unset predictors split what the explicit ones left over."""
    preds = sdep.predictors
    if not preds:
        return
    unset = [p for p in preds if p.spec.traffic == 0]
    if not unset:
        return
    remainder = 100 - sum(p.spec.traffic for p in preds)
    if remainder <= 0:
        return  # explicit values already (over)claim; validation reports
    share, extra = divmod(remainder, len(unset))
    for i, p in enumerate(unset):
        p.spec.traffic = share + (1 if i < extra else 0)


def validate_deployment(sdep: T.SeldonDeployment) -> List[str]:
    problems: List[str] = []
    if not sdep.predictors:
        problems.append("deployment has no predictors")
    names = [p.spec.name for p in sdep.predictors]
    if len(set(names)) != len(names):
        problems.append(f"duplicate predictor names: {names}")
    traffic = sum(p.spec.traffic for p in sdep.predictors)
    if len(sdep.predictors) > 1 and traffic != 100:
        problems.append(
            f"traffic must sum to 100 across predictors, got {traffic}"
        )
    for pred in sdep.predictors:
        problems.extend(
            f"predictor {pred.spec.name!r}: {p}"
            for p in validate_spec(pred.spec)
        )
        if pred.tpu.chips:
            if pred.tpu.hosts < 1:
                problems.append(
                    f"predictor {pred.spec.name!r}: tpu.hosts must be >= 1"
                )
            if pred.tpu.hosts > 1 and not pred.tpu.topology:
                problems.append(
                    f"predictor {pred.spec.name!r}: multi-host tpu requires "
                    "an explicit topology"
                )
        if pred.hpa is not None and pred.tpu.hosts > 1:
            # An HPA scales pods one at a time, but a slice is only valid
            # in multiples of tpu.hosts — a partial slice never becomes
            # ready. Reject rather than flap.
            problems.append(
                f"predictor {pred.spec.name!r}: hpaSpec is not supported on "
                f"multi-host tpu predictors (slices scale in units of "
                f"{pred.tpu.hosts} hosts)"
            )
    return problems
