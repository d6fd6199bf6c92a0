"""Hand-written gRPC bindings for the seldon_tpu_torch prediction protocol.

The seven per-unit-type services of the Seldon protocol (Generic, Model,
Router, Transformer, OutputTransformer, Combiner, Seldon) plus the
`TextGen` service for LLM serving (unary and server-streaming token
generation), under the proto package `seldon_tpu.protos`: the method
paths are the JAX package's (`seldon_tpu/proto/prediction_grpc.py`), so
either package's stubs reach either server.

Written against grpcio's generic-handler API instead of grpc_tools codegen.
Each service is described once in `_SERVICES`; client stub classes and server
registration helpers are derived from that table.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import grpc

from seldon_tpu_torch.proto import prediction_pb2 as pb

_PKG = "seldon_tpu.protos"

_SM = pb.SeldonMessage
_FB = pb.Feedback
_SML = pb.SeldonMessageList
_GRQ = pb.GenerateRequest
_GRS = pb.GenerateResponse

# service -> method -> (request_cls, response_cls, arity)
# arity: "unary" or "stream" (server-streaming response).
_SERVICES: Dict[str, Dict[str, Tuple[Any, Any, str]]] = {
    "Generic": {
        "TransformInput": (_SM, _SM, "unary"),
        "TransformOutput": (_SM, _SM, "unary"),
        "Route": (_SM, _SM, "unary"),
        "Aggregate": (_SML, _SM, "unary"),
        "SendFeedback": (_FB, _SM, "unary"),
    },
    "Model": {
        "Predict": (_SM, _SM, "unary"),
        "SendFeedback": (_FB, _SM, "unary"),
    },
    "Router": {
        "Route": (_SM, _SM, "unary"),
        "SendFeedback": (_FB, _SM, "unary"),
    },
    "Transformer": {
        "TransformInput": (_SM, _SM, "unary"),
    },
    "OutputTransformer": {
        "TransformOutput": (_SM, _SM, "unary"),
    },
    "Combiner": {
        "Aggregate": (_SML, _SM, "unary"),
    },
    # External-facing orchestrator API.
    "Seldon": {
        "Predict": (_SM, _SM, "unary"),
        "SendFeedback": (_FB, _SM, "unary"),
    },
    # LLM serving API.
    "TextGen": {
        "Generate": (_GRQ, _GRS, "unary"),
        "GenerateStream": (_GRQ, _GRS, "stream"),
    },
}


def method_path(service: str, method: str) -> str:
    return f"/{_PKG}.{service}/{method}"


# ---------------------------------------------------------------------------
# Server side
# ---------------------------------------------------------------------------


def generic_handler(service: str, impl: Any) -> grpc.GenericRpcHandler:
    """Build a GenericRpcHandler for `service` backed by `impl`.

    `impl` provides a method per RPC (e.g. `Predict(request, context)`); only
    the methods it actually defines are registered.
    """
    methods = _SERVICES[service]
    handlers: Dict[str, grpc.RpcMethodHandler] = {}
    for name, (req_cls, resp_cls, arity) in methods.items():
        fn = getattr(impl, name, None)
        if fn is None:
            continue
        if arity == "unary":
            handlers[name] = grpc.unary_unary_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
        else:
            handlers[name] = grpc.unary_stream_rpc_method_handler(
                fn,
                request_deserializer=req_cls.FromString,
                response_serializer=lambda m: m.SerializeToString(),
            )
    return grpc.method_handlers_generic_handler(f"{_PKG}.{service}", handlers)


def add_servicer(server: grpc.Server, service: str, impl: Any) -> None:
    server.add_generic_rpc_handlers((generic_handler(service, impl),))


# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------


class _Stub:
    """Base for derived stub classes: one callable per RPC method."""

    _service: str = ""

    def __init__(self, channel: grpc.Channel):
        for name, (req_cls, resp_cls, arity) in _SERVICES[self._service].items():
            path = method_path(self._service, name)
            if arity == "unary":
                rpc = channel.unary_unary(
                    path,
                    request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=resp_cls.FromString,
                )
            else:
                rpc = channel.unary_stream(
                    path,
                    request_serializer=lambda m: m.SerializeToString(),
                    response_deserializer=resp_cls.FromString,
                )
            setattr(self, name, rpc)


def _make_stub(service: str) -> type:
    return type(f"{service}Stub", (_Stub,), {"_service": service})


GenericStub = _make_stub("Generic")
ModelStub = _make_stub("Model")
RouterStub = _make_stub("Router")
TransformerStub = _make_stub("Transformer")
OutputTransformerStub = _make_stub("OutputTransformer")
CombinerStub = _make_stub("Combiner")
SeldonStub = _make_stub("Seldon")
TextGenStub = _make_stub("TextGen")

STUBS: Dict[str, Callable[[grpc.Channel], Any]] = {
    "Generic": GenericStub,
    "Model": ModelStub,
    "Router": RouterStub,
    "Transformer": TransformerStub,
    "OutputTransformer": OutputTransformerStub,
    "Combiner": CombinerStub,
    "Seldon": SeldonStub,
    "TextGen": TextGenStub,
}
