"""SeldonClient — the user-facing SDK, port of ``seldon_tpu/client.py``.

``predict`` / ``explain`` / ``feedback`` / ``microservice`` calls over REST
(JSON, or binary proto with ``transport="rest-proto"``) or gRPC against a
deployed predictor (the engine, or an ingress through
:meth:`SeldonClient.gateway_prefix`) or a bare unit microservice, and
``generate`` / ``generate_stream`` for the TextGen surface. The request
bytes are the JAX client's: the same payload helpers, the same proto
package on the wire."""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Iterator, Optional, Sequence

import numpy as np

from seldon_tpu_torch.core import payloads
from seldon_tpu_torch.proto import prediction_grpc
from seldon_tpu_torch.proto import prediction_pb2 as pb

from seldon_tpu_torch.core.http import PROTO_CONTENT_TYPE  # noqa: F401 (shared constant)


@dataclasses.dataclass
class ClientResponse:
    success: bool
    msg: Optional[pb.SeldonMessage] = None
    response: Optional[dict] = None
    error: str = ""

    @property
    def data(self):
        if self.msg is None:
            return None
        return payloads.get_data_from_message(self.msg)


class SeldonClient:
    def __init__(
        self,
        host: str = "localhost",
        port: int = 8000,
        grpc_port: int = 5001,
        transport: str = "grpc",  # "grpc" | "rest" | "rest-proto"
        timeout_s: float = 30.0,
        deployment: str = "",
        namespace: str = "default",
    ):
        self.host = host
        self.port = port
        self.grpc_port = grpc_port
        self.transport = transport
        self.timeout_s = timeout_s
        # Gateway routing identity: gRPC ingresses (ambassador Mapping,
        # reconciler.ambassador_annotations) route Seldon RPCs on the
        # `seldon`/`namespace` metadata — sent on every gRPC call when
        # `deployment` is set. REST uses gateway_prefix() paths instead.
        self.deployment = deployment
        self.namespace = namespace
        self._channel = None

    # --- plumbing -----------------------------------------------------------

    def _grpc_channel(self):
        import grpc

        if self._channel is None:
            self._channel = grpc.insecure_channel(
                f"{self.host}:{self.grpc_port}",
                options=[
                    ("grpc.max_send_message_length", 512 * 1024 * 1024),
                    ("grpc.max_receive_message_length", 512 * 1024 * 1024),
                ],
            )
        return self._channel

    def _rest(self, path: str, message, response_cls) -> ClientResponse:
        import urllib.error
        import urllib.request

        url = f"http://{self.host}:{self.port}{path}"
        if self.transport == "rest-proto":
            body = message.SerializeToString()
            headers = {"Content-Type": PROTO_CONTENT_TYPE}
        else:
            body = json.dumps(payloads.message_to_dict(message)).encode()
            headers = {"Content-Type": "application/json"}
        req = urllib.request.Request(url, data=body, headers=headers)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                raw = resp.read()
                ctype = resp.headers.get("Content-Type", "")
        except urllib.error.HTTPError as e:
            return ClientResponse(False, error=f"{e.code}: {e.read().decode('utf-8', 'replace')}")
        except OSError as e:
            return ClientResponse(False, error=str(e))
        if ctype.startswith(PROTO_CONTENT_TYPE):
            msg = response_cls.FromString(raw)
            return ClientResponse(True, msg=msg)
        d = json.loads(raw)
        return ClientResponse(
            True, msg=payloads.dict_to_message(d, response_cls), response=d
        )

    def _grpc_call(self, service: str, method: str, message,
                   response_cls) -> ClientResponse:
        import grpc

        stub = prediction_grpc.STUBS[service](self._grpc_channel())
        metadata = (
            [("seldon", self.deployment), ("namespace", self.namespace)]
            if self.deployment else None
        )
        try:
            out = getattr(stub, method)(
                message, timeout=self.timeout_s, metadata=metadata
            )
        except grpc.RpcError as e:
            return ClientResponse(False, error=f"{e.code().name}: {e.details()}")
        return ClientResponse(True, msg=out)

    @staticmethod
    def _build_request(
        data: Any = None,
        payload_kind: str = "dense",
        names: Optional[Sequence[str]] = None,
        msg: Optional[pb.SeldonMessage] = None,
    ) -> pb.SeldonMessage:
        if msg is not None:
            return msg
        return payloads.build_message(np.asarray(data), names=names,
                                      kind=payload_kind)

    # --- API ----------------------------------------------------------------

    @staticmethod
    def gateway_prefix(namespace: str, deployment: str) -> str:
        """Ingress route prefix for a deployed SeldonDeployment — the path
        Ambassador/Istio rewrite onto the engine
        (reconciler.ambassador_annotations / build_istio_manifests;
        reference seldon_client gateway='ambassador')."""
        return f"/seldon/{namespace}/{deployment}"

    def predict(self, data=None, names=None, payload_kind="dense",
                msg=None, gateway_prefix: str = "") -> ClientResponse:
        """Predict via the engine's external API (Seldon.Predict /
        /api/v0.1/predictions). `gateway_prefix` routes through an
        ingress instead of a bare engine (REST only — gRPC ingresses
        route on the seldon/namespace metadata headers, which
        _grpc_call already sends)."""
        request = self._build_request(data, payload_kind, names, msg)
        if self.transport.startswith("rest"):
            path = f"{gateway_prefix.rstrip('/')}/api/v0.1/predictions"
            return self._rest(path, request, pb.SeldonMessage)
        return self._grpc_call("Seldon", "Predict", request, pb.SeldonMessage)

    def explain(self, data=None, names=None, payload_kind="dense",
                msg=None, explainer_host: str = "",
                gateway_prefix: str = "") -> ClientResponse:
        """Attributions from the predictor's `-explainer` deployment
        (reference seldon_client.explain). Address the explainer one of
        two ways: `explainer_host` (direct host:port of the explainer
        service) or `gateway_prefix` (ingress prefix, e.g.
        `/seldon/ns/name-explainer/pred` — the istio route rewrites it
        onto the explainer's /predict)."""
        request = self._build_request(data, payload_kind, names, msg)
        if explainer_host:
            import requests as _rq

            r = _rq.post(
                f"http://{explainer_host}/predict",
                json=payloads.message_to_dict(request),
                timeout=self.timeout_s,
            )
            r.raise_for_status()
            return ClientResponse(
                True, payloads.dict_to_message(r.json()), r.json()
            )
        if not gateway_prefix:
            raise ValueError(
                "explain() needs explainer_host (direct) or gateway_prefix "
                "(ingress route) — the engine itself serves no /explain"
            )
        return self._rest(
            f"{gateway_prefix.rstrip('/')}/predict", request,
            pb.SeldonMessage,
        )

    def feedback(self, request_msg=None, response_msg=None, reward=0.0,
                 truth=None, gateway_prefix: str = "") -> ClientResponse:
        fb = pb.Feedback(reward=float(reward))
        if request_msg is not None:
            fb.request.CopyFrom(request_msg)
        if response_msg is not None:
            fb.response.CopyFrom(response_msg)
        if truth is not None:
            fb.truth.CopyFrom(
                truth if isinstance(truth, pb.SeldonMessage)
                else payloads.build_message(np.asarray(truth))
            )
        if self.transport.startswith("rest"):
            path = f"{gateway_prefix.rstrip('/')}/api/v0.1/feedback"
            return self._rest(path, fb, pb.SeldonMessage)
        return self._grpc_call("Seldon", "SendFeedback", fb, pb.SeldonMessage)

    _MICROSERVICE_METHODS = {
        "predict": ("Model", "Predict"),
        "transform_input": ("Generic", "TransformInput"),
        "transform_output": ("Generic", "TransformOutput"),
        "route": ("Router", "Route"),
        "aggregate": ("Combiner", "Aggregate"),
        "send_feedback": ("Generic", "SendFeedback"),
    }

    def microservice(self, data=None, method="predict", names=None,
                     payload_kind="dense", msg=None,
                     msgs=None) -> ClientResponse:
        """Call a bare unit microservice (reference `microservice` gateway).

        `aggregate` takes `msgs` (list of SeldonMessage, or list of arrays);
        `send_feedback` takes `msg` as a pb.Feedback."""
        if method not in self._MICROSERVICE_METHODS:
            return ClientResponse(
                False,
                error=f"unknown method {method!r}; expected one of "
                f"{sorted(self._MICROSERVICE_METHODS)}",
            )
        if method == "aggregate":
            if msgs is None and data is not None:
                # predict-style convenience: data = list of per-child arrays.
                msgs = list(data)
            if not msgs:
                return ClientResponse(
                    False,
                    error="aggregate requires msgs=[SeldonMessage|array, ...]",
                )
            request = pb.SeldonMessageList()
            for m in msgs:
                if isinstance(m, pb.SeldonMessage):
                    request.seldonMessages.append(m)
                else:
                    request.seldonMessages.append(
                        payloads.build_message(np.asarray(m), kind=payload_kind)
                    )
        elif method == "send_feedback":
            if not isinstance(msg, pb.Feedback):
                return ClientResponse(
                    False, error="send_feedback requires msg=pb.Feedback"
                )
            request = msg
        else:
            request = self._build_request(data, payload_kind, names, msg)
        if self.transport.startswith("rest"):
            path = "/" + method.replace("_", "-")
            return self._rest(path, request, pb.SeldonMessage)
        return self._grpc_call(
            *self._MICROSERVICE_METHODS[method], request, pb.SeldonMessage
        )

    def generate(self, prompt: str = "", prompt_token_ids=None,
                 max_new_tokens: int = 16, temperature: float = 0.7,
                 top_k: int = 0, top_p: float = 1.0,
                 seed: int = 0) -> Dict[str, Any]:
        req = pb.GenerateRequest(
            prompt=prompt,
            prompt_token_ids=list(prompt_token_ids or []),
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            top_k=top_k,
            top_p=top_p,
            seed=seed,
        )
        if self.transport.startswith("rest"):
            r = self._rest("/generate", req, pb.GenerateResponse)
            if not r.success:
                raise RuntimeError(r.error)
            out = r.msg
        else:
            import grpc

            stub = prediction_grpc.TextGenStub(self._grpc_channel())
            out = stub.Generate(req, timeout=self.timeout_s)
        return {
            "text": out.text,
            "token_ids": list(out.token_ids),
            "ttft_ms": out.ttft_ms,
            "total_ms": out.total_ms,
        }

    def generate_stream(self, prompt: str = "", max_new_tokens: int = 16,
                        **kw) -> Iterator[Dict[str, Any]]:
        req = pb.GenerateRequest(
            prompt=prompt, max_new_tokens=max_new_tokens,
            temperature=float(kw.get("temperature", 0.7)),
            top_k=int(kw.get("top_k", 0)), top_p=float(kw.get("top_p", 1.0)),
            seed=int(kw.get("seed", 0)),
        )
        stub = prediction_grpc.TextGenStub(self._grpc_channel())
        for chunk in stub.GenerateStream(req, timeout=self.timeout_s):
            yield {"text": chunk.text, "token_ids": list(chunk.token_ids),
                   "ttft_ms": chunk.ttft_ms}

    def close(self):
        if self._channel is not None:
            self._channel.close()
            self._channel = None
