"""OpenAPI 3 schema for the SeldonMessage REST surface.

Port of seldon_tpu/core/openapi.py, served by the unit wrapper at
/seldon.json. Generated rather than vendored: the schema is derived from
one source of truth here, so routes and message shapes cannot drift from
the servers that mount it.
"""

from __future__ import annotations

from typing import Dict, List

SELDON_MESSAGE_SCHEMA: Dict = {
    "type": "object",
    "properties": {
        "status": {
            "type": "object",
            "properties": {
                "code": {"type": "integer"},
                "info": {"type": "string"},
                "reason": {"type": "string"},
                "status": {"type": "integer"},
            },
        },
        "meta": {
            "type": "object",
            "properties": {
                "puid": {"type": "string"},
                "tags": {"type": "object", "additionalProperties": True},
                "routing": {
                    "type": "object",
                    "additionalProperties": {"type": "integer"},
                },
                "requestPath": {
                    "type": "object",
                    "additionalProperties": {"type": "string"},
                },
                "metrics": {
                    "type": "array",
                    "items": {
                        "type": "object",
                        "properties": {
                            "key": {"type": "string"},
                            "type": {
                                "type": "string",
                                "enum": ["COUNTER", "GAUGE", "TIMER"],
                            },
                            "value": {"type": "number"},
                        },
                    },
                },
            },
        },
        "data": {
            "type": "object",
            "properties": {
                "names": {"type": "array", "items": {"type": "string"}},
                "ndarray": {"type": "array", "items": {}},
                "tensor": {
                    "type": "object",
                    "properties": {
                        "shape": {
                            "type": "array", "items": {"type": "integer"},
                        },
                        "values": {
                            "type": "array", "items": {"type": "number"},
                        },
                    },
                },
                "dense": {
                    "type": "object",
                    "description": "bf16 packed tensor (base64 data)",
                    "properties": {
                        "shape": {
                            "type": "array", "items": {"type": "integer"},
                        },
                        "dtype": {"type": "string"},
                        "data": {"type": "string", "format": "byte"},
                    },
                },
            },
        },
        "binData": {"type": "string", "format": "byte"},
        "strData": {"type": "string"},
        "jsonData": {},
    },
}

FEEDBACK_SCHEMA: Dict = {
    "type": "object",
    "properties": {
        "request": SELDON_MESSAGE_SCHEMA,
        "response": SELDON_MESSAGE_SCHEMA,
        "reward": {"type": "number"},
        "truth": SELDON_MESSAGE_SCHEMA,
    },
}


def _msg_op(summary: str, request_schema: Dict) -> Dict:
    return {
        "summary": summary,
        "requestBody": {
            "required": True,
            "content": {
                "application/json": {"schema": request_schema},
                "application/x-protobuf": {
                    "schema": {"type": "string", "format": "binary"}
                },
            },
        },
        "responses": {
            "200": {
                "description": "SeldonMessage response",
                "content": {
                    "application/json": {"schema": SELDON_MESSAGE_SCHEMA}
                },
            },
            "400": {"description": "malformed request"},
            "500": {"description": "user code / graph failure"},
        },
    }


def unit_openapi(service_name: str = "seldon-tpu-microservice") -> Dict:
    """Spec for the per-unit microservice routes (wrapper.py)."""
    paths: Dict = {}
    for route, summary in [
        ("/predict", "Model prediction"),
        ("/transform-input", "Input transformation"),
        ("/transform-output", "Output transformation"),
        ("/route", "Router branch selection"),
        ("/aggregate", "Combiner aggregation"),
    ]:
        paths[route] = {"post": _msg_op(summary, SELDON_MESSAGE_SCHEMA)}
    paths["/send-feedback"] = {
        "post": _msg_op("Reward feedback", FEEDBACK_SCHEMA)
    }
    for route in list(paths):
        paths[f"/api/v0.1{route}"] = paths[route]
    paths["/generate"] = {
        "post": {
            "summary": "Text generation (jaxserver)",
            "requestBody": {
                "required": True,
                "content": {"application/json": {"schema": {
                    "type": "object",
                    "properties": {
                        "prompt": {"type": "string"},
                        "max_new_tokens": {"type": "integer"},
                        "temperature": {"type": "number"},
                        "top_k": {"type": "integer"},
                        "top_p": {"type": "number"},
                        "seed": {"type": "integer"},
                    },
                }}},
            },
            "responses": {"200": {"description": "generated text"}},
        }
    }
    paths["/live"] = {"get": {"summary": "liveness",
                              "responses": {"200": {"description": "ok"}}}}
    paths["/ready"] = {
        "get": {"summary": "readiness (incl. slice formation)",
                "responses": {"200": {"description": "ready"},
                              "503": {"description": "not ready"}}}
    }
    paths["/metadata"] = {
        "get": {"summary": "model metadata",
                "responses": {"200": {"description": "metadata JSON"}}}
    }
    for route in ("/metrics", "/prometheus"):
        paths[route] = {
            "get": {"summary": "prometheus exposition",
                    "responses": {"200": {"description": "metrics text"}}}
        }
    paths["/seldon.json"] = {
        "get": {"summary": "this schema",
                "responses": {"200": {"description": "OpenAPI document"}}}
    }
    return {
        "openapi": "3.0.3",
        "info": {"title": service_name, "version": "0.1.0"},
        "paths": paths,
    }

