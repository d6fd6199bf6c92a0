"""Shared HTTP content negotiation for the proto/JSON dual REST surface.

Port of seldon_tpu/core/http.py: one definition of the proto content type
and the request-parse/response-serialize logic, used by both the unit
wrapper (runtime/wrapper.py) and the engine server
(orchestrator/server.py)."""

from __future__ import annotations

import json

from aiohttp import web

from seldon_tpu_torch.core import payloads

PROTO_CONTENT_TYPE = "application/x-protobuf"
JSON_CONTENT_TYPE = "application/json"


def to_json_bytes(msg) -> bytes:
    """THE client-side JSON encoding of a proto message — one definition
    of the wire convention (field naming etc.), mirrored server-side by
    parse_message/reply. Used for foreign-language JSON units and the
    JSON client transports."""
    return json.dumps(payloads.message_to_dict(msg)).encode()


async def parse_message(request: web.Request, req_cls):
    """-> (proto message, encoding 'proto'|'json'). Accepts binary proto,
    JSON bodies, form `json=` fields, GET `?json=` query params, and
    `multipart/form-data` (file/field parts merged into one message)."""
    ctype = request.headers.get("Content-Type", "")
    if ctype.startswith(PROTO_CONTENT_TYPE):
        return req_cls.FromString(await request.read()), "proto"
    if request.method == "GET":
        raw = request.query.get("json")
        if raw is None:
            raise ValueError("empty json parameter in request")
        return payloads.dict_to_message(json.loads(raw), req_cls), "json"
    if ctype.startswith("application/json"):
        return payloads.dict_to_message(await request.json(), req_cls), "json"
    form = await request.post()
    if ctype.startswith("multipart/form-data"):
        return _merge_multipart(form, req_cls), "json"
    raw = form.get("json")
    if raw is None:
        raise ValueError("no json payload in request")
    return payloads.dict_to_message(json.loads(raw), req_cls), "json"


def _merge_multipart(form, req_cls):
    """Multipart prediction ingestion (Seldon's REST multipart form):
    every part key is a top-level
    SeldonMessage field; a part named `strData` (case-insensitive)
    contributes its content as text, file bytes under any other key are
    base64 (the proto-JSON encoding of `binData`), and plain fields are
    parsed as JSON subtrees (`data`, `jsonData`, `meta`, ...)."""
    import base64

    merged = {}
    for key, val in form.items():
        is_file = hasattr(val, "file")  # aiohttp FileField
        if key.lower() == "strdata":
            data = val.file.read() if is_file else val
            merged["strData"] = (
                data.decode() if isinstance(data, bytes) else data
            )
        elif is_file:
            raw = val.file.read()
            merged["binData" if key.lower() == "bindata" else key] = (
                base64.b64encode(raw).decode()
            )
        elif key.lower() == "bindata":
            merged["binData"] = val  # already base64 text
        else:
            merged[key] = json.loads(val)
    return payloads.dict_to_message(merged, req_cls)


def reply(msg, encoding: str) -> web.Response:
    if encoding == "proto":
        return web.Response(
            body=msg.SerializeToString(), content_type=PROTO_CONTENT_TYPE
        )
    return web.json_response(payloads.message_to_dict(msg))
