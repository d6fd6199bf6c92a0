"""Payload codecs: numpy arrays <-> SeldonMessage protos <-> JSON.

Port of seldon_tpu/core/payloads.py; every function gives the JAX twin's
bytes on the same input. `DenseTensor` is the preferred wire type:
dtype-tagged raw bytes (bfloat16 included, through ml_dtypes where it is
installed), so arrays cross process boundaries without float64 widening
or JSON text. The codecs take anything `np.asarray` takes (a CPU tensor
included); a server hands back host arrays.
"""

from __future__ import annotations

import json
from typing import Any, List, Optional, Sequence, Union

import numpy as np

try:  # optional: without it DT_BFLOAT16 is not decoded
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except Exception:  # pragma: no cover
    ml_dtypes = None
    _BFLOAT16 = None

from google.protobuf import json_format
from google.protobuf.struct_pb2 import ListValue, Value

from seldon_tpu_torch.proto import prediction_pb2 as pb

__all__ = [
    "array_to_dense",
    "dense_to_array",
    "array_to_tensor",
    "tensor_to_array",
    "array_to_listvalue",
    "listvalue_to_array",
    "array_to_data",
    "data_to_array",
    "get_data_from_message",
    "build_message",
    "construct_response",
    "extract_request_parts",
    "message_to_dict",
    "dict_to_message",
]

# ---------------------------------------------------------------------------
# DenseTensor (packed tensor)
# ---------------------------------------------------------------------------

_DT_TO_NP = {
    pb.DT_FLOAT32: np.dtype(np.float32),
    pb.DT_FLOAT64: np.dtype(np.float64),
    pb.DT_FLOAT16: np.dtype(np.float16),
    pb.DT_INT8: np.dtype(np.int8),
    pb.DT_INT16: np.dtype(np.int16),
    pb.DT_INT32: np.dtype(np.int32),
    pb.DT_INT64: np.dtype(np.int64),
    pb.DT_UINT8: np.dtype(np.uint8),
    pb.DT_UINT16: np.dtype(np.uint16),
    pb.DT_UINT32: np.dtype(np.uint32),
    pb.DT_UINT64: np.dtype(np.uint64),
    pb.DT_BOOL: np.dtype(np.bool_),
}
if _BFLOAT16 is not None:
    _DT_TO_NP[pb.DT_BFLOAT16] = _BFLOAT16

_NP_TO_DT = {v: k for k, v in _DT_TO_NP.items()}


def array_to_dense(arr: Any) -> pb.DenseTensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    dt = _NP_TO_DT.get(arr.dtype)
    if dt is None:
        # Fall back to float32 for exotic dtypes rather than failing the wire.
        arr = arr.astype(np.float32)
        dt = pb.DT_FLOAT32
    return pb.DenseTensor(dtype=dt, shape=list(arr.shape), data=arr.tobytes())


def dense_to_array(dense: pb.DenseTensor, writable: bool = True) -> np.ndarray:
    """`writable=True` (default) copies out of the proto buffer so user hooks
    may mutate in place; internal fast paths that immediately hand the array
    on pass writable=False to skip the copy."""
    np_dtype = _DT_TO_NP.get(dense.dtype)
    if np_dtype is None:
        raise ValueError(f"unsupported DenseTensor dtype {dense.dtype}")
    arr = np.frombuffer(dense.data, dtype=np_dtype).reshape(tuple(dense.shape))
    return arr.copy() if writable else arr


# ---------------------------------------------------------------------------
# Tensor / ndarray (Seldon's original forms)
# ---------------------------------------------------------------------------


def array_to_tensor(arr: Any) -> pb.Tensor:
    arr = np.asarray(arr, dtype=np.float64)
    return pb.Tensor(shape=list(arr.shape), values=arr.ravel().tolist())


def tensor_to_array(tensor: pb.Tensor) -> np.ndarray:
    arr = np.asarray(tensor.values, dtype=np.float64)
    if tensor.shape:
        arr = arr.reshape(tuple(tensor.shape))
    return arr


def array_to_listvalue(arr: Any) -> ListValue:
    lv = ListValue()
    lv.extend(np.asarray(arr).tolist())
    return lv


def listvalue_to_array(lv: ListValue) -> np.ndarray:
    return np.asarray(json_format.MessageToDict(lv))


# ---------------------------------------------------------------------------
# DefaultData
# ---------------------------------------------------------------------------

_DATA_KINDS = ("dense", "tensor", "ndarray")


def array_to_data(
    arr: Any, names: Optional[Sequence[str]] = None, kind: str = "dense"
) -> pb.DefaultData:
    data = pb.DefaultData()
    if names:
        data.names.extend([str(n) for n in names])
    if kind == "dense":
        data.dense.CopyFrom(array_to_dense(arr))
    elif kind == "tensor":
        data.tensor.CopyFrom(array_to_tensor(arr))
    elif kind == "ndarray":
        data.ndarray.CopyFrom(array_to_listvalue(arr))
    else:
        raise ValueError(f"unknown data kind {kind!r}; expected one of {_DATA_KINDS}")
    return data


def data_to_array(data: pb.DefaultData) -> np.ndarray:
    which = data.WhichOneof("data_oneof")
    if which == "dense":
        return dense_to_array(data.dense)
    if which == "tensor":
        return tensor_to_array(data.tensor)
    if which == "ndarray":
        return listvalue_to_array(data.ndarray)
    return np.array([])


def data_kind(msg: pb.SeldonMessage) -> str:
    """Which payload form a message carries ('dense'|'tensor'|'ndarray'|
    'binData'|'strData'|'jsonData'|'')."""
    which = msg.WhichOneof("data_oneof")
    if which == "data":
        return msg.data.WhichOneof("data_oneof") or ""
    return which or ""


def get_data_from_message(msg: pb.SeldonMessage) -> Any:
    """Extract the payload: ndarray for data, bytes/str/py-obj otherwise."""
    which = msg.WhichOneof("data_oneof")
    if which == "data":
        return data_to_array(msg.data)
    if which == "binData":
        return msg.binData
    if which == "strData":
        return msg.strData
    if which == "jsonData":
        return json_format.MessageToDict(msg.jsonData)
    return np.array([])


def build_message(
    payload: Any,
    names: Optional[Sequence[str]] = None,
    kind: str = "dense",
    meta: Optional[pb.Meta] = None,
) -> pb.SeldonMessage:
    """Build a SeldonMessage around `payload` (array/bytes/str/dict)."""
    msg = pb.SeldonMessage()
    if meta is not None:
        msg.meta.CopyFrom(meta)
    if isinstance(payload, bytes):
        msg.binData = payload
    elif isinstance(payload, str):
        msg.strData = payload
    elif isinstance(payload, (dict, list)) and kind == "jsonData":
        json_format.ParseDict(payload, msg.jsonData)
    else:
        msg.data.CopyFrom(array_to_data(payload, names, kind))
    return msg


# ---------------------------------------------------------------------------
# Request/response plumbing used by the method dispatch layer
# ---------------------------------------------------------------------------


def extract_request_parts(msg: pb.SeldonMessage):
    """-> (payload, meta, datadef, data_kind).

    Seldon's `extract_request_parts`.
    """
    payload = get_data_from_message(msg)
    which = msg.WhichOneof("data_oneof")
    datadef = msg.data if which == "data" else None
    return payload, msg.meta, datadef, data_kind(msg)


def construct_response(
    user_model: Any,
    is_request: bool,
    client_request: pb.SeldonMessage,
    client_raw_response: Any,
    meta: Optional[pb.Meta] = None,
    tags: Optional[dict] = None,
    metrics: Optional[List[dict]] = None,
) -> pb.SeldonMessage:
    """Wrap a user function's raw output, mirroring the input payload form.

    Seldon's `construct_response`. The response uses
    the same wire form the request used (dense stays dense, tensor stays
    tensor, ...) so graph hops never silently widen dtypes.
    """
    if isinstance(client_raw_response, pb.SeldonMessage):
        return client_raw_response

    req_kind = data_kind(client_request)
    msg = pb.SeldonMessage()
    if meta is not None:
        msg.meta.CopyFrom(meta)
    if client_request.meta.puid:
        msg.meta.puid = client_request.meta.puid

    names: List[str] = []
    if user_model is not None:
        cn = getattr(user_model, "class_names", None)
        if callable(cn):
            try:
                names = list(cn() or [])
            except Exception:
                names = []
        elif isinstance(cn, (list, tuple)):
            names = list(cn)

    if isinstance(client_raw_response, bytes):
        msg.binData = client_raw_response
    elif isinstance(client_raw_response, str):
        msg.strData = client_raw_response
    elif isinstance(client_raw_response, dict) or (
        req_kind == "jsonData" and isinstance(client_raw_response, (dict, list))
    ):
        json_format.ParseDict(client_raw_response, msg.jsonData)
    else:
        kind = req_kind if req_kind in _DATA_KINDS else "dense"
        arr = np.asarray(client_raw_response)
        if arr.dtype.kind in "USO" and kind != "ndarray":
            # Non-numeric outputs (string labels, mixed objects) can't pack
            # into dense/tensor — fall back to the nested-list form, matching
            # Seldon's behaviour.
            kind = "ndarray"
        msg.data.CopyFrom(array_to_data(arr, names, kind))

    if tags:
        for k, v in tags.items():
            if isinstance(v, (dict, list)):
                json_format.ParseDict(v, msg.meta.tags[k])
            else:
                _set_value(msg.meta.tags[k], v)
    if metrics:
        add_metric_dicts(msg.meta.metrics, metrics)
    return msg


def add_metric_dicts(repeated_metrics, dicts) -> None:
    """Append metric DICTS ({key,value,type,tags}) onto a repeated
    pb.Metric field — the one definition of the dict->Metric wire
    conversion (used by construct_response and the wrapper's generate
    metrics absorption)."""
    for m in dicts:
        metric = repeated_metrics.add()
        metric.key = m.get("key", "")
        metric.value = float(m.get("value", 0.0))
        metric.type = pb.Metric.MetricType.Value(m.get("type", "COUNTER"))
        for tk, tv in (m.get("tags") or {}).items():
            metric.tags[tk] = str(tv)


def _set_value(value: Value, py: Any) -> None:
    if isinstance(py, bool):
        value.bool_value = py
    elif isinstance(py, (int, float)):
        value.number_value = float(py)
    elif py is None:
        value.null_value = 0
    else:
        value.string_value = str(py)


# ---------------------------------------------------------------------------
# JSON <-> proto (REST path)
# ---------------------------------------------------------------------------


def message_to_dict(msg) -> dict:
    """Proto -> plain dict. binData is base64'd; DenseTensor data is base64'd
    with dtype/shape kept readable."""
    return json_format.MessageToDict(msg, preserving_proto_field_name=True)


def dict_to_message(d: Union[dict, str], cls=pb.SeldonMessage):
    if isinstance(d, str):
        d = json.loads(d)
    msg = cls()
    json_format.ParseDict(d, msg, ignore_unknown_fields=True)
    return msg

