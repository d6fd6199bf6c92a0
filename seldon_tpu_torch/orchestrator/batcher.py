"""Dynamic micro-batcher for MODEL leaf calls.

Port of seldon_tpu/orchestrator/batcher.py. Concurrent in-flight requests
to the same unit fuse along axis 0 into one leaf call within a small time
window, so an accelerator leaf sees one batch instead of many batch-1
calls, and the response splits back per request (BatchIndex framing in
the proto records the fusion for tracing).

Safety: only `data` payloads (dense/tensor/ndarray) with identical trailing
shapes and dtypes fuse; anything else falls through to a direct call."""

from __future__ import annotations

import asyncio
import logging
from typing import Dict, List, Optional, Tuple

import numpy as np

from seldon_tpu_torch.core import payloads
from seldon_tpu_torch.orchestrator.spec import PredictiveUnit
from seldon_tpu_torch.proto import prediction_pb2 as pb

logger = logging.getLogger(__name__)


class _Pending:
    __slots__ = ("msg", "arr", "future", "puid", "kind", "tag_sig")

    def __init__(self, msg, arr, future, puid, kind):
        self.msg = msg
        self.arr = arr
        self.future = future
        self.puid = puid
        self.kind = kind
        # Canonical request-tag fingerprint: only requests with IDENTICAL
        # tags co-batch, so the fused request can carry those tags and the
        # unit sees exactly what it would on the direct (unbatched) path.
        self.tag_sig = tuple(sorted(
            (k, v.SerializeToString(deterministic=True))
            for k, v in msg.meta.tags.items()
        ))


class MicroBatcher:
    def __init__(
        self,
        max_batch_size: int = 32,
        window_ms: float = 2.0,
        max_queue: int = 1024,
    ):
        self.max_batch_size = max_batch_size
        self.window_s = window_ms / 1000.0
        self.max_queue = max_queue
        # unit name -> (signature, pending list, flush handle)
        self._queues: Dict[str, List[_Pending]] = {}
        self._timers: Dict[str, asyncio.TimerHandle] = {}
        self._locks: Dict[str, asyncio.Lock] = {}
        self.stats = {"fused_calls": 0, "direct_calls": 0,
                      "batched_requests": 0, "tag_flushes": 0}

    @staticmethod
    def _batchable(msg: pb.SeldonMessage) -> Optional[np.ndarray]:
        if msg.WhichOneof("data_oneof") != "data":
            return None
        # A request already carrying a batch_index tag (nested/upstream
        # batching) must not fuse: the framing key would collide.
        if "batch_index" in msg.meta.tags:
            return None
        arr = payloads.data_to_array(msg.data)
        # ndim >= 2 required: a 1-D array is one sample's feature vector,
        # not a row batch — concatenating those would corrupt semantics.
        if not isinstance(arr, np.ndarray) or arr.ndim < 2 or arr.dtype.kind not in "fiub":
            return None
        return arr

    def _lock(self, name: str) -> asyncio.Lock:
        if name not in self._locks:
            self._locks[name] = asyncio.Lock()
        return self._locks[name]

    async def call(self, unit: PredictiveUnit, msg: pb.SeldonMessage, client):
        arr = self._batchable(msg)
        if arr is None:
            self.stats["direct_calls"] += 1
            return await client.call(unit, "predict", msg)

        loop = asyncio.get_running_loop()
        fut: asyncio.Future = loop.create_future()
        pend = _Pending(
            msg, arr, fut, msg.meta.puid,
            payloads.data_kind(msg) or "dense",
        )
        to_exec: List[List[_Pending]] = []
        async with self._lock(unit.name):
            q = self._queues.setdefault(unit.name, [])
            if q and (
                q[0].arr.shape[1:] != arr.shape[1:]
                or q[0].arr.dtype != arr.dtype
                or q[0].tag_sig != pend.tag_sig
            ):
                # Shape/dtype/tag mismatch with the open batch: flush it
                # first. tag_flushes makes tag-driven batching collapse
                # observable (a per-request-unique upstream tag silently
                # degrades every leaf call to batch-1 otherwise).
                if q[0].tag_sig != pend.tag_sig:
                    self.stats["tag_flushes"] += 1
                to_exec.append(self._take(unit.name))
                q = self._queues.setdefault(unit.name, [])
            q.append(pend)
            n_rows = sum(p.arr.shape[0] for p in q)
            if n_rows >= self.max_batch_size or len(q) >= self.max_queue:
                to_exec.append(self._take(unit.name))
            elif len(q) == 1:
                self._timers[unit.name] = loop.call_later(
                    self.window_s,
                    lambda: asyncio.ensure_future(
                        self._timer_flush(unit, client)
                    ),
                )
        for batch in to_exec:
            # Execute OUTSIDE the lock so new submitters keep queueing.
            await self._execute(unit, batch, client)
        return await fut

    def _take(self, name: str) -> List[_Pending]:
        """Pop the open batch; caller must hold the unit lock."""
        q = self._queues.pop(name, [])
        timer = self._timers.pop(name, None)
        if timer is not None:
            timer.cancel()
        return q

    async def _timer_flush(self, unit: PredictiveUnit, client):
        async with self._lock(unit.name):
            q = self._take(unit.name)
        if q:
            await self._execute(unit, q, client)

    async def _execute(self, unit: PredictiveUnit, q: List[_Pending], client):
        if not q:
            return
        if len(q) == 1:
            p = q[0]
            self.stats["direct_calls"] += 1
            try:
                resp = await client.call(unit, "predict", p.msg)
                if not p.future.done():
                    p.future.set_result(resp)
            except Exception as e:
                if not p.future.done():
                    p.future.set_exception(e)
            return

        from seldon_tpu_torch import native

        fused = native.fuse_rows([p.arr for p in q])
        kind = q[0].kind
        req = payloads.build_message(fused, kind=kind)
        req.meta.puid = q[0].puid or "fused"
        # Co-batched requests are guaranteed (by tag_sig grouping) to carry
        # IDENTICAL tags, so forwarding q[0]'s tags gives the unit the same
        # view as the direct path, and nothing cross-request can leak: any
        # tag echoed back belongs to every requester in the batch equally.
        for k, v in q[0].msg.meta.tags.items():
            req.meta.tags[k].CopyFrom(v)
        bi = pb.BatchIndex(
            puids=[p.puid for p in q],
            row_counts=[p.arr.shape[0] for p in q],
        )
        req.meta.tags["batch_index"].string_value = bi.SerializeToString().hex()
        self.stats["fused_calls"] += 1
        self.stats["batched_requests"] += len(q)
        try:
            resp = await client.call(unit, "predict", req)
            out = payloads.get_data_from_message(resp)
            if not isinstance(out, np.ndarray) or out.shape[0] != fused.shape[0]:
                raise ValueError(
                    f"batched response rows {getattr(out, 'shape', None)} "
                    f"!= request rows {fused.shape[0]}"
                )
            names = list(resp.data.names) if resp.HasField("data") else None
            # Non-numeric unit output (e.g. string class labels) can't ride
            # the dense/tensor encodings — fall back to ndarray for all
            # splits, matching construct_response's direct-path gate (kind
            # in "USO"; note bfloat16 has dtype.kind 'V' and IS numeric).
            numeric = out.dtype.kind not in "USO"
            row = 0
            for p in q:
                n = p.arr.shape[0]
                # Each request's reply uses ITS OWN payload kind, so the
                # wire encoding never depends on co-batched traffic.
                sub = payloads.build_message(
                    out[row: row + n], names=names,
                    kind=p.kind if numeric else "ndarray",
                )
                sub.meta.CopyFrom(resp.meta)
                sub.meta.puid = p.puid
                if "batch_index" in sub.meta.tags:
                    del sub.meta.tags["batch_index"]
                row += n
                if not p.future.done():
                    p.future.set_result(sub)
        except Exception as e:
            for p in q:
                if not p.future.done():
                    p.future.set_exception(e)
