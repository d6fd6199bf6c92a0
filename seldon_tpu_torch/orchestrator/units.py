"""Built-in (hardcoded) units the engine runs in-process.

Port of seldon_tpu/orchestrator/units.py: Seldon's SimpleModel,
SimpleRouter, RandomABTest and AverageCombiner units, which let a graph
run with zero microservices. The A/B branch is the same sha256 of seed
and puid as the JAX package's, so both engines route a request alike."""

from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np

from seldon_tpu_torch.core import payloads
from seldon_tpu_torch.proto import prediction_pb2 as pb


class SimpleModelUnit:
    """Fixed 3-class scores (Seldon's SimpleModelUnit)."""

    values = np.array([[0.9, 0.05, 0.05]])
    class_names = ["proba0", "proba1", "proba2"]

    def transform_input(self, msg: pb.SeldonMessage) -> pb.SeldonMessage:
        kind = payloads.data_kind(msg)
        out = payloads.build_message(
            self.values, names=self.class_names,
            kind=kind if kind in ("dense", "tensor", "ndarray") else "dense",
        )
        out.meta.CopyFrom(msg.meta)
        return out

    def send_feedback(self, feedback: pb.Feedback) -> None:
        return None


class SimpleRouterUnit:
    """Always routes to branch 0 (Seldon's SimpleRouterUnit)."""

    def route(self, msg: pb.SeldonMessage, n_children: int) -> int:
        return 0

    def send_feedback(self, feedback: pb.Feedback) -> None:
        return None


class RandomABTestUnit:
    """Deterministic pseudo-random 50/50 A/B split.

    Seldon's unit uses a seeded Random per unit; here, as in the JAX
    package, the branch is a hash of the request puid, so the choice is
    reproducible per request and across engine replicas."""

    def __init__(self, ratio_a: float = 0.5, seed: int = 1337):
        self.ratio_a = ratio_a
        self.seed = seed

    def route(self, msg: pb.SeldonMessage, n_children: int) -> int:
        h = hashlib.sha256(
            f"{self.seed}:{msg.meta.puid}".encode()
        ).digest()
        u = int.from_bytes(h[:8], "little") / 2**64
        return 0 if u < self.ratio_a else min(1, n_children - 1)

    def send_feedback(self, feedback: pb.Feedback) -> None:
        return None


class AverageCombinerUnit:
    """Elementwise mean over children outputs with shape checks
    (Seldon's AverageCombinerUnit)."""

    def aggregate(self, msgs: List[pb.SeldonMessage]) -> pb.SeldonMessage:
        if not msgs:
            raise ValueError("AverageCombiner: no inputs")
        arrays = []
        names: List[str] = []
        kind = "dense"
        for m in msgs:
            arr = payloads.get_data_from_message(m)
            if not isinstance(arr, np.ndarray):
                raise ValueError("AverageCombiner: non-tensor input")
            arrays.append(arr.astype(np.float64))
            k = payloads.data_kind(m)
            if k in ("dense", "tensor", "ndarray"):
                kind = k
            if m.HasField("data") and m.data.names:
                names = list(m.data.names)
        shape0 = arrays[0].shape
        for i, a in enumerate(arrays[1:], 1):
            if a.shape != shape0:
                raise ValueError(
                    f"AverageCombiner: input {i} shape {a.shape} != {shape0}"
                )
        mean = np.mean(np.stack(arrays), axis=0)
        return payloads.build_message(mean, names=names or None, kind=kind)


def make_hardcoded(implementation, parameters=None):
    from seldon_tpu_torch.orchestrator.spec import UnitImplementation

    params = {p.name: p.typed_value() for p in (parameters or [])}
    if implementation == UnitImplementation.SIMPLE_MODEL:
        return SimpleModelUnit()
    if implementation == UnitImplementation.SIMPLE_ROUTER:
        return SimpleRouterUnit()
    if implementation == UnitImplementation.RANDOM_ABTEST:
        return RandomABTestUnit(
            ratio_a=float(params.get("ratioA", 0.5)),
            seed=int(params.get("seed", 1337)),
        )
    if implementation == UnitImplementation.AVERAGE_COMBINER:
        return AverageCombinerUnit()
    raise ValueError(f"no hardcoded implementation for {implementation}")
