"""Graph orchestrator ("engine"): the request path of a predictor.

Port of seldon_tpu/orchestrator/, module for module and name for name.
A per-predictor process walks the inference graph at request time,
calls each predictive unit over gRPC, REST or the framed fast lane,
merges Meta (tags, routing, requestPath, metrics) at every hop, and
sends feedback back down the recorded path. Fan-out over graph
branches is `asyncio.gather`; dynamic micro-batching at MODEL leaves
(batcher.py) fuses concurrent requests into one leaf call (BatchIndex
framing). The orchestrator is host code: it imports neither torch nor
jax, and its units run wherever they were built (a `TorchServer` unit
on its CUDA device unless it was built with `device="cpu"`).
"""

from seldon_tpu_torch.orchestrator.spec import (
    PredictiveUnit,
    PredictorSpec,
    UnitType,
    load_predictor_spec,
)
from seldon_tpu_torch.orchestrator.walker import PredictorEngine

__all__ = [
    "PredictiveUnit",
    "PredictorSpec",
    "UnitType",
    "load_predictor_spec",
    "PredictorEngine",
]
