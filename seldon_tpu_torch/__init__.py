"""seldon_tpu_torch — the PyTorch/CUDA port of seldon_tpu.

Module for module it mirrors ``seldon_tpu/`` (``models/transformer.py``
is held against ``seldon_tpu/models/transformer.py`` by
``tests/test_torch_transformer.py``, and so on). It imports torch,
numpy and, in the serving runtime and the orchestrator (``proto/``,
``core/payloads.py``, ``core/http.py``, ``runtime/``, ``orchestrator/``,
which imports no torch), the transport libraries (aiohttp, grpcio,
protobuf): never jax, never the JAX package.

Entry points (``TorchServer``, ``InferenceEngine``, ``init_params``) run
on the CUDA device unless the caller passes ``device="cpu"``; with no
CUDA device and no explicit ``"cpu"`` they raise.
"""
