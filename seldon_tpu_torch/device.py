"""Device resolution shared by the port's entry points, and the GEMM
settings every process of the serving engine reports."""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another one. Never falls back to the CPU on its own — with no
    CUDA device and no explicit ``"cpu"`` this raises."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port on the CPU explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


def same_device(a: torch.device, b: Optional[torch.device]) -> bool:
    """True when tensors on ``b`` can be used where ``a`` is expected
    (``cuda`` and ``cuda:<current>`` name the same card)."""
    if b is None or a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    cur = torch.cuda.current_device()
    return (a.index if a.index is not None else cur) == (
        b.index if b.index is not None else cur
    )


def configure_gemms() -> Dict[str, Any]:
    """What decides this process's GEMM bits beside their shapes and the
    code: the reduced-precision and TF32 flags PyTorch hands cuBLAS. The
    port sets none of them (its column-sharded projections run through
    ``ops/lt_gemm``, whose algorithm does not depend on the share of the
    columns); every process of the serving engine reports them (the
    tp = 1 engine, rank 0 and each worker rank, before it joins the
    group), and ``MeshEngine`` refuses a group whose ranks report other
    settings than rank 0 (ROADMAP.md C18)."""
    m = torch.backends.cuda.matmul
    return {
        "bf16_reduced_precision_reduction":
            m.allow_bf16_reduced_precision_reduction,
        "fp16_reduced_precision_reduction":
            m.allow_fp16_reduced_precision_reduction,
        "tf32": m.allow_tf32,
    }
