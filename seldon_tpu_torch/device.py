"""Device resolution shared by the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

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
