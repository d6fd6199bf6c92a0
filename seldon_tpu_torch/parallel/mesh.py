"""Device meshes of rank groups — port of ``seldon_tpu/parallel/mesh.py``.

The axis vocabulary and :class:`MeshPlan` are the JAX module's, field for
field (``tp`` innermost: the most communication-intensive axis maps to
adjacent devices). Where JAX builds a ``jax.sharding.Mesh`` over the
devices one process drives, the port runs one process per rank
(``torch.distributed``), so :func:`make_mesh` returns a rank-group
description: the devices of the ranks, laid out over ``AXES``. Rank ``r``
of a group runs on ``mesh.flat_devices()[r]``. A list may name one card
more than once: two ranks then share it (``servers/mesh_engine.py``).

Axes:
  dp — data parallel (batch sharding; serving: independent request lanes)
  pp — pipeline parallel (layer-stage sharding; 1 unless enabled)
  sp — sequence/context parallel (ring attention over long sequences)
  tp — tensor parallel (exact head/ffn sharding, models/tp_sharding.py)
  ep — expert parallel (MoE expert sharding; 1 for dense models)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike

AXES = ("dp", "pp", "sp", "ep", "tp")  # tp innermost → adjacent devices


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A named factorization of the device count over the parallel axes."""

    dp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.sp * self.tp * self.ep

    def axis_sizes(self) -> dict:
        return {a: getattr(self, a) for a in AXES}

    @staticmethod
    def auto(n_devices: int, cfg=None) -> "MeshPlan":
        """Pick a sane default factorization for `n_devices`.

        Serving default: TP as wide as the model's KV heads allow (TP must
        divide n_kv_heads so KV cache shards evenly), DP for the rest.
        """
        if n_devices == 1:
            return MeshPlan()
        tp_cap = n_devices
        if cfg is not None:
            tp_cap = math.gcd(n_devices, cfg.n_kv_heads)
        tp = 1
        # Largest power-of-two tp ≤ tp_cap that divides n_devices.
        while tp * 2 <= tp_cap and n_devices % (tp * 2) == 0:
            tp *= 2
        return MeshPlan(dp=n_devices // tp, tp=tp)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of a rank group laid out over ``axis_names``:
    ``devices`` is an object array of ``torch.device`` shaped by the plan
    (the JAX ``Mesh`` layout). ``shape`` maps each axis to its size."""

    devices: np.ndarray
    axis_names: tuple = AXES

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def flat_devices(self) -> List[torch.device]:
        """The devices in rank order."""
        return list(self.devices.reshape(-1))


def cuda_devices() -> List[torch.device]:
    """Every visible card, in index order. Raises when there is none: a
    group is built on the card unless the caller names its devices."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass an explicit device list "
            "(e.g. ['cpu', 'cpu']) to build a group on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(plan: MeshPlan,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    devices = [torch.device(d) for d in (
        devices if devices is not None else cuda_devices())]
    if len(devices) < plan.n_devices:
        raise ValueError(
            f"mesh plan needs {plan.n_devices} devices, have {len(devices)}"
        )
    arr = np.empty(plan.n_devices, dtype=object)
    arr[:] = devices[: plan.n_devices]
    return Mesh(arr.reshape(plan.dp, plan.pp, plan.sp, plan.ep, plan.tp),
                AXES)
