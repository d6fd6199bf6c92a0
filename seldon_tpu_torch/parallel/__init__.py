"""Parallelism layer: device meshes of rank groups, group formation and
collectives, and ring attention (port of ``seldon_tpu/parallel``).

The JAX package's ``sharding.py`` and ``pipeline.py`` are the training
layout (Megatron specs, GPipe) and are not ported yet (ROADMAP.md A14);
its ``compat.py`` is a jax-version shim for ``shard_map`` with nothing to
port. Serving's exact-TP tables live in ``models/tp_sharding.py``.
"""

from seldon_tpu_torch.parallel.distributed import (RankGroup, SliceConfig,
                                                   SliceReadiness,
                                                   ensure_initialized,
                                                   init_group, route_for,
                                                   slice_config_from_env)
from seldon_tpu_torch.parallel.mesh import AXES, Mesh, MeshPlan, make_mesh

__all__ = [
    "AXES",
    "Mesh",
    "MeshPlan",
    "make_mesh",
    "RankGroup",
    "SliceConfig",
    "SliceReadiness",
    "ensure_initialized",
    "init_group",
    "route_for",
    "slice_config_from_env",
]
