"""Parallelism layer: device meshes of rank groups, group formation and
collectives, the training sharding rules and pipeline, and ring
attention (port of ``seldon_tpu/parallel``).

``sharding.py`` holds the TRAINING tables (Megatron specs; each rank's
cut of a tree); serving's exact-TP tables live in
``models/tp_sharding.py``. The JAX package's ``compat.py`` is a
jax-version shim for ``shard_map`` with nothing to port.
"""

from seldon_tpu_torch.parallel.distributed import (MeshRanks, RankGroup,
                                                   SliceConfig,
                                                   SliceReadiness,
                                                   ensure_initialized,
                                                   init_group, route_for,
                                                   slice_config_from_env)
from seldon_tpu_torch.parallel.mesh import AXES, Mesh, MeshPlan, make_mesh
from seldon_tpu_torch.parallel.pipeline import (make_pipeline_forward,
                                                pp_param_pspecs)
from seldon_tpu_torch.parallel.sharding import (activation_pspec,
                                                batch_pspec, cache_pspec,
                                                named_shardings,
                                                param_pspecs, shard_tree)

__all__ = [
    "AXES",
    "Mesh",
    "MeshPlan",
    "make_mesh",
    "make_pipeline_forward",
    "pp_param_pspecs",
    "param_pspecs",
    "cache_pspec",
    "batch_pspec",
    "activation_pspec",
    "shard_tree",
    "named_shardings",
    "MeshRanks",
    "RankGroup",
    "SliceConfig",
    "SliceReadiness",
    "ensure_initialized",
    "init_group",
    "route_for",
    "slice_config_from_env",
]
