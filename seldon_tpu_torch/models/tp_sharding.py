"""Sharding tables of EXACT tensor parallelism over the 'tp' axis — port
of ``seldon_tpu/models/tp_sharding.py``.

The serving engine's contract is bit-identical greedy output in every
configuration pair it ships, so the TP scheme is exact, not
Megatron-exact-ish: only OUTPUT dimensions are sharded, never a
contraction, so every output element is reduced in the same order as at
tp=1.

 * ``wq`` / ``wk`` / ``wv`` are partitioned on their head output axis
   (the last dim): every rank computes the FULL ``d_model`` contraction
   for its own contiguous slice of heads.
 * attention runs per KV head on the rank's own heads (GQA groups stay
   rank-local since tp | n_kv_heads); softmax reduces over the token
   axis, which is never sharded.
 * the attention output is ALL-GATHERED (pure data movement, exact in
   any dtype) and ``wo`` is REPLICATED: every rank repeats the wo GEMM.
 * ``w_gate`` / ``w_up`` shard on the ``d_ff`` output axis; the SwiGLU
   hidden is all-gathered and ``w_down`` is replicated, same argument.
 * embeddings / lm_head / norms are replicated, so logits and samples
   are identical on every rank.
 * the KV cache (dense slab or paged pool) shards on its ``Hkv`` axis;
   block tables stay host-side and rank 0's alone.

W8A8 stays exact: the per-token activation scale is a max over the
unsharded feature axis, int8 x int8 -> int32 is exact, and a sharded
weight's per-output-channel scales ride with their output slice. MoE
blocks are not sharded (their expert_out contracts d_ff): every block
weight replicates and the heads are sliced after the projection.

Where JAX commits arrays onto a ``NamedSharding`` inside one process,
the port runs one process per rank (``parallel/distributed.RankGroup``):
:func:`shard_params` returns THIS rank's ``Transformer``, each sharded
leaf cut to its contiguous part ``[r*n/tp, (r+1)*n/tp)`` of the last dim
(for ``wq`` the head-major slice of heads, as JAX's sharding lays it
out) and each replicated leaf the caller's own tensor. :class:`TpHints`
keeps JAX's four verbs: ``heads`` and ``flat`` check (or cut) the local
shard, ``gather`` is the group's all-gather on the last axis in rank
order, ``constrain_state`` checks every state leaf's shard shape; and
``pad_heads`` / ``own_heads`` run the dense decode's and the ragged
wave's fresh attention products, and the sparse walk's block scores,
batched over heads, at tp = 1's head count, which on the card keeps
cuBLAS's algorithm, and so every head's bits, what they are at tp = 1
(the prefill's and the verify wave's products were seen equal unpadded;
ROADMAP.md C18).
:func:`init_shard` builds a rank's shard from a seed without the whole
model (every rank replays ``transformer.init_params``' draws and keeps
its part), as the JAX server seeds under ``out_shardings``.

Divisibility contract (``validate``): tp | n_kv_heads (and hence
tp | n_heads via GQA) and tp | d_ff.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.parallel.mesh import AXES

TP_AXIS = AXES[-1]  # "tp" — the innermost axis of the mesh vocabulary

# Block weights whose OUTPUT dim shards on 'tp' (dense MLP only; MoE
# weights replicate — see module docstring).
_SHARDED_BLOCK_WEIGHTS = transformer.COLUMN_SHARDED

# The spec of a sharded leaf: its LAST dim is split (weights and their
# scales alike); None is replicated.
SHARD_LAST = -1


def validate(cfg, tp: int) -> None:
    """Raise ValueError unless the config admits an exact tp-way split."""
    tp = int(tp)
    if tp <= 1:
        return
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_kv_heads={cfg.n_kv_heads} "
            "(KV heads shard on 'tp')")
    if cfg.n_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads} "
            "(query heads shard on 'tp')")
    if cfg.d_ff % tp:
        raise ValueError(
            f"tp={tp} must divide d_ff={cfg.d_ff} "
            "(the SwiGLU hidden shards on 'tp')")


def mesh_tp(mesh) -> int:
    """Size of the mesh's 'tp' axis (1 when absent/None)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(TP_AXIS, 1))


# -- shard tables ------------------------------------------------------------


def _block_spec(name: str, moe: bool) -> Optional[int]:
    """Spec of one block leaf. Quantization scales (``<w>_scale``, the
    weight's shape with the contraction dim collapsed to 1) shard exactly
    like their weight: the sharded dim is the LAST dim for both."""
    base = name[:-6] if name.endswith("_scale") else name
    if not moe and base in _SHARDED_BLOCK_WEIGHTS:
        return SHARD_LAST
    return None


def _leaves(module: torch.nn.Module):
    """(name, tensor) of every parameter and non-None buffer, in
    registration order (no recursion)."""
    for name, t in module.named_parameters(recurse=False):
        yield name, t
    for name, t in module.named_buffers(recurse=False):
        if t is not None:
            yield name, t


def param_pspecs(cfg, params: transformer.Transformer) -> Dict[str, Any]:
    """The exact-TP table in JAX's tree layout: every top-level leaf
    (embed, final_norm, lm_head and their scales) -> None (replicated);
    ``"blocks"`` -> {leaf name: SHARD_LAST or None}, the same for every
    layer (the JAX stack's one spec per name)."""
    moe = bool(getattr(cfg, "n_experts", 0))
    out: Dict[str, Any] = {name: None for name, _ in _leaves(params)}
    out["blocks"] = {name: _block_spec(name, moe)
                     for name, _ in _leaves(params.blocks[0])}
    return out


def state_leaf_spec(leaf) -> Optional[int]:
    """Spec of one engine-state leaf, by rank: 5D KV slabs / pools
    [L, B|NB, Hkv, T|block, Dh] and their 4D int8 scale twins
    [L, B|NB, Hkv, T|block] shard Hkv (axis 2); everything else (the
    [B] per-slot scalars) replicates."""
    return 2 if leaf.dim() in (4, 5) else None


def _state_map(fn, state):
    if isinstance(state, dict):
        return {k: _state_map(fn, v) for k, v in state.items()}
    return fn(state)


def _part(x: torch.Tensor, dim: int, rank: int, tp: int) -> torch.Tensor:
    """A copy of rank ``rank``'s contiguous part of ``x`` on ``dim``. A
    part that is dense in memory keeps the source's strides (the
    column-major int8 projections of ``quantize.set_quantized`` stay
    column-major); any other part is made contiguous."""
    n = x.shape[dim]
    if n % tp:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"{tp} ways")
    w = n // tp
    return x.narrow(dim, rank * w, w).clone(
        memory_format=torch.preserve_format)


def build_shard(cfg, leaf_fn) -> transformer.Transformer:
    """A Transformer built on the meta device (nothing allocated) whose
    leaf ``name`` at ``path`` is ``leaf_fn(path, name, spec)``: top-level
    leaves have path ``()`` and spec None, block leaves ``(i,)`` and their
    table spec. A scale buffer exists only where ``leaf_fn`` returns a
    tensor for it."""
    from seldon_tpu_torch.parallel.sharding import build_tree

    moe = bool(cfg.n_experts)
    return build_tree(cfg, range(cfg.n_layers), lambda path, name: leaf_fn(
        path, name, _block_spec(name, moe) if path else None))


def leaf_spec(cfg, path, name: str) -> Optional[int]:
    """The spec of leaf ``name`` at ``path`` (``()`` or ``(layer,)``)."""
    return _block_spec(name, bool(cfg.n_experts)) if path else None


def leaf_of(params: transformer.Transformer, path, name: str):
    """The leaf ``name`` at ``path`` (``()`` or ``(layer,)``), or None."""
    mod = params if not path else params.blocks[path[0]]
    return getattr(mod, name, None)


def shard_params(group, cfg, params: transformer.Transformer
                 ) -> transformer.Transformer:
    """This rank's weights under the exact-TP table: sharded leaves cut
    to the rank's contiguous part of their last dim (a copy of the part),
    replicated leaves the caller's own tensors (no copy)."""
    tp, rank = int(group.world), int(group.rank)
    validate(cfg, tp)

    def leaf(path, name, spec):
        t = leaf_of(params, path, name)
        if t is None:
            return None
        return t.detach() if spec is None else _part(t.detach(), t.dim() - 1,
                                                    rank, tp)

    return build_shard(params.cfg, leaf)


def leaf_dtypes(cfg) -> Dict[tuple, torch.dtype]:
    """(path, name) -> the dtype of every parameter of an unquantized
    model of ``cfg`` (read from a model on the meta device)."""
    meta = transformer.Transformer(cfg, "meta")
    out = {((), name): t.dtype for name, t in _leaves(meta)}
    for i, bp in enumerate(meta.blocks):
        out.update({((i,), name): t.dtype for name, t in _leaves(bp)})
    return out


@torch.no_grad()
def init_shard(cfg, generator: torch.Generator, device, rank: int,
               tp: int) -> transformer.Transformer:
    """Rank ``rank``'s exact-TP shard of ``transformer.init_params(cfg,
    generator, device)``, bit for bit, without the whole model: every
    rank replays the same draws in the same order
    (``transformer.draw_leaves``) and keeps its part of each, so no rank
    holds more than its shard and one leaf's f32 draw."""
    validate(cfg, tp)
    cfg = transformer.check_supported(cfg)
    dtypes = leaf_dtypes(cfg)
    held: Dict[tuple, torch.Tensor] = {}

    def keep(path, name, w):
        if leaf_spec(cfg, path, name) is not None and tp > 1:
            n = w.shape[-1] // tp
            w = w.narrow(w.dim() - 1, rank * n, n)
        held[(path, name)] = torch.empty(
            w.shape, dtype=dtypes[(path, name)], device=w.device).copy_(w)

    transformer.draw_leaves(cfg, generator, device, keep)
    return build_shard(cfg, lambda path, name, spec: held.get((path, name)))


def shard_state(group, state) -> Any:
    """This rank's part of a full engine-state tree: KV leaves cut on
    their Hkv axis (a copy), per-slot scalars as given."""
    tp, rank = int(group.world), int(group.rank)

    def cut(leaf):
        spec = state_leaf_spec(leaf)
        return leaf if spec is None else _part(leaf, spec, rank, tp)

    return _state_map(cut, state)


# -- the four verbs ----------------------------------------------------------


@dataclass(frozen=True)
class TpHints:
    """The exact-TP helper threaded through the transformer's serving
    paths (``tp=`` kwarg), bound to this rank's group.

    ``heads``/``flat`` keep the sharded two-thirds of each block on the
    rank's shard (a full-width input, as MoE's replicated projections
    give, is cut to the rank's part; any other width raises), ``gather``
    is the exact all-gather in front of the replicated wo / w_down
    contractions, and ``constrain_state`` checks that every state leaf
    still has its shard shape at the end of a family."""

    group: Any
    tp: int

    @property
    def rank(self) -> int:
        return int(self.group.rank)

    def n_heads(self, cfg) -> int:
        return cfg.n_heads // self.tp

    def n_kv_heads(self, cfg) -> int:
        return cfg.n_kv_heads // self.tp

    def _local(self, x: torch.Tensor, dim: int, local: int) -> torch.Tensor:
        n = x.shape[dim]
        if n == local:
            return x
        if n == local * self.tp:
            return _part(x, dim, self.rank, self.tp)
        raise ValueError(
            f"tp={self.tp}: dim {dim} of {tuple(x.shape)} is neither the "
            f"rank's shard ({local}) nor the full width ({local * self.tp})")

    def heads(self, x: torch.Tensor, cfg) -> torch.Tensor:
        """[B, S, H|Hkv, Dh] on the rank's heads (H or Hkv by width)."""
        full = x.shape[2]
        local = (self.n_heads(cfg) if full in (cfg.n_heads,
                                               self.n_heads(cfg))
                 else self.n_kv_heads(cfg))
        return self._local(x, 2, local)

    def flat(self, x: torch.Tensor, width: int) -> torch.Tensor:
        """[..., F] (head-major flattened heads or the hidden) on the
        rank's contiguous part of the full width ``width``."""
        return self._local(x, x.dim() - 1, width // self.tp)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """Exact all-gather on the last axis, in rank order."""
        return self.group.all_gather_last(x)

    def pad_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` with this rank's heads on ``dim`` set at their place among
        zeros for the group's other heads. An attention product batched
        over heads then runs at tp = 1's batch count: on the card cuBLAS
        picks an f32 batched GEMM's algorithm by its batch count too, and
        a rank's share of the heads would be reduced in another order
        (ROADMAP.md C18)."""
        n = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = n * self.tp
        out = x.new_zeros(shape)
        out.narrow(dim, self.rank * n, n).copy_(x)
        return out

    def own_heads(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's contiguous part of ``dim`` of a padded result."""
        n = x.shape[dim] // self.tp
        return x.narrow(dim, self.rank * n, n).contiguous()

    def constrain_state(self, state, cfg):
        """Check every state leaf's shard shape: KV leaves carry
        n_kv_heads / tp heads on axis 2. Returns ``state``."""
        local = self.n_kv_heads(cfg)

        def check(leaf):
            if state_leaf_spec(leaf) is not None and leaf.shape[2] != local:
                raise ValueError(
                    f"state leaf {tuple(leaf.shape)} is not this rank's "
                    f"shard ({local} KV heads)")
            return leaf

        _state_map(check, state)
        return state


def hints(group, tp: int) -> Optional[TpHints]:
    """TpHints iff tp > 1 (the EngineConfig.tp gate); None otherwise —
    callers keep a None attribute and the unthreaded path, so tp=1 stays
    byte-identical to a build without tensor parallelism."""
    tp = int(tp)
    if tp <= 1:
        return None
    if group is None:
        raise ValueError("EngineConfig.tp > 1 requires a mesh with a "
                         "'tp' axis: a rank group "
                         "(servers/mesh_engine.build_tp_mesh)")
    have = int(group.world)
    if have != tp:
        raise ValueError(
            f"EngineConfig.tp={tp} but the mesh carries a {have}-way "
            f"'{TP_AXIS}' axis")
    return TpHints(group=group, tp=tp)
