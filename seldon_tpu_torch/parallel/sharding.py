"""The TRAINING sharding tables (Megatron) and each rank's cut of a
tree — port of ``seldon_tpu/parallel/sharding.py``.

Megatron-style tensor parallelism expressed as partition specs:
attention heads and the FFN hidden dim shard over 'tp' (column-parallel
in, row-parallel out: one sum over tp per half-block), the vocabulary
shards over 'tp' for ``embed`` / ``lm_head``, the batch over 'dp', the
sequence over 'sp' and MoE experts over 'ep'. Pipeline stages ('pp')
shard the layer axis (``parallel/pipeline.pp_param_pspecs``).

This is not the serving table. ``models/tp_sharding.py`` is exact TP:
it shards OUTPUT dims only and all-gathers in front of replicated
``wo`` / ``w_down``, so serving at tp > 1 keeps tp = 1's bits. The
training route shards contractions too (``wo`` and ``w_down`` are
row-parallel), as JAX's training step does, and sums partial products.

Specs are :class:`P`, a tuple of one entry per array dim (an axis name,
a tuple of names, or None), equal to JAX's ``PartitionSpec`` as a tuple.
Where JAX commits a tree onto a ``NamedSharding`` in one process, the
port runs one process per rank: :func:`shard_tree` returns THIS rank's
cut of every leaf of the port's ``Transformer``, by its mesh coordinate,
each sharded dim cut to the contiguous block JAX puts on the device at
that coordinate. Block leaves are one tensor per layer in the port (the
JAX ``[L, ...]`` stack sliced): the spec's first entry, the layer axis,
picks which layers the rank holds, and the rest cut each layer's tensor.

:class:`MegatronHints` carries the collectives of the training route at
one rank (Megatron's f and g over tp, the K/V gather over sp, the MoE
statistics over dp x sp, the experts over ep), the training
counterpart of the serving ``tp_sharding.TpHints``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.quantize import _BLOCK_WEIGHTS
from seldon_tpu_torch.parallel import distributed as pdist


class P(tuple):
    """A partition spec: one entry per array dim, an axis name, a tuple
    of axis names or None (unsharded)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def param_pspecs(cfg, quantized: bool = False) -> Dict[str, Any]:
    """Spec tree matching the JAX ``init_params`` tree (``blocks`` leaves
    stacked on a leading layer axis). ``quantized=True`` adds the
    ``*_scale`` specs: a scale has its weight's shape with axis -2
    reduced to 1, so its spec is the weight's with that entry unsharded."""
    blocks = {
        "attn_norm": P(None, None),
        "wq": P(None, None, "tp"),
        "wk": P(None, None, "tp"),
        "wv": P(None, None, "tp"),
        "wo": P(None, "tp", None),
        "mlp_norm": P(None, None),
    }
    if cfg.n_experts:
        blocks.update({
            "router": P(None, None, None),
            "w_gate": P(None, "ep", None, "tp"),
            "w_up": P(None, "ep", None, "tp"),
            "w_down": P(None, "ep", "tp", None),
        })
    else:
        blocks.update({
            "w_gate": P(None, None, "tp"),
            "w_up": P(None, None, "tp"),
            "w_down": P(None, "tp", None),
        })
    specs: Dict[str, Any] = {
        "embed": P("tp", None),
        "blocks": blocks,
        "final_norm": P(None),
    }
    if not cfg.tie_embeddings:
        specs["lm_head"] = P(None, "tp")
    if quantized:
        def scale_spec(spec: P) -> P:
            parts = list(spec)
            parts[-2] = None  # a reduced (size-1) axis cannot be sharded
            return P(*parts)

        for name in _BLOCK_WEIGHTS:
            if name in blocks:
                blocks[f"{name}_scale"] = scale_spec(blocks[name])
        specs["embed_scale"] = scale_spec(specs["embed"])
        if "lm_head" in specs:
            specs["lm_head_scale"] = scale_spec(specs["lm_head"])
    return specs


def cache_pspec(cfg=None) -> Dict[str, P]:
    """KV-cache specs: batch over dp, KV heads over tp, for the
    head-major leaves k/v [L, B, Hkv, T, Dh] (+ k_scale/v_scale
    [L, B, Hkv, T] for an int8 cache)."""
    kv = P(None, "dp", "tp", None, None)
    specs = {"k": kv, "v": kv}
    if cfg is not None and getattr(cfg, "kv_cache_dtype", "bf16") == "int8":
        scale = P(None, "dp", "tp", None)
        specs.update({"k_scale": scale, "v_scale": scale})
    return specs


def batch_pspec(seq_sharded: bool = False) -> P:
    """Token batch [B, S]."""
    return P("dp", "sp" if seq_sharded else None)


def activation_pspec(seq_sharded: bool = False) -> P:
    """Hidden activations [B, S, D]."""
    return P("dp", "sp" if seq_sharded else None, None)


# ---------------------------------------------------------------------------
# One rank's cut
# ---------------------------------------------------------------------------


def _axes(part) -> Tuple[str, ...]:
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def block_index(part, coord: Dict[str, int],
                sizes: Dict[str, int]) -> Tuple[int, int]:
    """(index, count) of the block a spec entry gives the rank at
    ``coord``: the entry's axes linearized with the first one major, as
    JAX orders the blocks of a dim sharded over several axes."""
    idx, n = 0, 1
    for a in _axes(part):
        idx = idx * sizes[a] + coord[a]
        n *= sizes[a]
    return idx, n


def cut(x: torch.Tensor, spec: Sequence, coord: Dict[str, int],
        sizes: Dict[str, int]) -> torch.Tensor:
    """The rank's contiguous block of ``x`` under ``spec`` (one entry per
    dim of ``x``): a copy when any dim is cut, else ``x`` itself."""
    if len(spec) != x.dim():
        raise ValueError(f"spec {spec} does not fit a {x.dim()}-d leaf")
    out = x
    for dim, part in enumerate(spec):
        idx, n = block_index(part, coord, sizes)
        if n == 1:
            continue
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"{n} ways ({part})")
        w = x.shape[dim] // n
        out = out.narrow(dim, idx * w, w)
    return out if out is x else out.contiguous().clone()


def layers_of(cfg, layer_part, coord: Dict[str, int],
              sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The layers a rank holds under a block spec's first entry."""
    idx, n = block_index(layer_part, coord, sizes)
    if cfg.n_layers % n:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by {n}")
    w = cfg.n_layers // n
    return tuple(range(idx * w, (idx + 1) * w))


def leaves(model: torch.nn.Module):
    """(path, name, tensor) of every non-None parameter and buffer of a
    ``Transformer``: top-level leaves at path ``()``, then each block's
    at ``(layer,)``, where ``layer`` is its index in the whole model."""
    held = getattr(model, "layers", range(len(model.blocks)))
    for path, mod in [((), model)] + [((i,), bp) for i, bp in
                                      zip(held, model.blocks)]:
        for name, t in mod.named_parameters(recurse=False):
            yield path, name, t
        for name, t in mod.named_buffers(recurse=False):
            if t is not None:
                yield path, name, t


def _assign(module: torch.nn.Module, name: str, t: torch.Tensor) -> None:
    module._parameters.pop(name, None)
    module._buffers.pop(name, None)
    if t.dtype == torch.int8 or name.endswith("_scale"):
        module.register_buffer(name, t)
    else:
        module.register_parameter(
            name, torch.nn.Parameter(t, requires_grad=False))


def build_tree(cfg, layers: Sequence[int],
               leaf_fn: Callable[[tuple, str], Optional[torch.Tensor]]
               ) -> transformer.Transformer:
    """A ``Transformer`` holding the blocks of ``layers`` (indices in the
    whole model, kept in its ``layers`` attribute) whose leaf ``name``
    at ``path`` is ``leaf_fn(path, name)``; built on the meta device, so
    nothing else is allocated. A leaf is absent where ``leaf_fn`` returns
    None (an untied head's scale, a dense block's router)."""
    model = transformer.Transformer(
        dataclasses.replace(cfg, n_layers=len(layers)), "meta")
    model.cfg = cfg
    model.layers = tuple(layers)
    for path, mod in [((), model)] + [((i,), bp) for i, bp in
                                      zip(layers, model.blocks)]:
        for name in list(mod._parameters) + list(mod._buffers):
            t = leaf_fn(path, name)
            if t is not None:
                _assign(mod, name, t)
            elif name in mod._parameters and mod._parameters[name] is not None:
                raise ValueError(f"no tensor for leaf {path}{name}")
    return model


def leaf_spec(specs: Dict[str, Any], path: tuple, name: str):
    """The spec of leaf ``name`` at ``path`` in a spec tree (a block
    leaf's spec keeps the layer axis first)."""
    return specs["blocks"][name] if path else specs[name]


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec tree entry bound to a mesh (JAX's ``NamedSharding``):
    :meth:`cut` is the rank's block at a coordinate."""

    mesh: Any
    spec: P

    def cut(self, x: torch.Tensor, coord: Dict[str, int]) -> torch.Tensor:
        return cut(x, self.spec, coord, dict(self.mesh.shape))


def named_shardings(mesh, pspec_tree: Any) -> Any:
    """The spec tree with every spec bound to ``mesh``."""
    if isinstance(pspec_tree, P):
        return NamedSharding(mesh, pspec_tree)
    return {k: named_shardings(mesh, v) for k, v in pspec_tree.items()}


def shard_tree(tree: transformer.Transformer, pspec_tree: Dict[str, Any],
               mesh, coord: Dict[str, int]) -> transformer.Transformer:
    """The rank at ``coord``'s cut of every leaf of ``tree`` (a whole
    ``Transformer``): its layers under the block specs' layer axis, and
    each tensor cut to its block (a copy; an uncut leaf is shared)."""
    sizes = dict(mesh.shape)
    cfg = tree.cfg
    first = next(iter(pspec_tree["blocks"].values()))[0]
    layers = layers_of(cfg, first, coord, sizes)
    src = {(p, n): t for p, n, t in leaves(tree)}

    def leaf(path, name):
        t = src.get((path, name))
        if t is None:
            return None
        spec = leaf_spec(pspec_tree, path, name)
        return cut(t.detach(), spec[1:] if path else spec, coord, sizes)

    return build_tree(cfg, layers, leaf)


# ---------------------------------------------------------------------------
# The training route's collectives at one rank
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MegatronHints:
    """The collectives of ``transformer``'s training route at one rank of
    a mesh (``ranks``, a ``distributed.MeshRanks``):
     * :meth:`f` / :meth:`g`, Megatron's pair over tp, around each
       column-parallel -> row-parallel pair (wq/wk/wv -> wo, w_gate/w_up
       -> w_down) and the vocabulary-parallel embedding and head;
     * ``sp``: the ranks holding the blocks of the sequence (the K/V
       gather of ``"xla"`` attention, or the ring);
     * ``stats``: the ranks holding equal blocks of the batch and the
       sequence (dp x sp), over which the MoE statistics are averaged;
     * ``ep`` and ``experts`` (ep x tp): the MoE expert shards.
    On one rank every group has one member and every call is the
    identity."""

    ranks: Any

    @property
    def tp(self):
        return self.ranks.group("tp")

    @property
    def sp(self):
        return self.ranks.group("sp")

    @property
    def ep(self):
        return self.ranks.group("ep")

    @property
    def stats(self):
        return self.ranks.group("dp", "sp")

    @property
    def experts(self):
        return self.ranks.group("ep", "tp")

    def f(self, x: torch.Tensor) -> torch.Tensor:
        return pdist.copy_to(x, self.tp)

    def g(self, x: torch.Tensor) -> torch.Tensor:
        return pdist.reduce_from(x, self.tp)

    def vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """The tp ranks' vocabulary shards of the logits, whole."""
        return pdist.gather_replicated(logits, self.tp, -1)

    def vocab_range(self, V: int) -> Tuple[int, int]:
        """[lo, hi) of the vocabulary this rank's embed / lm_head hold."""
        w = V // self.tp.world
        return self.tp.rank * w, (self.tp.rank + 1) * w

    def expert_range(self, E: int) -> Tuple[int, int]:
        w = E // self.ep.world
        return self.ep.rank * w, (self.ep.rank + 1) * w

    def seq_block(self, S: int) -> Tuple[int, int]:
        """(start, length) of this rank's sp block of an S-token
        sequence."""
        sp = self.sp
        if S % sp.world:
            raise ValueError(f"S={S} does not split over sp={sp.world}")
        s = S // sp.world
        return sp.rank * s, s
