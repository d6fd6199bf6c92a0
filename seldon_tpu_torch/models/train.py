"""The sharded training step — port of ``seldon_tpu/models/train.py``.

Next-token cross-entropy (+ the MoE router's load-balance aux) with
optax's AdamW arithmetic, on one process per rank of a mesh: the
parameters, gradients and optimizer state sharded by JAX's training
tables (``parallel/sharding.param_pspecs``, or
``parallel/pipeline.pp_param_pspecs`` when the mesh has a pp axis: the
GPipe schedule), every block rematerialized in the backward.

Every rank calls the step with the same GLOBAL batch and cuts its own
block: its dp rows and, with ``seq_sharded``, its sp block of the
sequence. The loss is summed over dp x sp x pp (each rank's part is
its rows' masked NLL over the global mask count, plus its share of the
aux); over tp and ep every rank holds the same loss (Megatron's f/g
inside ``transformer``'s training route). So after the backward every
leaf's gradient is summed over the dp and sp ranks, and over pp for the
leaves the stages replicate (the embedding's gradient forms on stage 0,
the final norm's and the head's on the last): replicas then hold equal
gradients and take equal steps. ``init_fn(seed)`` builds the rank's
shard leaf by leaf (a whole leaf exists only transiently), so no rank
holds the whole tree.

The optimizer is optax's ``chain(clip_by_global_norm(1.0), adamw(
warmup_cosine_decay_schedule(...), b1=0.9, b2=0.95, weight_decay,
mask=_decay_mask))`` written out (:class:`AdamW`), updated leaf by leaf:
 * the schedule is taken at the count BEFORE it is incremented (the
   first update has lr 0); the bias corrections use the incremented
   count;
 * the decay is added to masked leaves only, and is scaled by the
   schedule with the rest of the update;
 * ``mu`` and ``nu`` are held in the parameter's dtype (optax's
   ``mu_dtype=None``);
 * the constants of a leaf's arithmetic are rounded to its dtype, as a
   Python scalar takes the dtype of the array it meets in ``jnp``, and
   every operation of a bf16 leaf's chain is computed in f32 and rounded
   to bf16: that is how XLA on the CPU computes optax's bf16 update
   (bit-equal over several updates; keeping f32 through the chain
   instead lands 1 to 3 bf16 ulps away);
 * an f32 leaf's chain is computed as XLA on the CPU compiles optax's
   jitted f32 update: each ``a * b + c`` one fused multiply-add (exact,
   on every device: :func:`_fma`), ``mu / bc1 / (sqrt(nu / bc2) + eps)``
   one division, the schedule's divisions by constants products with
   their reciprocals (bit-equal on the same gradients and norm; from
   count 4 on, ``b ** count`` may differ by one f32 ulp, XLA's f32 power
   not being correctly rounded).

A float32 model trains in every layout, its parameters, gradients and
moments in f32.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from seldon_tpu_torch.device import DeviceLike
from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.quantize import true_div
from seldon_tpu_torch.parallel import sharding as shd
from seldon_tpu_torch.parallel.distributed import MeshRanks
from seldon_tpu_torch.parallel.mesh import AXES

Key = Tuple[tuple, str]  # (path, name) of a leaf: () or (layer,)

# Elements of a leaf updated at a time: bounds the f32 temporaries of the
# update (a whole 8B embedding in f32 is 2.1 GB per temporary).
_CHUNK = 1 << 24


class TrainState(NamedTuple):
    step: int
    params: transformer.Transformer
    opt_state: "AdamWState"


@dataclasses.dataclass
class AdamWState:
    """optax's state: ``count`` (scale_by_adam's and the schedule's, equal
    after every update) and the moments, each a tree shaped like the
    parameters (the rank's shard)."""

    count: int
    mu: transformer.Transformer
    nu: transformer.Transformer


def _jax_ndim(path: tuple, t: torch.Tensor) -> int:
    """ndim of the JAX leaf (block leaves stack the layer axis)."""
    return t.dim() + (1 if path else 0)


def _decay_mask(params: transformer.Transformer) -> Dict[Key, bool]:
    """Decay matrices only — norm gains are [L, D] in JAX's layer-stacked
    layout, so an ndim test would wrongly decay them; go by name."""
    return {(path, name): _jax_ndim(path, t) >= 2 and "norm" not in name
            for path, name, t in shd.leaves(params)}


def _jax_leaf(key: Key) -> str:
    """The JAX tree path of a leaf: ``blocks/<name>`` or ``<name>``."""
    path, name = key
    return f"blocks/{name}" if path else name


def _leaf_order(cfg: ModelConfig) -> Tuple[str, ...]:
    """JAX's leaf order of the params tree (sorted dict keys)."""
    blocks = ["attn_norm", "mlp_norm", "w_down", "w_gate", "w_up", "wk",
              "wo", "wq", "wv"] + (["router"] if cfg.n_experts else [])
    top = ["embed", "final_norm"] + ([] if cfg.tie_embeddings
                                     else ["lm_head"])
    return tuple(sorted(f"blocks/{n}" for n in blocks)) + tuple(sorted(top))


def _rounded(v: float, dtype: torch.dtype) -> float:
    """A Python scalar as ``jnp`` sees it beside an array of ``dtype``."""
    return torch.tensor(float(v), dtype=dtype).item()


def _fma32(a, b, c) -> np.float32:
    """``a * b + c`` of f32 numbers rounded once (:func:`_fma`)."""
    def t(v):
        return torch.tensor(np.float32(v))

    return np.float32(_fma(t(a), t(b), t(c)).item())


def _chunks(t: torch.Tensor):
    flat = t.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        yield flat[i:i + _CHUNK]


class AdamW:
    """optax's ``make_optimizer`` chain written out (module docstring).
    ``schedule(count)`` is the learning rate at an update count, an f32
    number computed as ``warmup_cosine_decay_schedule`` computes it."""

    def __init__(self, lr: float = 3e-4, weight_decay: float = 0.1,
                 warmup: int = 100, total_steps: int = 10000,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 max_norm: float = 1.0):
        self.lr, self.weight_decay = lr, weight_decay
        self.warmup = int(warmup)
        self.decay_steps = max(int(total_steps), self.warmup + 1)
        self.end_value = lr * 0.1
        self.b1, self.b2, self.eps, self.max_norm = b1, b2, eps, max_norm

    def schedule(self, count: int) -> np.float32:
        """The rate as XLA on the CPU computes the jitted schedule: each
        division by a constant is a product with its f32 reciprocal and
        each ``a * b + c`` one fused multiply-add."""
        f = np.float32
        c = np.int32(count)
        if self.warmup > 0 and c < self.warmup:
            # optax.linear_schedule(0, lr, warmup)
            frac = _fma32(-f(np.clip(c, 0, self.warmup)),
                          f(f(1) / f(self.warmup)), f(1))
            return _fma32(frac, f(0.0 - self.lr), f(self.lr))
        # optax.cosine_decay_schedule(lr, decay_steps - warmup, alpha)
        alpha = 0.0 if self.lr == 0.0 else self.end_value / self.lr
        span = f(self.decay_steps - self.warmup)
        t = np.minimum(f(c - np.int32(self.warmup)), span)
        # cos of the f32 angle, rounded once from f64 (as XLA's cos is).
        cos = f(np.cos(np.float64(t * f(f(np.pi) * (f(1) / span)))))
        decayed = _fma32(cos + f(1), f(0.5) * f(1 - alpha), f(alpha))
        return f(self.lr) * decayed

    def init(self, params: transformer.Transformer) -> AdamWState:
        def zeros():
            return shd.build_tree(params.cfg, _layers(params), lambda p, n: (
                torch.zeros_like(leaf_at(params, p, n))
                if leaf_at(params, p, n) is not None else None))
        return AdamWState(0, zeros(), zeros())

    @torch.no_grad()
    def update(self, params: transformer.Transformer,
               grads: Dict[Key, torch.Tensor], state: AdamWState,
               grad_norm: torch.Tensor) -> AdamWState:
        """One update of every leaf IN PLACE from ``grads`` and the global
        gradient norm (clipped to ``max_norm`` first); returns ``state``
        with its count incremented."""
        f = np.float32
        count = state.count + 1
        step = -self.schedule(state.count)
        bc1 = f(1) - np.power(f(self.b1), f(count))
        bc2 = f(1) - np.power(f(self.b2), f(count))
        clip = grad_norm >= self.max_norm
        decay = _decay_mask(params)
        mus = {(p, n): t for p, n, t in shd.leaves(state.mu)}
        nus = {(p, n): t for p, n, t in shd.leaves(state.nu)}
        for path, name, p in shd.leaves(params):
            key = (path, name)
            dt = p.dtype
            c = {k: _rounded(v, dt) for k, v in (
                ("1-b1", 1 - self.b1), ("b1", self.b1), ("1-b2", 1 - self.b2),
                ("b2", self.b2), ("bc1", bc1), ("bc2", bc2),
                ("eps", self.eps), ("wd", self.weight_decay),
                ("step", step), ("max", self.max_norm))}
            norm = grad_norm.to(dt).float()
            for pc, gc, mc, nc in zip(_chunks(p), _chunks(grads[key]),
                                      _chunks(mus[key]), _chunks(nus[key])):
                _adamw_chunk(pc, gc, mc, nc, c, norm, clip, decay[key])
        state.count = count
        return state


def _fma(a, b: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``a * b + x`` of f32 operands rounded once to f32, as a fused
    multiply-add on every device: the product is exact in f64, the sum is
    rounded to odd in f64 (its error from TwoSum), and that rounds to f32
    as the exact value does."""
    prod = b.double() * (a.double() if torch.is_tensor(a) else a)
    x = x.double()
    s = prod + x
    t = s - prod
    err = (prod - (s - t)) + (x - t)
    even = (s.view(torch.int64) & 1) == 0
    away = torch.where(err > 0, torch.full_like(s, float("inf")),
                       torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, away), s)
    return s.float()


def _adamw_chunk(p, g, mu, nu, c, norm, clip, decay: bool) -> None:
    """optax's update of one chunk of a leaf, in place, as XLA on the CPU
    computes optax's jitted update: on a bf16 leaf every operation
    computed in f32 and rounded to bf16; on an f32 leaf each ``a * b + x``
    of the chain is one fused multiply-add, as XLA contracts it
    (bit-equal to optax's jitted update on the same gradients and norm,
    in either dtype). The bias
    corrections divide as one IEEE division on every device
    (``quantize.true_div``)."""
    dt = p.dtype

    def r(t):
        return t if dt == torch.float32 else t.to(dt).float()

    def madd(a, b, x):  # a * b + x, x rounded to the leaf's dtype
        return _fma(a, b, x) if dt == torch.float32 else r(r(a * b) + x)

    g = g.float()
    g = torch.where(clip, r(r(g / norm) * c["max"]), g)
    m = madd(c["1-b1"], g, r(c["b1"] * mu.float()))
    v = madd(c["b2"], nu.float(), r(c["1-b2"] * r(g * g)))
    if dt == torch.float32:
        # XLA folds m / bc1 / (sqrt(v / bc2) + eps) into one division.
        # The square root is taken in f64 and rounded: PyTorch's f32
        # sqrt on the CPU is not always the correctly rounded one.
        root = torch.sqrt(true_div(v, c["bc2"]).double()).float()
        u = m / (c["bc1"] * (root + c["eps"]))
    else:
        u = r(r(true_div(m, c["bc1"]))
              / r(r(torch.sqrt(r(true_div(v, c["bc2"])))) + c["eps"]))
    if decay:
        u = madd(c["wd"], p.float(), u)
    p.copy_(madd(c["step"], u, p.float()))
    mu.copy_(m)
    nu.copy_(v)


def make_optimizer(lr: float = 3e-4, weight_decay: float = 0.1,
                   warmup: int = 100, total_steps: int = 10000) -> AdamW:
    return AdamW(lr, weight_decay, warmup, total_steps)


def leaf_at(model: transformer.Transformer, path: tuple, name: str):
    """Leaf ``name`` at ``path`` (``()`` or ``(layer,)``, the layer's
    index in the whole model), or None."""
    if not path:
        return getattr(model, name, None)
    layers = _layers(model)
    if path[0] not in layers:
        return None
    return getattr(model.blocks[layers.index(path[0])], name, None)


def _layers(model) -> Tuple[int, ...]:
    return tuple(getattr(model, "layers", range(len(model.blocks))))


MOE_AUX_WEIGHT = 0.01


def _nll_sum(logits: torch.Tensor, targets: torch.Tensor,
             mask: torch.Tensor) -> torch.Tensor:
    """sum(nll * mask) of f32 logits [b, t, V] against targets [b, t]."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    nll = -lp.gather(-1, targets.long()[..., None])[..., 0]
    return (nll * mask).sum()


def _denominator(loss_mask: torch.Tensor) -> torch.Tensor:
    """max(sum of the GLOBAL mask over the positions with a target, 1)."""
    return torch.clamp(loss_mask[:, 1:].float().sum(), min=1.0)


def _head_part(logits, tokens, loss_mask, rows, lo, denom):
    """Rows ``rows``' part of the CE: the positions of the block starting
    at ``lo`` that have a target (an sp block's last position targets the
    next block's first token; the sequence's last position none)."""
    S = tokens.shape[1]
    n = min(logits.shape[1], S - 1 - lo)
    tgt = slice(lo + 1, lo + 1 + n)
    return _nll_sum(logits[:, :n], tokens[rows, tgt],
                    loss_mask[rows, tgt].float()) / denom


def _dp_rows(B: int, hints) -> torch.Tensor:
    dp, d = hints.ranks.size("dp"), hints.ranks.coord["dp"]
    if B % dp:
        raise ValueError(f"batch {B} does not split over dp={dp}")
    w = B // dp
    return torch.arange(d * w, (d + 1) * w)


def loss_fn(params: transformer.Transformer, tokens: torch.Tensor,
            loss_mask: torch.Tensor, cfg: ModelConfig,
            hints=None) -> torch.Tensor:
    """Next-token CE (+ MOE_AUX_WEIGHT x the router's load-balance aux for
    MoE configs) of the GLOBAL batch ``tokens`` [B, S] with ``loss_mask``
    [B, S] (0 on pad/prompt): the mean of the NLL over the global mask,
    ``sum(nll * mask) / max(sum(mask), 1)``. Returns THIS rank's part (its
    dp rows and, under sp, its block of the sequence; the aux's
    1 / (dp x sp) share): the sum over dp x sp is the loss, and on one
    rank (``hints`` None) it is the loss."""
    if hints is None:
        hints = transformer.single_hints(tokens.device)
    B, S = tokens.shape
    rows = _dp_rows(B, hints).to(tokens.device)
    lo, s = hints.seq_block(S)
    logits, aux = transformer.forward_train(
        params, tokens[rows, lo:lo + s], cfg, hints)
    ce = _head_part(logits, tokens, loss_mask, rows, lo,
                    _denominator(loss_mask))
    if cfg.n_experts:
        ce = ce + MOE_AUX_WEIGHT * true_div(aux["moe_lb_loss"],
                                            hints.stats.world)
    return ce


def _spec_axes(spec) -> set:
    return {a for part in spec if part is not None
            for a in ((part,) if isinstance(part, str) else part)}


def _check_divisible(cfg: ModelConfig, mesh) -> None:
    tp, ep = int(mesh.shape["tp"]), int(mesh.shape["ep"])
    for what, n, k in (("n_heads", cfg.n_heads, tp),
                       ("n_kv_heads", cfg.n_kv_heads, tp),
                       ("d_ff", cfg.d_ff, tp),
                       ("vocab_size", cfg.vocab_size, tp),
                       ("n_experts", cfg.n_experts, ep)):
        if n % k:
            raise ValueError(f"{what}={n} does not split over {k} ranks")
    if ep > 1 and not cfg.n_experts:
        raise ValueError("ep > 1 needs an MoE config")


def _init_leaf(cfg: ModelConfig, path: tuple, name: str,
               like: torch.Tensor, gen: torch.Generator,
               device: torch.device) -> torch.Tensor:
    """A whole leaf of the JAX package's init on ``device``: norms at 1,
    weights normal x 0.02 (the residual projections x 0.02 / sqrt(2L))
    rounded to bf16, the router drawn the same way and held in f32."""
    if "norm" in name:
        return torch.ones(like.shape, dtype=like.dtype, device=device)
    scale = 0.02 / (2 * cfg.n_layers) ** 0.5 if name in ("wo", "w_down") \
        else 0.02
    w = torch.randn(like.shape, generator=gen, device=device,
                    dtype=torch.float32) * scale
    return w.to(transformer._dtype(cfg)).to(like.dtype)


def init_shard(cfg: ModelConfig, specs, ranks: MeshRanks,
               seed: int) -> transformer.Transformer:
    """The rank's shard of a seeded init, leaf by leaf: each whole leaf is
    drawn (from a generator seeded by ``seed`` and the leaf's index in
    the model) on the rank's device, cut, and dropped, so every layout
    on one kind of device starts from the same weights."""
    dev = ranks.device
    sizes, coord = ranks.sizes, ranks.coord
    full = transformer.Transformer(cfg, "meta")
    index = {(p, n): i for i, (p, n, _) in enumerate(shd.leaves(full))}
    first = next(iter(specs["blocks"].values()))[0]
    layers = shd.layers_of(cfg, first, coord, sizes)

    def leaf(path, name):
        like = leaf_at(full, path, name)
        if like is None:
            return None
        gen = torch.Generator(dev).manual_seed(
            seed * 1_000_003 + index[(path, name)])
        whole = _init_leaf(cfg, path, name, like, gen, dev)
        spec = shd.leaf_spec(specs, path, name)
        return shd.cut(whole, spec[1:] if path else spec, coord, sizes)

    return shd.build_tree(cfg, layers, leaf)


def _trainable(params) -> None:
    for _, _, t in shd.leaves(params):
        if t.dtype == torch.int8:
            raise ValueError("int8 weights are not trained: train the bf16 "
                             "model and quantize it for serving")
        t.requires_grad_(True)


def _sq_sum(t: torch.Tensor) -> torch.Tensor:
    acc = torch.zeros((), dtype=torch.float32, device=t.device)
    for c in _chunks(t):
        c = c.float()
        acc = acc + (c * c).sum()
    return acc


def reduce_grads(params: transformer.Transformer, specs,
                 ranks: MeshRanks) -> Dict[Key, torch.Tensor]:
    """Every leaf's gradient (its ``.grad``, then cleared) summed over the
    dp and sp ranks, and over pp where the leaf is not cut by stage."""
    grads = {}
    for path, name, p in shd.leaves(params):
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        spec = shd.leaf_spec(specs, path, name)
        axes = [a for a in ("dp", "pp", "sp") if a not in _spec_axes(spec)]
        grads[(path, name)] = ranks.group(*axes).all_reduce(g)
        p.grad = None
    return grads


def global_norm(grads: Dict[Key, torch.Tensor], specs, ranks: MeshRanks,
                cfg: ModelConfig) -> torch.Tensor:
    """optax.global_norm of the whole gradient tree: each JAX leaf's sum
    of squares (f32) rounded to its dtype, summed in f32 in JAX's leaf
    order. A rank adds a leaf's part only at coordinate 0 of every axis
    the leaf is replicated over; one f32 sum over the world follows, so
    every rank gets the same bits."""
    order = _leaf_order(cfg)
    part = torch.zeros(len(order), dtype=torch.float32, device=ranks.device)
    dtypes = {}
    for key, g in grads.items():
        sharded = _spec_axes(shd.leaf_spec(specs, *key))
        j = order.index(_jax_leaf(key))
        dtypes[j] = g.dtype
        if all(ranks.coord[a] == 0 for a in AXES if a not in sharded):
            part[j] += _sq_sum(g)
    part = ranks.world.all_reduce(part)
    acc = torch.zeros((), dtype=torch.float32, device=ranks.device)
    for j in range(len(order)):
        acc = acc + part[j].to(dtypes[j]).float()
    return torch.sqrt(acc)


def make_sharded_train_step(mesh, cfg: ModelConfig, optimizer: AdamW,
                            seq_sharded: bool = True,
                            n_microbatches: int = 4,
                            ranks: Optional[MeshRanks] = None,
                            device: DeviceLike = None):
    """Returns (init_fn, step_fn) for THIS rank of ``mesh``.

    init_fn(seed) -> TrainState, the rank's shard.
    step_fn(state, tokens, loss_mask, grads_out=None) -> (state, {"loss",
    "grad_norm"}): ``tokens`` / ``loss_mask`` [B, S] are the global batch
    (numpy or host tensors) on every rank; the state is updated in place;
    the metrics are global floats, equal on every rank. A dict
    ``grads_out`` receives the rank's reduced gradients (f32 numpy by
    ``(path, name)``), as the update takes them.

    ``ranks`` is the rank's ``distributed.MeshRanks`` (every rank of the
    world builds it together); a one-device mesh needs none and runs on
    ``device`` (``cuda`` unless named). With a pp axis > 1 the layers
    run the GPipe schedule (``parallel/pipeline.py``) under its specs;
    dp/sp/tp/ep compose unchanged. ``seq_sharded`` cuts the sequence over
    sp (ring attention under ``attn_impl="ring"``, the K/V gather under
    ``"xla"``); without it sp must be 1."""
    cfg = transformer.check_supported(cfg)
    if ranks is None:
        n = int(np.prod([mesh.shape[a] for a in AXES]))
        if n != 1:
            raise ValueError(f"a mesh of {n} ranks needs this rank's "
                             f"MeshRanks (distributed.MeshRanks)")
        ranks = MeshRanks.single(mesh, device)
    _check_divisible(cfg, mesh)
    if mesh.shape["sp"] > 1 and not seq_sharded:
        raise ValueError("sp > 1 holds blocks of the sequence: pass "
                         "seq_sharded=True")
    hints = shd.MegatronHints(ranks)
    pp = int(mesh.shape["pp"])
    pipe = None
    if pp > 1:
        from seldon_tpu_torch.parallel import pipeline

        pipe = pipeline.make_pipeline_forward(mesh, cfg, n_microbatches,
                                              remat=True)
        specs = pipeline.pp_param_pspecs(cfg)
    else:
        specs = shd.param_pspecs(cfg)
    dev = ranks.device

    def init_fn(seed: int) -> TrainState:
        params = init_shard(cfg, specs, ranks, seed)
        _trainable(params)
        return TrainState(0, params, optimizer.init(params))

    def step_fn(state: TrainState, tokens, loss_mask, grads_out=None):
        tok = torch.as_tensor(np.asarray(tokens)).to(dev)
        mask = torch.as_tensor(np.asarray(loss_mask, np.float32)).to(dev)
        params = state.params
        if pipe is None:
            part = loss_fn(params, tok, mask, cfg, hints)
            part.backward()
            part = part.detach()
        else:
            lo, _ = hints.seq_block(tok.shape[1])
            denom = _denominator(mask)

            def head_loss(logits, rows):
                return _head_part(logits, tok, mask, rows.to(dev), lo, denom)

            part = pipe.value_and_grad(params, tok, hints, head_loss,
                                       MOE_AUX_WEIGHT)
        grads = reduce_grads(params, specs, ranks)
        gnorm = global_norm(grads, specs, ranks, cfg)
        if grads_out is not None:
            grads_out.update({k: g.float().cpu().numpy()
                              for k, g in grads.items()})
        optimizer.update(params, grads, state.opt_state, gnorm)
        del grads
        loss = ranks.group("dp", "pp", "sp").all_reduce(part.float())
        return (TrainState(state.step + 1, params, state.opt_state),
                {"loss": float(loss), "grad_norm": float(gnorm)})

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# Carrying JAX's state across
# ---------------------------------------------------------------------------


def state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                     device: DeviceLike = None,
                     ranks: Optional[MeshRanks] = None,
                     specs=None) -> TrainState:
    """A JAX ``TrainState`` as the port's: ``tree`` holds ``step`` and
    optax's ``count`` (ints), and ``params``, ``mu`` and ``nu``, each the
    params pytree with numpy leaves (``jax.tree.map(np.asarray, ...)``),
    keyed by their tree paths (``blocks/<name>`` stacked on the layer
    axis). With ``ranks`` (and the specs of the step: ``param_pspecs``,
    or ``pp_param_pspecs`` under pp) each tree is cut to the rank's
    shard. The moments' bf16 leaves cross bit for bit, as the
    parameters' do (``convert.params_from_numpy``)."""
    from seldon_tpu_torch.models import convert

    def tree_of(t) -> transformer.Transformer:
        whole = convert.params_from_numpy(t, cfg, device="cpu")
        if ranks is not None:
            whole = shd.shard_tree(whole, specs or shd.param_pspecs(cfg),
                                   ranks.mesh, ranks.coord)
        dev = ranks.device if ranks is not None else device
        return shd.build_tree(cfg, _layers(whole), lambda p, n: (
            None if leaf_at(whole, p, n) is None
            else leaf_at(whole, p, n).detach().to(dev).clone()))

    params = tree_of(tree["params"])
    _trainable(params)
    state = AdamWState(int(tree["count"]), tree_of(tree["mu"]),
                       tree_of(tree["nu"]))
    return TrainState(int(tree["step"]), params, state)


def numpy_tree(model: transformer.Transformer) -> Dict[str, Any]:
    """A whole ``Transformer`` as the JAX params pytree in numpy (block
    leaves stacked on the layer axis, bf16 as its uint16 bits): what
    :func:`state_from_numpy` takes."""
    out: Dict[str, Any] = {"blocks": {}}
    for path, name, t in shd.leaves(model):
        t = t.detach().cpu()
        a = (t.view(torch.int16).numpy().view(np.uint16)
             if t.dtype == torch.bfloat16 else t.numpy())
        if path:
            out["blocks"].setdefault(name, []).append(a)
        else:
            out[name] = a
    out["blocks"] = {k: np.stack(v) for k, v in out["blocks"].items()}
    return out


def state_tree(state: TrainState) -> Dict[str, Any]:
    """A whole (one-rank) state as :func:`state_from_numpy` takes it."""
    return {"step": state.step, "count": state.opt_state.count,
            "params": numpy_tree(state.params),
            "mu": numpy_tree(state.opt_state.mu),
            "nu": numpy_tree(state.opt_state.nu)}


def state_to_numpy(state: TrainState) -> Dict[str, Any]:
    """The rank's state as numpy: ``{"step", "count", "params", "mu",
    "nu"}``, each tree keyed ``(path, name)`` (bf16 as its int16 bit
    pattern)."""
    def tree(m):
        return {(p, n): (t.detach().cpu().view(torch.int16).numpy()
                         if t.dtype == torch.bfloat16
                         else t.detach().cpu().numpy())
                for p, n, t in shd.leaves(m)}

    return {"step": state.step, "count": state.opt_state.count,
            "params": tree(state.params), "mu": tree(state.opt_state.mu),
            "nu": tree(state.opt_state.nu)}


def spmd_steps(ctx, plan: Dict[str, int], cfg: ModelConfig,
               tree: Dict[str, Any], tokens: np.ndarray,
               loss_mask: np.ndarray, n_steps: int,
               optimizer: Dict[str, Any], seq_sharded: bool = True,
               n_microbatches: int = 4) -> Dict[str, Any]:
    """The steps of one layout on every rank of a spawned group (run it
    with ``servers/mesh_engine.MeshGroup.spmd``; ``ctx.ranks`` is the
    world): the mesh ``MeshPlan(**plan)`` over the group's devices, the
    numpy state ``tree`` (:func:`state_from_numpy`'s) cut to the rank,
    ``n_steps`` steps of ``make_optimizer(**optimizer)`` on the global
    batch. Returns the rank's ``coord``, ``losses``, ``grad_norms``, the
    first step's reduced ``grads`` (f32, before the update) and the final
    state (:func:`state_to_numpy`)."""
    from seldon_tpu_torch.parallel import mesh as pmesh
    from seldon_tpu_torch.parallel import pipeline

    world = ctx.ranks
    mesh = pmesh.make_mesh(pmesh.MeshPlan(**plan), world.devices)
    ranks = MeshRanks(mesh, world)
    specs = (pipeline.pp_param_pspecs(cfg) if plan.get("pp", 1) > 1
             else shd.param_pspecs(cfg))
    opt = make_optimizer(**optimizer)
    _, step_fn = make_sharded_train_step(mesh, cfg, opt, seq_sharded,
                                         n_microbatches, ranks=ranks)
    state = state_from_numpy(tree, cfg, ranks=ranks, specs=specs)
    losses, norms, grads = [], [], {}
    for i in range(n_steps):
        state, m = step_fn(state, tokens, loss_mask,
                           grads if i == 0 else None)
        losses.append(m["loss"])
        norms.append(m["grad_norm"])
    return dict(state_to_numpy(state), coord=ranks.coord, losses=losses,
                grad_norms=norms, grads=grads)
