"""What every rank of a spawned gloo group runs in the training tests
(``MeshGroup.spmd`` targets), and the group they share. This module
imports neither jax nor the JAX package, so the spawned ranks stay
light; the tests compare what comes back with JAX in the parent."""

import os

import numpy as np
import torch

from seldon_tpu_torch.models import train, transformer
from seldon_tpu_torch.parallel import mesh as pmesh
from seldon_tpu_torch.parallel import pipeline
from seldon_tpu_torch.parallel import sharding as shd
from seldon_tpu_torch.parallel.distributed import MeshRanks

TIMEOUT_S = 60.0


class Groups:
    """One spawned CPU group at a time, reused by world size (spawning
    costs seconds; a group left open holds its processes). Every group
    has a timeout, so a hung rank fails its test instead of the suite."""

    def __init__(self):
        self.group = None

    def get(self, n: int):
        from seldon_tpu_torch.servers import mesh_engine

        if self.group is not None and self.group.world != n:
            self.close()
        if self.group is None:
            # Single-threaded ranks: n of them share the test host.
            old = os.environ.get("OMP_NUM_THREADS")
            os.environ["OMP_NUM_THREADS"] = "1"
            try:
                self.group = mesh_engine.spawn_group(
                    pmesh.make_mesh(pmesh.MeshPlan(dp=n), ["cpu"] * n),
                    timeout_s=TIMEOUT_S)
            finally:
                if old is None:
                    del os.environ["OMP_NUM_THREADS"]
                else:
                    os.environ["OMP_NUM_THREADS"] = old
        return self.group

    def close(self):
        if self.group is not None:
            self.group.close()
            self.group = None


def _ranks(ctx, plan):
    mesh = pmesh.make_mesh(pmesh.MeshPlan(**plan), ctx.ranks.devices)
    return mesh, MeshRanks(mesh, ctx.ranks)


def _cut_params(tree, cfg, ranks, specs, device=None):
    state = train.state_from_numpy(
        {"step": 0, "count": 0, "params": tree, "mu": tree, "nu": tree}, cfg,
        device=device, ranks=ranks, specs=specs)
    return state.params


def pipeline_forward(ctx, plan, cfg, tree, tokens, n_microbatches):
    """The pipeline's logits of this rank's rows (no gradient)."""
    mesh, ranks = _ranks(ctx, plan)
    params = _cut_params(tree, cfg, ranks, pipeline.pp_param_pspecs(cfg))
    pipe = pipeline.make_pipeline_forward(mesh, cfg, n_microbatches)
    hints = shd.MegatronHints(ranks)
    tok = torch.from_numpy(tokens)
    logits, aux = pipe(params, tok, hints)
    rows = torch.cat(pipe.rows(tok.shape[0], hints)).numpy()
    return {"coord": ranks.coord, "rows": rows, "ticks": pipe.ticks,
            "logits": logits.numpy(), "aux": float(aux["moe_lb_loss"])}


def pipeline_grads(ctx, plan, cfg, tree, tokens, n_microbatches):
    """Gradients of mean(logits ** 2) through the pipeline: this stage's
    layers' wq and w_down (f32), keyed by layer."""
    mesh, ranks = _ranks(ctx, plan)
    params = _cut_params(tree, cfg, ranks, pipeline.pp_param_pspecs(cfg))
    pipe = pipeline.make_pipeline_forward(mesh, cfg, n_microbatches)
    hints = shd.MegatronHints(ranks)
    tok = torch.from_numpy(tokens)
    B, S = tok.shape
    n = B * S * cfg.vocab_size

    def head_loss(logits, rows):
        return (logits.float() ** 2).sum() / n

    part = pipe.value_and_grad(params, tok, hints, head_loss)
    loss = ranks.group("pp").all_reduce(part.reshape(1))[0]
    grads = {(layer, name): getattr(bp, name).grad.float().numpy()
             for layer, bp in zip(params.layers, params.blocks)
             for name in ("wq", "w_down")}
    return {"coord": ranks.coord, "loss": float(loss), "grads": grads}


def loss_part(ctx, plan, cfg, tree, tokens, loss_mask):
    """This rank's part of ``train.loss_fn`` (sequence sharded over sp),
    and the parts summed over dp x sp."""
    mesh, ranks = _ranks(ctx, plan)
    params = _cut_params(tree, cfg, ranks, shd.param_pspecs(cfg))
    hints = shd.MegatronHints(ranks)
    part = train.loss_fn(params, torch.from_numpy(tokens),
                         torch.from_numpy(loss_mask), cfg, hints)
    total = ranks.group("dp", "sp").all_reduce(part.detach().reshape(1))[0]
    return {"coord": ranks.coord, "part": float(part.detach()),
            "total": float(total)}


def ring_aux(ctx, cfg, tree, tokens):
    """The scoring forward's logits and MoE aux under ring attention over
    this group (an sp ring of every rank), and the gathers a forward
    makes with the aux and without it."""
    params = _cut_params(tree, cfg, None, None, ctx.ranks.device)
    tok = torch.from_numpy(tokens)
    n0 = ctx.ranks.gathers
    logits, aux = transformer.forward(params, tok, cfg, return_aux=True,
                                      ring=ctx.ranks)
    n1 = ctx.ranks.gathers
    plain = transformer.forward(params, tok, cfg, ring=ctx.ranks)
    return {"logits": logits.numpy(), "aux": float(aux["moe_lb_loss"]),
            "plain": plain.numpy(), "gathers_aux": n1 - n0,
            "gathers_plain": ctx.ranks.gathers - n1}


def moe_aux_block(ctx, cfg, tree, x):
    """Layer 0's MoE aux of this rank's block of the sequence of ``x``
    [B, S, D] (bf16 bits), the statistics averaged over the group."""
    params = _cut_params(tree, cfg, None, None, ctx.ranks.device)
    n, r = ctx.ranks.world, ctx.ranks.rank
    s = x.shape[1] // n
    h = torch.from_numpy(x[:, r * s:(r + 1) * s].copy()).view(torch.bfloat16)
    with torch.no_grad():
        _, aux = transformer.moe_block(h, params.blocks[0], cfg,
                                       transformer._group_mean(ctx.ranks))
    return float(aux)


def loader_steps(ctx, cfg, tree, shards, n_steps):
    """The data loader's batches through a dp = 2 step (every rank reads
    the same seeded stream, so every rank sees the same global batch)."""
    from seldon_tpu_torch.data import TokenDataLoader

    mesh, ranks = _ranks(ctx, dict(dp=ctx.ranks.world))
    _, step_fn = train.make_sharded_train_step(
        mesh, cfg, train.make_optimizer(total_steps=10), seq_sharded=False,
        ranks=ranks)
    state = train.state_from_numpy(
        {"step": 0, "count": 0, "params": tree,
         "mu": _zeros(tree), "nu": _zeros(tree)}, cfg, ranks=ranks,
        specs=shd.param_pspecs(cfg))
    dl = TokenDataLoader(shards, batch_size=4, seq_len=31, seed=0)
    losses = []
    try:
        for _ in range(n_steps):
            batch = np.asarray(next(dl))[:, :32]
            state, m = step_fn(state, batch, np.ones(batch.shape, np.float32))
            losses.append(m["loss"])
    finally:
        dl.close()
    return losses


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return np.zeros_like(tree)
