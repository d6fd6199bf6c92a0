"""Pipeline parallelism ('pp' axis): the GPipe microbatch schedule — port
of ``seldon_tpu/parallel/pipeline.py``.

Block leaves shard their layer axis over 'pp' (:func:`pp_param_pspecs`):
stage i holds layers ``[i*L/P, (i+1)*L/P)``; the embedding, final norm
and head stay replicated over the stages. GPipe with M microbatches over
P stages: stage s runs microbatch m at tick s + m, T = M + P - 1 ticks,
bubble fraction (P - 1) / T.

Where JAX runs the whole schedule as one ``lax.scan`` under a
``shard_map`` that is manual over 'pp' and lets autodiff transpose it,
the port runs one process per rank and writes both directions itself:
 * forward: stage 0 embeds microbatch m, every other stage receives its
   activations from stage s - 1 (``RankGroup.recv`` on the pp group),
   runs its layers (``transformer.blocks_train``, remat per block) and
   sends the result to stage s + 1; the last stage computes the head and
   the microbatch's loss. Point-to-point transfers in schedule order
   need no barrier per tick.
 * backward (:meth:`PipelineForward.value_and_grad`): microbatches in
   reverse order; the last stage backpropagates its loss, every other
   stage receives the gradient of its output from stage s + 1, and each
   stage but the first sends the gradient of its input to stage s - 1.
The MoE aux is summed over every (stage, microbatch) a stage was busy
with and divided by L * M, JAX's ``psum(aux_total) / (L * M)``.

Each stage's gradients are only its own part: the embedding gets its
gradient on stage 0 and the final norm and head on the last stage, so the
train step sums every pp-replicated leaf's gradient over the pp group
(``models/train.py``). Microbatch m is the global rows ``[m*B/M,
(m+1)*B/M)``, as in JAX; under dp each dp rank runs its contiguous share
of every microbatch, so a microbatch's MoE statistics, averaged over dp,
are JAX's.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.quantize import true_div
from seldon_tpu_torch.parallel import sharding as shd
from seldon_tpu_torch.parallel.sharding import P


def pp_param_pspecs(cfg) -> Dict[str, Any]:
    """``param_pspecs`` with the stacked layer axis sharded over 'pp':
    each stage holds a contiguous slab of layers. Non-block leaves
    (embed, final norm, lm_head) stay pp-replicated."""
    specs = shd.param_pspecs(cfg)
    specs["blocks"] = {name: P("pp", *spec[1:])
                       for name, spec in specs["blocks"].items()}
    return specs


class PipelineForward:
    """The GPipe schedule of ``mesh``'s pp axis at one rank (built by
    :func:`make_pipeline_forward`)."""

    def __init__(self, mesh, cfg: ModelConfig, n_microbatches: int,
                 remat: bool):
        self.cfg = cfg
        self.n_stages = int(mesh.shape["pp"])
        self.dp = int(mesh.shape["dp"])
        self.M = int(n_microbatches)
        self.remat = remat

    @property
    def ticks(self) -> int:
        return self.M + self.n_stages - 1

    def rows(self, B: int, hints) -> List[torch.Tensor]:
        """This rank's global rows of each microbatch: the dp rank's
        contiguous share of rows ``[m*B/M, (m+1)*B/M)``."""
        if B % self.M != 0:
            raise ValueError(f"batch {B} not divisible by microbatches "
                             f"{self.M}")
        mb = B // self.M
        if mb % self.dp:
            raise ValueError(f"a microbatch of {mb} rows does not split "
                             f"over dp={self.dp}")
        w, d = mb // self.dp, hints.ranks.coord["dp"]
        return [torch.arange(m * mb + d * w, m * mb + (d + 1) * w)
                for m in range(self.M)]

    def _stage_forward(self, params, tokens, hints, grad: bool):
        """Run this stage's part of the forward schedule. Returns, per
        microbatch, (rows, stage input, stage output, the stage's aux)."""
        pp = hints.ranks.group("pp")
        stage, last = pp.rank, pp.world - 1
        lo, s = hints.seq_block(tokens.shape[1])
        dev = tokens.device
        out = []
        for rows in self.rows(tokens.shape[0], hints):
            tok = tokens[rows.to(dev), lo:lo + s]
            if stage == 0:
                x = transformer.embed_train(params, tok, hints)
            else:
                x = pp.recv((tok.shape[0], s, self.cfg.d_model),
                            transformer._dtype(self.cfg), stage - 1)
                x.requires_grad_(grad)
            with torch.set_grad_enabled(grad):
                y, aux = transformer.blocks_train(
                    params, x, self.cfg, transformer.positions_of(tok, hints),
                    hints, self.remat)
            if stage < last:
                pp.send(y.detach(), stage + 1)
            out.append((rows, x, y, aux))
        return out

    @torch.no_grad()
    def __call__(self, params, tokens: torch.Tensor, hints):
        """(logits of this rank's rows, in the order of
        ``torch.cat(self.rows(B, hints))`` and its sp block of the
        sequence, [b, s, V] f32, {"moe_lb_loss": the mean aux}) on every
        stage: the last stage's hidden states are broadcast over pp, as
        JAX's psum makes them pp-replicated."""
        pp = hints.ranks.group("pp")
        done = self._stage_forward(params, tokens, hints, grad=False)
        hidden = torch.cat([y for _, _, y, _ in done])
        hidden = pp.broadcast(hidden.contiguous(), pp.world - 1)
        aux = pp.all_reduce(sum(a for *_, a in done).reshape(1))[0]
        return (transformer.logits_train(params, hidden, self.cfg, hints),
                {"moe_lb_loss": true_div(aux, self.cfg.n_layers * self.M)})

    def value_and_grad(self, params, tokens: torch.Tensor, hints,
                       head_loss: Callable[[torch.Tensor, torch.Tensor],
                                           torch.Tensor],
                       aux_weight: float = 0.0) -> torch.Tensor:
        """Forward and backward of the whole schedule; the gradients of
        this stage's leaves accumulate in their ``.grad``. ``head_loss(
        logits [b, s, V], rows)`` is a microbatch's part of the loss
        (run on the last stage); ``aux_weight`` times the mean aux is
        added, each stage adding its share. Returns this stage's part of
        the loss (detached): the sum over the pp group is the loss."""
        pp = hints.ranks.group("pp")
        stage, last = pp.rank, pp.world - 1
        done = self._stage_forward(params, tokens, hints, grad=True)
        share = aux_weight / (self.cfg.n_layers * self.M * hints.stats.world)
        total = torch.zeros((), dtype=torch.float32, device=tokens.device)
        for rows, x, y, aux in reversed(done):
            term = share * aux if aux_weight and self.cfg.n_experts else None
            if stage == last:
                root = head_loss(transformer.logits_train(
                    params, y, self.cfg, hints), rows)
                if term is not None:
                    root = root + term
                torch.autograd.backward([root])
                total = total + root.detach()
            else:
                g = pp.recv(y.shape, y.dtype, stage + 1)
                roots, grads = [y], [g]
                if term is not None:
                    roots.append(term)
                    grads.append(torch.ones_like(term))
                    total = total + term.detach()
                torch.autograd.backward(roots, grads)
            if stage > 0:
                pp.send(x.grad, stage - 1)
        return total


def make_pipeline_forward(mesh, cfg: ModelConfig, n_microbatches: int = 4,
                          remat: bool = False) -> PipelineForward:
    """The GPipe schedule over ``mesh``'s pp axis (parameters cut with
    :func:`pp_param_pspecs`). Raises ValueError, as JAX does, when pp does
    not divide n_layers; the batch's divisibility by the microbatch count
    is checked at each call."""
    cfg = cfg.validate()
    n_stages = int(mesh.shape["pp"])
    if cfg.n_layers % n_stages != 0:
        raise ValueError(
            f"n_layers={cfg.n_layers} not divisible by pp={n_stages}")
    return PipelineForward(mesh, cfg, n_microbatches, remat)
