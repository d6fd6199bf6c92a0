"""Token sampling — temperature / top-k / top-p, no host sync.

Port of ``seldon_tpu/models/sampling.py``. The JAX ``sample_per_row``
draws its Gumbel noise from ``fold_in(key(seed), position)``; here the
two halves are split:

 * :func:`select_tokens` — the selection (greedy argmax, temperature,
   top-k / top-p masks, Gumbel-argmax) with the noise passed in as a
   tensor. Fed JAX's own Gumbel noise it returns JAX's tokens
   (tests/test_torch_sampling.py).
 * :func:`gumbel_noise` — the noise, ``gumbel(fold_in(key(seed),
   position))`` computed on the device by the port's threefry
   (``models/prng.py``): the same bits as ``jax.random``, the Gumbel
   values within an ulp of JAX's (where ``log`` rounds differently). A
   token is reproducible from (seed, position) whatever else shares the
   batch, and sampled streams follow the JAX engine's.
 * :func:`sample` — the whole-batch sampler of ``models/generate.py``:
   noise drawn from an explicit ``torch.Generator``, not from JAX's
   ``split`` keys (ROADMAP.md lists that twin as left).

Every branch is value-level (``torch.where``), so nothing here waits on
the device.
"""

from __future__ import annotations

import dataclasses

import torch

from seldon_tpu_torch.models import prng


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Host-side request knobs; converted to per-row arrays by the engine.
    Field for field the JAX package's ``SamplingParams``."""

    temperature: float = 0.7
    top_k: int = 0  # 0 = disabled
    top_p: float = 1.0  # 1.0 = disabled
    max_new_tokens: int = 128
    seed: int = 0
    # Request TTL in milliseconds, measured from submit. 0 = no per-
    # request deadline (EngineConfig.default_deadline_ms still applies).
    deadline_ms: int = 0
    # W3C traceparent of the caller's trace: the engine's lifecycle spans
    # adopt it (when tracing is on).
    traceparent: str = ""


def _mask_top_k_top_p(
    scaled: torch.Tensor,  # [B, V] temperature-scaled logits
    top_k: torch.Tensor,  # [B] int; 0 => off
    top_p: torch.Tensor,  # [B] f32; 1.0 => off
) -> torch.Tensor:
    """Apply top-k + top-p (nucleus) masks; one sort per row. The argmax
    is always kept, so top_p <= 0 degrades to greedy."""
    B, V = scaled.shape
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k = torch.clamp(torch.where(top_k <= 0, V, top_k), 1, V).long()
    kth = torch.gather(sorted_desc, 1, (k - 1)[:, None])
    ninf = float("-inf")  # a Python scalar: no host-to-device copy
    masked = torch.where(scaled < kth, ninf, scaled)

    ranks = torch.arange(V, device=scaled.device)[None, :]
    sorted_logits = torch.where(ranks >= k[:, None], ninf, sorted_desc)
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    inside = cum - probs_sorted < torch.clamp(top_p, min=1e-9)[:, None]
    cut = torch.where(inside, sorted_logits, -ninf)
    min_keep = cut.amin(dim=-1, keepdim=True)
    return torch.where(masked < min_keep, ninf, masked)


def select_tokens(
    logits: torch.Tensor,  # [B, V] f32
    gumbel: torch.Tensor,  # [B, V] f32 Gumbel(0, 1) noise
    temperature: torch.Tensor,  # [B] f32; 0 => greedy
    top_k: torch.Tensor,  # [B] int; 0 => off
    top_p: torch.Tensor,  # [B] f32; 1.0 => off
) -> torch.Tensor:
    """Row-independent Gumbel-argmax sampling: argmax(logits / T + g) is a
    categorical sample. As in JAX, the top-k/top-p masks apply to the
    whole batch when ANY row uses them (a device-side ``where``, never a
    host branch). Returns [B] int32."""
    greedy = torch.argmax(logits, dim=-1)
    temp = torch.clamp(temperature, min=1e-6)[:, None]
    scaled = logits / temp
    need_mask = (top_k > 0).any() | (top_p < 1.0).any()
    scaled = torch.where(need_mask, _mask_top_k_top_p(scaled, top_k, top_p),
                         scaled)
    sampled = torch.argmax(scaled + gumbel, dim=-1)
    return torch.where(temperature <= 0, greedy, sampled).to(torch.int32)


def gumbel_noise(seeds: torch.Tensor, positions: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[B, V] f32 Gumbel(0, 1) noise of rows keyed by (seed, position):
    ``jax.random.gumbel(fold_in(key(seed), position), (V,))`` per row.
    seeds [B] (uint32 values in any integer dtype), positions [B] int."""
    keys = prng.fold_in(prng.key(seeds), positions)
    return prng.gumbel(keys, (vocab,))


def sample_per_row(
    logits: torch.Tensor,  # [B, V] f32
    seeds: torch.Tensor,  # [B] uint32 values
    positions: torch.Tensor,  # [B] int
    temperature: torch.Tensor,
    top_k: torch.Tensor,
    top_p: torch.Tensor,
) -> torch.Tensor:
    """The engine's sampler: :func:`gumbel_noise` keyed by (seed,
    position) fed to :func:`select_tokens`."""
    noise = gumbel_noise(seeds, positions, logits.shape[-1])
    return select_tokens(logits, noise, temperature, top_k, top_p)


def sample(
    logits: torch.Tensor,  # [B, V] f32
    generator: torch.Generator,  # on logits' device
    temperature: torch.Tensor,  # [B] f32; 0 => greedy
    top_k: torch.Tensor,  # [B] int; 0 => off
    top_p: torch.Tensor,  # [B] f32; 1.0 => off
) -> torch.Tensor:
    """Whole-batch sampling (the ``generate`` path): Gumbel noise drawn
    from ``generator`` (uniforms in [tiny, 1), as ``jax.random.gumbel``
    draws them) fed to :func:`select_tokens`. The draws are not
    threefry's, so sampled rows differ from the JAX package's; greedy
    rows do not depend on the noise."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return select_tokens(logits, -torch.log(-torch.log(u)), temperature,
                         top_k, top_p)
