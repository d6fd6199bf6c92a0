"""Batched autoregressive generation: prefill + a decode loop.

Port of ``seldon_tpu/models/generate.py``. The JAX ``generate`` is one
jitted function with a ``lax.scan`` of ``decode_step``; here it is a
``torch.no_grad`` Python loop, and the sampling noise comes from a
``torch.Generator`` in place of a PRNG key. Rows freeze after EOS by
value-level masking, so nothing in the loop waits for the device.
"""

from __future__ import annotations

from typing import Tuple

import torch

from seldon_tpu_torch.models import transformer
from seldon_tpu_torch.models.config import ModelConfig
from seldon_tpu_torch.models.sampling import sample


@torch.no_grad()
def generate(
    params: transformer.Transformer,
    tokens: torch.Tensor,  # [B, S] right-padded prompts
    prompt_lens: torch.Tensor,  # [B]
    generator: torch.Generator,  # on tokens' device
    temperature: torch.Tensor,  # [B]
    top_k: torch.Tensor,  # [B]
    top_p: torch.Tensor,  # [B]
    cfg: ModelConfig,
    max_new_tokens: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out_tokens [B, max_new_tokens] int32, out_lens [B] int32).

    Rows stop at cfg.eos_token_id; positions past EOS hold pad_token_id;
    a length counts the tokens up to and including EOS (max_new_tokens if
    the row never finished). The cache holds S + max_new_tokens columns,
    on the tokens' device."""
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got "
                         f"{max_new_tokens}")
    B, S = tokens.shape
    cache = transformer.init_cache(cfg, B, S + max_new_tokens,
                                   device=tokens.device)
    logits, cache = transformer.prefill(params, tokens, prompt_lens, cache,
                                        cfg)
    pos = prompt_lens.to(torch.int32)
    done = torch.zeros(B, dtype=torch.bool, device=tokens.device)
    toks = []
    for step in range(max_new_tokens):
        tok = sample(logits, generator, temperature, top_k, top_p)
        tok = torch.where(done, cfg.pad_token_id, tok)
        done = done | (tok == cfg.eos_token_id)
        toks.append(tok)
        if step + 1 < max_new_tokens:  # the last token needs no logits
            logits, cache = transformer.decode_step(params, tok, pos, cache,
                                                    cfg)
            pos = pos + 1
    out = torch.stack(toks, dim=1)
    is_eos = out == cfg.eos_token_id
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=-1)
    out_lens = torch.where(is_eos.any(dim=-1), first_eos + 1,
                           max_new_tokens)
    return out, out_lens.to(torch.int32)
