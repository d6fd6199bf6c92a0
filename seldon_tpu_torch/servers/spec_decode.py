"""Host-side draft proposal for speculative decoding — copy of
``seldon_tpu/servers/spec_decode.py`` (the port keeps its own, so that it
never imports the JAX package).

Two drafters share one contract — propose k deterministic tokens per
live slot from the row's whole token history (prompt + generated) — and
the engine picks one at init:

 * :class:`NGramDrafter` (default, no second model): the longest-suffix
   n-gram match over the row's own history, proposing the tokens that
   followed its previous occurrence. No device work and no memory;
   strong on repetitive or templated traffic, and on incompressible
   streams it degrades to acceptance ~0 (plain decode plus one wide
   verify's overhead).
 * :class:`ModelDrafter` (``draft=(params, cfg)`` given to the engine):
   a resident small model proposes greedy continuations of a sliding
   history window in one call per wave
   (``models/spec_decode.draft_tokens``, on the engine's device).

Determinism is the only correctness requirement: verification is exact
match against the target's own sequentially keyed samples, so a bad
draft costs acceptance, never output.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Longest n-gram pattern tried first; the trailing window keeps the
# host-side match O(NGRAM_WINDOW * NGRAM_MAX) per row per wave.
NGRAM_MAX = 3
NGRAM_WINDOW = 256


class NGramDrafter:
    """Deterministic self-speculation: propose the continuation of the
    most recent earlier occurrence of the history's suffix n-gram (n =
    NGRAM_MAX down to 1), else repeat the last token. Pure host
    arithmetic."""

    # The engine's capability flag: no draft model to call.
    uses_model = False

    def draft(self, prompt: Sequence[int], gen: Sequence[int],
              k: int) -> List[int]:
        hist = list(prompt[-NGRAM_WINDOW:]) + list(gen[-NGRAM_WINDOW:])
        hist = hist[-NGRAM_WINDOW:]
        L = len(hist)
        for n in range(min(NGRAM_MAX, L - 1), 0, -1):
            pat = hist[-n:]
            # Rightmost earlier occurrence: continuation tokens exist by
            # construction (j + n < L).
            for j in range(L - n - 1, -1, -1):
                if hist[j:j + n] == pat:
                    cont = hist[j + n:j + n + k]
                    while len(cont) < k:
                        cont.append(cont[-1])
                    return cont
        return [hist[-1]] * k


class ModelDrafter:
    """Draft-model proposal: builds each wave's history windows on the
    host and runs ``draft_tokens`` on the draft model's device."""

    uses_model = True

    def __init__(self, draft: Tuple[Any, Any], window: int, pad_id: int):
        self.params, self.cfg = draft
        self.window = int(window)
        self._pad = int(pad_id)

    def draft_batch(
        self,
        rows: Sequence[tuple],  # (slot, history list) pairs
        k: int,
        batch: int,
        programs=None,
    ) -> np.ndarray:
        """One call proposing k tokens for every wave row. Returns drafts
        [batch, k] int32 (rows outside the wave get pad windows). With
        ``programs`` (the engine's ``servers/wave_program.Programs``) the
        call is the stateless program ``("draft", k)``: the windows are
        staged into its static inputs and its replay is read back here,
        outside the graph."""
        W = self.window
        window = np.full((batch, W), self._pad, np.int32)
        wlens = np.ones((batch,), np.int32)
        for slot, hist in rows:
            tail = hist[-W:]
            window[slot, :len(tail)] = tail
            wlens[slot] = max(1, len(tail))
        if programs is not None:
            _, (out,) = programs.run((("draft", k), ()), self._body(k), None,
                                     [window, wlens])
        else:
            dev = self.params.device
            out = self._body(k)(None, torch.from_numpy(window).to(dev),
                                torch.from_numpy(wlens).to(dev))[1]
        return out.cpu().numpy()

    def _body(self, k: int):
        """``draft_tokens`` at rung ``k`` as a stateless program's body."""
        from seldon_tpu_torch.models.spec_decode import draft_tokens

        def body(state, window, wlens):
            return None, draft_tokens(self.params, window, wlens, self.cfg,
                                      k)
        return body


def make_drafter(draft: Optional[Tuple[Any, Any]], window: int,
                 pad_id: int):
    """The engine's factory: a ModelDrafter when a draft model was given,
    else the n-gram drafter."""
    if draft is not None:
        return ModelDrafter(draft, window, pad_id)
    return NGramDrafter()
