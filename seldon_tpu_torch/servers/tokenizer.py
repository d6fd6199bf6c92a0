"""Tokenizer loading: HF tokenizers when a checkpoint ships one, byte-level
fallback otherwise (tests / synthetic models need no vocab files).

Copy of ``seldon_tpu/servers/tokenizer.py``: the port keeps its own so
that it never imports the JAX package. ``transformers`` is imported only
when a checkpoint directory holds a tokenizer file."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence


class ByteTokenizer:
    """Reversible byte-level tokenizer: ids 0..255 are raw bytes; pad/eos
    specials sit above the byte range (256/257) so any UTF-8 round-trips."""

    PAD = 256
    EOS = 257
    vocab_size = 258

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", "replace")

    @property
    def eos_token_id(self) -> int:
        return self.EOS

    @property
    def pad_token_id(self) -> int:
        return self.PAD


class HFTokenizer:
    """Thin wrapper over transformers.AutoTokenizer."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self._tok = AutoTokenizer.from_pretrained(path)

    def encode(self, text: str) -> List[int]:
        return self._tok.encode(text)

    def decode(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids), skip_special_tokens=True)

    @property
    def eos_token_id(self) -> int:
        return self._tok.eos_token_id

    @property
    def pad_token_id(self) -> int:
        return self._tok.pad_token_id or 0


def load_tokenizer(model_dir: Optional[str]):
    if model_dir:
        for probe in ("tokenizer.json", "tokenizer_config.json",
                      "tokenizer.model"):
            if os.path.exists(os.path.join(model_dir, probe)):
                return HFTokenizer(model_dir)
    return ByteTokenizer()
