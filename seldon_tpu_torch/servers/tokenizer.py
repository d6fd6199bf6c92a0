"""Byte-level tokenizer for preset (synthetic-weight) models.

Copy of ``seldon_tpu/servers/tokenizer.py::ByteTokenizer``: the port keeps
its own so that it never imports the JAX package. Checkpoint tokenizers
arrive with checkpoint loading (ROADMAP.md queue A)."""

from __future__ import annotations

from typing import List, Sequence


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
