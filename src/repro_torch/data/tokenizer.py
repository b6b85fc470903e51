"""Byte-level tokenizer (the port of ``repro.data.tokenizer``; for the
runnable examples, real deployments plug a sentencepiece model into the same
interface)."""

from __future__ import annotations

import numpy as np


class ByteTokenizer:
    """Reversible byte tokenizer with BOS/EOS; vocab = 256 + specials."""

    BOS = 256
    EOS = 257
    PAD = 258
    vocab_size = 259

    def encode(self, text: str, bos: bool = True, eos: bool = False) -> np.ndarray:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return np.asarray(ids, np.int32)

    def decode(self, ids) -> str:
        bs = bytes(int(i) for i in ids if int(i) < 256)
        return bs.decode("utf-8", errors="replace")
