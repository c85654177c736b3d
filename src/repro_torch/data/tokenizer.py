"""Byte-level tokenizer (port of ``repro/data/tokenizer.py``; no external
vocab files, fully offline).

ids 0..255 = raw bytes; 256 = BOS, 257 = EOS, 258 = PAD.  Round-trips any
UTF-8 text; used by the runnable examples and the fine-tuning benchmark
tasks.
"""

from __future__ import annotations

from typing import Iterable, List


__all__ = ["ByteTokenizer"]


class ByteTokenizer:
    BOS = 256
    EOS = 257
    PAD = 258
    vocab_size = 259

    def encode(self, text: str, *, bos: bool = True, eos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [self.BOS] + ids
        if eos:
            ids = ids + [self.EOS]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        raw = bytes(i for i in ids if 0 <= i < 256)
        return raw.decode("utf-8", errors="replace")
