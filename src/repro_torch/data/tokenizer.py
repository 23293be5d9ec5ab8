"""Minimal byte-level tokenizer + document packing for real text files (a
copy of ``repro/data/tokenizer.py``, which imports no framework).

No external vocab needed offline: bytes 0..255 map to ids 0..255, with
specials appended. pack() concatenates documents with EOS separators into
fixed-length training rows (standard LM packing).
"""

from __future__ import annotations

from typing import Iterable, List

import numpy as np

BOS = 256
EOS = 257
PAD = 258
VOCAB = 259


def encode(text: str) -> List[int]:
    return [BOS] + list(text.encode("utf-8")) + [EOS]


def decode(ids: Iterable[int]) -> str:
    bs = bytes(i for i in ids if 0 <= i < 256)
    return bs.decode("utf-8", errors="replace")


def pack(docs: Iterable[str], seq_len: int) -> np.ndarray:
    """Pack encoded docs into (n_rows, seq_len) int32 with EOS separators."""
    buf: List[int] = []
    for d in docs:
        buf.extend(encode(d))
    n_rows = max(1, len(buf) // seq_len)
    need = n_rows * seq_len
    if len(buf) < need:
        buf.extend([PAD] * (need - len(buf)))
    arr = np.asarray(buf[:need], np.int32).reshape(n_rows, seq_len)
    return arr
