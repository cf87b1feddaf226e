"""Byte-level tokenizer (vocab 256 + specials) for the real-model examples."""
from __future__ import annotations

from typing import List

PAD_ID = 0
BOS_ID = 1
EOS_ID = 2
_OFFSET = 3
VOCAB_SIZE = 256 + _OFFSET


def encode(text: str, add_bos: bool = True) -> List[int]:
    ids = [b + _OFFSET for b in text.encode("utf-8", errors="replace")]
    return ([BOS_ID] + ids) if add_bos else ids


def decode(ids: List[int]) -> str:
    return bytes(max(i - _OFFSET, 0) for i in ids
                 if i >= _OFFSET).decode("utf-8", errors="replace")
