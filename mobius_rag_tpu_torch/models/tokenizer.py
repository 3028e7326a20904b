"""Hash tokenizer: text → fixed-length id sequences with no external
vocabulary file (the port of ``mobius_rag_tpu.models.tokenizer``). Words
are normalized by the same stemmer the lexical arm uses, then hashed into
a fixed id space (ids 3..V-1; 0=pad, 1=CLS, 2=SEP).

Rationale: the reference delegates tokenization to external embedding
APIs (app/services/embedding_provider.py); a self-contained tokenizer
keeps the on-card encoder dependency-free and deterministic. Swap in a
learned subword vocab by implementing the same (encode_batch) interface.
"""
from __future__ import annotations

import zlib

import numpy as np

from mobius_rag_tpu_torch.query.text import tokenize

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2  # used by the cross-encoder's [CLS] q [SEP] d packing
_RESERVED = 3


class HashTokenizer:
    def __init__(self, vocab_size: int, max_len: int):
        self.vocab_size = vocab_size
        self.max_len = max_len
        # token → id: the vocabulary of a corpus is small and Zipf-shaped,
        # so each distinct token is hashed once
        self._ids: dict[str, int] = {}

    def _id(self, tok: str) -> int:
        i = self._ids.get(tok)
        if i is None:
            i = _RESERVED + zlib.crc32(tok.encode()) % (self.vocab_size - _RESERVED)
            self._ids[tok] = i
        return i

    def encode(self, text: str) -> np.ndarray:
        ids = [CLS_ID]
        for tok in tokenize(text):
            ids.append(self._id(tok))
            if len(ids) >= self.max_len:
                break
        out = np.full(self.max_len, PAD_ID, np.int32)
        out[: len(ids)] = ids
        return out

    def encode_batch(self, texts: list[str]) -> np.ndarray:
        return np.stack([self.encode(t) for t in texts])
