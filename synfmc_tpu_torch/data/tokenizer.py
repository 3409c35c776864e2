"""Deterministic offline tokenizer with CLIP's special-token layout.

A copy of synfmc_tpu/data/tokenizer.py:HashTokenizer, kept here so the port
imports nothing of the JAX package.  It stands in for CLIP's BPE tokenizer
until the vocabulary files are available.
"""

from __future__ import annotations

import hashlib

import numpy as np

BOS_ID = 49406
EOS_ID = 49407
VOCAB_SIZE = 49408
MAX_LENGTH = 77


class HashTokenizer:
    """[BOS] word-hash ids... [EOS], then EOS padding to max_length."""

    vocab_size = VOCAB_SIZE

    def __call__(self, texts, max_length: int = MAX_LENGTH) -> np.ndarray:
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), EOS_ID, dtype=np.int32)
        for row, text in enumerate(texts):
            ids = [BOS_ID]
            for word in text.lower().split():
                h = int.from_bytes(hashlib.sha1(word.encode()).digest()[:4], "little")
                ids.append(1000 + h % (BOS_ID - 1001))
                if len(ids) >= max_length - 1:
                    break
            ids.append(EOS_ID)
            out[row, : len(ids)] = ids
        return out
