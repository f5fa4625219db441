"""Deterministic feature-hashing text embeddings (copy of
``marie_tpu/embeddings/hashing.py``).

Weight-free backend for dedup/lookup workloads (the role the reference's
embedding registry fills with its cheapest provider): character n-gram +
word hashing into a signed feature space, L2-normalized.  No model, no
assets, identical vectors across processes — the right default for the
in-memory vector store when no trained encoder is configured.
"""

import hashlib
from typing import Sequence

import numpy as np

from marie_tpu_torch.embeddings.base import EmbeddingsBase


def _bucket(token: str, dim: int) -> tuple:
    h = int.from_bytes(
        hashlib.blake2b(token.encode(), digest_size=8).digest(), "little"
    )
    return h % dim, 1.0 if (h >> 63) & 1 else -1.0


class HashingEmbeddings(EmbeddingsBase):
    def __init__(self, dim: int = 384, ngram: int = 3, **kwargs):
        super().__init__(**kwargs)
        self.dim = dim
        self.ngram = ngram

    def get_embeddings(self, texts: Sequence[str], **kwargs) -> np.ndarray:
        out = np.zeros((len(texts), self.dim), np.float32)
        for i, text in enumerate(texts):
            t = text.lower().strip()
            tokens = t.split()
            grams = [
                t[j : j + self.ngram]
                for j in range(max(len(t) - self.ngram + 1, 1))
            ]
            for token in tokens + grams:
                idx, sign = _bucket(token, self.dim)
                out[i, idx] += sign
            norm = np.linalg.norm(out[i])
            if norm > 0:
                out[i] /= norm
        return out
