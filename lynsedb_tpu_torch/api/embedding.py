"""Lazy text-embedding adapter for ``add(documents=...)`` / ``search(document=...)``.

The reference lazily loads a fastembed model
(reference: python/lynse/api/_embedding.py:29, default model
Qdrant/clip-ViT-B-32-text, env-tunable adapter). This build ships a
deterministic, dependency-free hashed n-gram embedder as the default adapter
(suitable for tests and air-gapped deployments) and accepts any callable via
``embed_func`` or :func:`register_embedding_adapter` for real models.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, List, Optional

import numpy as np

DEFAULT_DIM = int(os.environ.get("LYNSE_EMBED_DIM", 512))

_adapter: Optional[Callable[[List[str]], np.ndarray]] = None


def register_embedding_adapter(fn: Callable[[List[str]], np.ndarray]) -> None:
    global _adapter
    _adapter = fn


def _hashed_ngram_embed(texts: List[str], dim: int = DEFAULT_DIM) -> np.ndarray:
    """Deterministic bag-of-character-trigram embedding with signed hashing,
    L2-normalized. Not semantic — a stable, offline stand-in."""
    out = np.zeros((len(texts), dim), dtype=np.float32)
    for row, text in enumerate(texts):
        t = f"  {text.lower()} "
        for i in range(len(t) - 2):
            gram = t[i : i + 3].encode()
            h = int.from_bytes(hashlib.blake2b(gram, digest_size=8).digest(), "little")
            idx = h % dim
            sign = 1.0 if (h >> 63) & 1 else -1.0
            out[row, idx] += sign
        norm = np.linalg.norm(out[row])
        if norm > 0:
            out[row] /= norm
    return out


def embed_documents(documents: List[str], embed_func: Optional[Callable] = None) -> np.ndarray:
    fn = embed_func or _adapter or _hashed_ngram_embed
    arr = np.asarray(fn(list(documents)), dtype=np.float32)
    if arr.ndim != 2:
        raise ValueError("embedding adapter must return a 2D array")
    return arr
