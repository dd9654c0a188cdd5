"""Per-image embedding cache.

:class:`EmbeddingCache` — a content-addressed store of per-image embedding
vectors, so re-submitted images skip the forward pass entirely (the
reference's ``CacheDir`` name promised this but never cached embeddings,
embeddings.go:19). The JAX package's Orbax checkpoints have no counterpart
in the port yet.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

__all__ = ["EmbeddingCache"]


class EmbeddingCache:
    """content-hash -> embedding vector store (one small .npy per image).

    Keys include the embedder identity (model name + weight fingerprint) so a
    model/weight change can never serve stale vectors — unlike the
    reference's filename-keyed label cache (rekognition.go:127-131).
    """

    def __init__(self, cache_dir: str, model_tag: str):
        self.cache_dir = cache_dir
        self.model_tag = model_tag
        os.makedirs(cache_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0

    def _path(self, image_bytes: bytes) -> str:
        h = hashlib.sha256()
        h.update(self.model_tag.encode())
        h.update(image_bytes)
        return os.path.join(self.cache_dir, h.hexdigest()[:32] + "_emb.npy")

    def get(self, image_bytes: bytes) -> np.ndarray | None:
        path = self._path(image_bytes)
        if os.path.exists(path):
            try:
                vec = np.load(path)
                self.hits += 1
                return vec
            except (OSError, ValueError):
                pass
        return None

    def put(self, image_bytes: bytes, vec: np.ndarray) -> None:
        path = self._path(image_bytes)
        tmp = path + ".tmp.npy"
        np.save(tmp, np.asarray(vec, np.float32))
        os.replace(tmp, path)
        self.misses += 1

    def embed_with_cache(self, embedder, blobs: list[bytes],
                         batch: np.ndarray) -> np.ndarray:
        """Return (n, dim) embeddings, computing only the cache misses (as
        one device batch) and backfilling the store."""
        n = len(blobs)
        out = np.empty((n, embedder.spec.dim), np.float32)
        miss_idx = []
        for i, blob in enumerate(blobs):
            vec = self.get(blob)
            if vec is not None and vec.shape == (embedder.spec.dim,):
                out[i] = vec
            else:
                miss_idx.append(i)
        if miss_idx:
            fresh = embedder.embed(batch[miss_idx])
            for j, i in enumerate(miss_idx):
                out[i] = fresh[j]
                self.put(blobs[i], fresh[j])
        return out
