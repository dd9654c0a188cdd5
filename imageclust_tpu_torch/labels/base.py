"""Semantic labeling interface: pluggable backends + content-addressed cache.

The reference hardwires AWS Rekognition (internal/rekognition/rekognition.go)
with a JSON file cache keyed on the image's *base filename*
(rekognition.go:127-131) — two different images named "photo.jpg" collide,
and the same image re-uploaded under a new name misses. The rebuild keys the
cache on the content hash instead (SURVEY.md §5 checkpoint/resume) and makes
the backend pluggable: Rekognition (HTTP SigV4), a local zero-shot labeler,
or a deterministic fake for offline use and tests.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from dataclasses import asdict, dataclass
from typing import Protocol

log = logging.getLogger(__name__)

__all__ = ["Label", "Labeler", "CachedLabeler", "create_labeler"]


@dataclass(frozen=True)
class Label:
    """Mirror of the fields the reference reads from Rekognition's
    types.Label (Name, Confidence)."""

    name: str
    confidence: float


class Labeler(Protocol):
    def detect_labels(
        self, image_bytes: bytes, max_labels: int, min_confidence: float
    ) -> list[Label]:
        """Return up to max_labels labels with confidence >= min_confidence,
        sorted by descending confidence."""
        ...


class CachedLabeler:
    """Cache-first wrapper — the reference's behavior (rekognition.go:90-124)
    with content-hash keys.

    Note the reference quirk this preserves: the cache stores the *first*
    call's labels regardless of its (max_labels, min_confidence) arguments,
    so a later call with stricter parameters silently reuses the looser
    result (SURVEY.md §2 "Rekognition is called twice per image"). We keep
    cache-hit-returns-cached semantics but record the query params in the
    cache file for observability.
    """

    def __init__(self, inner: Labeler, cache_dir: str | None,
                 namespace: str = ""):
        self.inner = inner
        self.cache_dir = cache_dir
        # backend identity in the key: a reused cache dir must never serve
        # one backend's labels for another (cf. EmbeddingCache's model_tag)
        self.namespace = namespace or type(inner).__name__
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
        self.hits = 0
        self.misses = 0
        # optional shared RateLimiter (LabelingService installs it):
        # acquired only before a real backend call, never on a cache hit
        self.limiter = None

    def _cache_path(self, image_bytes: bytes) -> str:
        h = hashlib.sha256()
        h.update(self.namespace.encode())
        h.update(image_bytes)
        return os.path.join(self.cache_dir, f"{h.hexdigest()[:32]}_labels.json")

    def detect_labels(
        self, image_bytes: bytes, max_labels: int, min_confidence: float
    ) -> list[Label]:
        if not self.cache_dir:
            if self.limiter is not None:
                self.limiter.acquire()
            return self.inner.detect_labels(image_bytes, max_labels, min_confidence)
        path = self._cache_path(image_bytes)
        if os.path.exists(path):
            try:
                with open(path) as fh:
                    data = json.load(fh)
                self.hits += 1
                return [Label(d["name"], d["confidence"]) for d in data["labels"]]
            except (json.JSONDecodeError, KeyError):
                log.warning("corrupt label cache %s — refetching", path)
        if self.limiter is not None:
            self.limiter.acquire()
        labels = self.inner.detect_labels(image_bytes, max_labels, min_confidence)
        self.misses += 1
        import threading

        tmp = f"{path}.{threading.get_ident()}.tmp"  # unique per writer
        with open(tmp, "w") as fh:
            json.dump(
                {
                    "labels": [asdict(l) for l in labels],
                    "query": {"max_labels": max_labels,
                              "min_confidence": min_confidence},
                },
                fh,
            )
        os.replace(tmp, path)
        return labels


def create_labeler(cfg, cache_dir: str | None = None, embedder=None) -> Labeler:
    """Build the configured labeler backend (LabelConfig.backend)."""
    backend = cfg.backend
    if backend in ("none", ""):
        from imageclust_tpu_torch.labels.fake import NullLabeler

        return NullLabeler()
    if backend == "fake":
        from imageclust_tpu_torch.labels.fake import FakeLabeler

        inner: Labeler = FakeLabeler()
    elif backend == "rekognition":
        from imageclust_tpu_torch.labels.rekognition import RekognitionLabeler

        inner = RekognitionLabeler(
            region=cfg.region, max_payload_bytes=cfg.max_payload_bytes
        )
    elif backend == "zero_shot":
        from imageclust_tpu_torch.labels.zero_shot import ZeroShotLabeler

        inner = ZeroShotLabeler.default(
            embedder=embedder,
            text_checkpoint=cfg.text_checkpoint_path or None)
    else:
        raise ValueError(f"unknown labeler backend {backend!r}")
    if cfg.cache and cache_dir:
        return CachedLabeler(inner, cache_dir)
    return inner
