"""Deterministic fake / null labelers for tests and offline runs
(SURVEY.md §7 item 5 — the reference has no fake and cannot run without AWS).
"""

from __future__ import annotations

import hashlib

from imageclust_tpu_torch.labels.base import Label

__all__ = ["FakeLabeler", "NullLabeler"]

_VOCAB = [
    "Clothing", "Footwear", "Accessory", "Person", "Furniture", "Food",
    "Plant", "Animal", "Vehicle", "Electronics", "Building", "Landscape",
    "Art", "Sport", "Tool", "Toy",
]


class FakeLabeler:
    """Deterministic labels derived from the image bytes' hash — stable
    across processes, no network."""

    def detect_labels(self, image_bytes: bytes, max_labels: int,
                      min_confidence: float) -> list[Label]:
        digest = hashlib.sha256(image_bytes).digest()
        out: list[Label] = []
        for i in range(min(max_labels, 8)):
            idx = digest[i] % len(_VOCAB)
            conf = 99.0 - digest[i + 8] % 40  # 59..99
            if conf < min_confidence:
                continue
            name = _VOCAB[idx]
            if name not in [l.name for l in out]:
                out.append(Label(name, float(conf)))
        out.sort(key=lambda l: -l.confidence)
        return out


class NullLabeler:
    """No labels — the pure-visual pipeline (label vector length 0)."""

    def detect_labels(self, image_bytes: bytes, max_labels: int,
                      min_confidence: float) -> list[Label]:
        return []
