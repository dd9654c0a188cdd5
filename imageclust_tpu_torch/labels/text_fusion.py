"""Dense text-label fusion: the joint visual+text feature mode.

The reference fuses semantics as a ONE-HOT block over the global label set
(embeddings.go:166-183) — that stays the parity default (labels/onehot.py).
This module is the BASELINE.json config-5 formulation instead ("joint
visual+text feature vectors: CLIP image tower + text-label tower"): each
label NAME is embedded once through the text tower (models/text.py), each
image gets the confidence-weighted mean of its labels' text embeddings, and
that fixed-width dense block is concatenated with the image embedding.

Why it matters at scale: the one-hot block's width is the number of UNIQUE
labels, which grows with the corpus (unbounded at the 10M tier), while the
text block is a fixed ``proj_dim`` (512 for the CLIP text tower) regardless
of vocabulary — and synonymous labels land near each other in text space
instead of being orthogonal axes. Non-parity by construction; enable with
``labels.fusion=text``. Meaningful geometry needs a real text checkpoint
(offline random init is deterministic wiring, like the zero-shot demo bank).
"""

from __future__ import annotations

import numpy as np

from imageclust_tpu_torch.labels.base import Label

__all__ = ["label_text_bank", "confidence_weights", "text_label_matrix"]

# Prompt template shared with the zero-shot bank builder
# (labels/zero_shot.py from_texts): CLIP-style context for bare label names.
_TEMPLATE = "a photo of {}"


def label_text_bank(label_set: dict[str, int], encoder,
                    template: str = _TEMPLATE) -> np.ndarray:
    """(n_labels, proj_dim) text embeddings, one l2-normalized row per label
    in label-set index order (first-seen order, embeddings.go:188-236). Each
    unique label name is encoded exactly once however many images carry it."""
    if not label_set:
        return np.zeros((0, 0), np.float32)
    names = sorted(label_set, key=label_set.__getitem__)
    bank = encoder.encode([template.format(n) for n in names])
    norms = np.linalg.norm(bank, axis=1, keepdims=True)
    return (bank / np.maximum(norms, 1e-8)).astype(np.float32)


def confidence_weights(per_image_labels: list[list[Label]],
                       label_set: dict[str, int]) -> np.ndarray:
    """(n_images, n_labels) mixing weights: each image's labels get their
    detection confidence, rows normalized to sum 1 (a confidence-weighted
    mean, so one 95-confidence label outweighs three 20s). Images with no
    known labels keep an all-zero row; unknown labels are ignored, matching
    the one-hot path (embeddings.go:166-174 semantics)."""
    w = np.zeros((len(per_image_labels), len(label_set)), np.float32)
    for i, labels in enumerate(per_image_labels):
        for label in labels:
            idx = label_set.get(label.name)
            if idx is not None:
                w[i, idx] = max(float(label.confidence), 0.0)
    sums = w.sum(axis=1, keepdims=True)
    return np.divide(w, sums, out=w, where=sums > 0)


def text_label_matrix(per_image_labels: list[list[Label]],
                      label_set: dict[str, int], encoder,
                      template: str = _TEMPLATE) -> np.ndarray:
    """(n_images, proj_dim) dense text-label features: the confidence-
    weighted mean of each image's label embeddings, l2-normalized per row so
    the block's scale is comparable across images (unlabeled rows stay
    zero). ``labels.fusion_weight`` applies downstream exactly as for the
    one-hot block."""
    bank = label_text_bank(label_set, encoder, template)
    if bank.size == 0:
        return np.zeros((len(per_image_labels), 0), np.float32)
    mat = confidence_weights(per_image_labels, label_set) @ bank
    norms = np.linalg.norm(mat, axis=1, keepdims=True)
    return np.divide(mat, norms, out=mat, where=norms > 1e-8)
