"""Label-set construction and one-hot fusion — parity with
internal/embeddings/embeddings.go:166-236, vectorized.

The reference builds the global label set by iterating the image directory
(BuildLabelSet, embeddings.go:188-236: first-seen order indexing), then
one-hot-encodes each image's labels (GenerateLabelVector, :166-174) and
concatenates image-embedding ‖ label-vector (CombineEmbeddings, :177-183).
Here the whole batch fuses as one matrix op.
"""

from __future__ import annotations

import numpy as np

from imageclust_tpu_torch.labels.base import Label

__all__ = ["build_label_set", "label_vector", "one_hot_matrix", "combine_embeddings"]


def build_label_set(per_image_labels: list[list[Label]]) -> dict[str, int]:
    """First-seen-order label -> index map (embeddings.go:188-236 semantics:
    iterate images in order, assign the next index to each new label)."""
    label_set: dict[str, int] = {}
    for labels in per_image_labels:
        for label in labels:
            if label.name not in label_set:
                label_set[label.name] = len(label_set)
    return label_set


def label_vector(labels: list[Label] | list[str], label_set: dict[str, int]) -> np.ndarray:
    """One-hot over the label set (embeddings.go:166-174); unknown labels are
    ignored, matching the reference."""
    v = np.zeros(len(label_set), np.float32)
    for label in labels:
        name = label if isinstance(label, str) else label.name
        idx = label_set.get(name)
        if idx is not None:
            v[idx] = 1.0
    return v


def one_hot_matrix(
    per_image_labels: list[list[Label]], label_set: dict[str, int]
) -> np.ndarray:
    """(n_images, n_labels) one-hot matrix — the batched GenerateLabelVector."""
    out = np.zeros((len(per_image_labels), len(label_set)), np.float32)
    for i, labels in enumerate(per_image_labels):
        for label in labels:
            idx = label_set.get(label.name)
            if idx is not None:
                out[i, idx] = 1.0
    return out


def combine_embeddings(image_emb: np.ndarray, label_mat: np.ndarray) -> np.ndarray:
    """Concat image ‖ label features per row (embeddings.go:177-183)."""
    if label_mat.shape[1] == 0:
        return np.ascontiguousarray(image_emb, dtype=np.float32)
    return np.concatenate(
        [image_emb.astype(np.float32), label_mat.astype(np.float32)], axis=1
    )
