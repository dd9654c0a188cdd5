"""Device-side image preprocessing with OpenCV-parity numerics — the port of
``imageclust_tpu/ops/preprocess.py`` as plain tensor code (the JAX package
left it to XLA; it has no Pallas kernel).

Bilinear resize is separable, so it is ``R @ img @ C^T`` with banded weight
matrices implementing OpenCV's INTER_LINEAR sampling (half-pixel centres,
edge clamp, no antialiasing): two float32 matmuls (TF32 off). Only images
that are not already at the embedder's input size take this path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

__all__ = ["resize_weights", "resize_bilinear", "preprocess_batch"]


@lru_cache(maxsize=256)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear sampling matrix, OpenCV INTER_LINEAR
    convention: src = (dst + 0.5) * (in/out) - 0.5, clamped to the edges."""
    scale = in_size / out_size
    dst = np.arange(out_size, dtype=np.float64)
    src = (dst + 0.5) * scale - 0.5
    x0 = np.floor(src).astype(np.int64)
    frac = src - x0
    x1 = x0 + 1
    # OpenCV clamps source taps to the valid range (border replicate).
    x0c = np.clip(x0, 0, in_size - 1)
    x1c = np.clip(x1, 0, in_size - 1)
    w = np.zeros((out_size, in_size), np.float32)
    rows = np.arange(out_size)
    np.add.at(w, (rows, x0c), (1.0 - frac).astype(np.float32))
    np.add.at(w, (rows, x1c), frac.astype(np.float32))
    return w


def resize_bilinear(images: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Resize a (B, H, W, C) batch to (B, out_h, out_w, C) float32 with
    OpenCV INTER_LINEAR numerics, as two float32 matmuls."""
    _, h, w, _ = images.shape
    dev = images.device
    r = torch.from_numpy(resize_weights(h, out_h)).to(dev)
    cw = torch.from_numpy(resize_weights(w, out_w)).to(dev)
    x = images.to(torch.float32)
    x = torch.einsum("oh,bhwc->bowc", r, x)
    return torch.einsum("ow,bhwc->bhoc", cw, x)


def preprocess_batch(
    images: torch.Tensor,
    *,
    size: int = 224,
    scale: float = 1.0 / 255.0,
    mean: tuple[float, float, float] = (0.0, 0.0, 0.0),
    std: tuple[float, float, float] = (1.0, 1.0, 1.0),
    bgr_to_rgb: bool = True,
    channels_first: bool = True,
) -> torch.Tensor:
    """uint8 (B,H,W,3) BGR -> float32 blob, ``BlobFromImage(rgb, 1/255,
    (224,224))`` semantics by default (embeddings.go:69-96)."""
    x = resize_bilinear(images, size, size)
    if bgr_to_rgb:
        x = x.flip(-1)
    mean_a = torch.tensor(mean, dtype=torch.float32, device=x.device)
    std_a = torch.tensor(std, dtype=torch.float32, device=x.device)
    x = (x * scale - mean_a) / std_a
    if channels_first:
        x = x.permute(0, 3, 1, 2)
    return x
