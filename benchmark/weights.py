"""Seeded weights in the published layout, made on the card.

One ``torch.randn`` call over every parameter of the tower, on the device
and from a ``torch.Generator`` seeded from ``--seed``, then each tensor
scaled in place by its kind: convolution and linear weights to variance
1/fan_in, biases small, BatchNorm and LayerNorm affines near identity,
running variances positive. Float32, the type the program keeps its
parameters in (it casts them at use).
"""

from __future__ import annotations

import hashlib
import math

import torch


def mix(*parts) -> int:
    """A 60-bit seed from any sequence of ints and strings."""
    h = hashlib.sha256(repr(parts).encode()).hexdigest()
    return int(h[:15], 16)


def _scale(v: torch.Tensor, shape: tuple, kind: str) -> None:
    if kind in ("conv", "linear"):
        v.mul_(1.0 / math.sqrt(math.prod(shape[1:])))
    elif kind in ("bias", "ln_bias", "embedding"):
        v.mul_(0.02)
    elif kind in ("bn_beta", "bn_mean"):
        v.mul_(0.1)
    elif kind in ("bn_gamma", "ln_weight"):
        v.mul_(0.1).add_(1.0)
    elif kind == "bn_var":
        v.mul_(0.2).exp_()
    else:
        raise ValueError(f"unknown parameter kind {kind!r}")


@torch.no_grad()
def make(initializers: list[tuple[str, tuple, str]], seed: int,
         device) -> dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for every (name, shape, kind)
    of a reference's ``initializers``; views of one flat buffer."""
    total = sum(math.prod(shape) for _, shape, _ in initializers)
    gen = torch.Generator(device=device).manual_seed(mix(seed, "weights"))
    flat = torch.randn(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape, kind in initializers:
        n = math.prod(shape)
        v = flat[off:off + n].view(shape)
        _scale(v, shape, kind)
        out[name] = v
        off += n
    return out
