"""Plain float32 ResNet50-v1: resnet50-v1-7 of the ONNX model zoo.

The network as published (Gluon ``resnet50_v1``, exported to ONNX opset 7):
a 7x7/2 stem convolution, BatchNorm, ReLU and a 3x3/2 max pool, four stages
of ``BottleneckV1`` blocks (3, 4, 6, 3; inner widths 64, 128, 256, 512,
expansion 4; the stride on the first 1x1 convolution of a stage's first
block, a 1x1 projection on that block's shortcut), a global average pool
and a 1000-way dense layer whose logits are the system's embedding.
BatchNorm runs on its running statistics with epsilon 1e-5.

Weights are a dict keyed by the file's own initializer names
(``resnetv17_conv0_weight``, ``resnetv17_stage1_batchnorm0_gamma``, ...),
convolutions OIHW and the dense weight (out, in), as the file stores them.
The input is the system's: BGR uint8 images at 224 px, flipped to RGB and
scaled by 1/255 with no mean or standard deviation (the service feeds the
network that way).

Plain torch operations only, no kernel of the program, and TF32 off while
it runs (:func:`embed`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import no_tf32

STAGES = ((3, 64), (4, 128), (6, 256), (3, 512))
EXPANSION = 4
EPS = 1e-5
PREFIX = "resnetv17"


@dataclass(frozen=True)
class Shape:
    image_size: int
    num_classes: int


def shape_of(config: dict) -> Shape:
    """The network's sizes from a configuration file's keys."""
    return Shape(int(config["image_size"]), int(config["num_classes"]))


def initializers(s: Shape) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every initializer of the published file, in
    the order Gluon creates them: within a stage, a block's three body
    convolutions and then, in the stage's first block, the projection."""
    out: list[tuple[str, tuple, str]] = []

    def conv(name, cout, cin, k):
        out.append((f"{name}_weight", (cout, cin, k, k), "conv"))

    def bnorm(name, c):
        for leaf, kind in (("gamma", "bn_gamma"), ("beta", "bn_beta"),
                           ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out.append((f"{name}_{leaf}", (c,), kind))

    conv(f"{PREFIX}_conv0", 64, 3, 7)
    bnorm(f"{PREFIX}_batchnorm0", 64)
    cin = 64
    for si, (blocks, width) in enumerate(STAGES, 1):
        p = f"{PREFIX}_stage{si}_"
        k = 0
        for b in range(blocks):
            for cout, ci, ks in ((width, cin, 1), (width, width, 3),
                                 (width * EXPANSION, width, 1)):
                conv(f"{p}conv{k}", cout, ci, ks)
                bnorm(f"{p}batchnorm{k}", cout)
                k += 1
            if b == 0:
                conv(f"{p}conv{k}", width * EXPANSION, cin, 1)
                bnorm(f"{p}batchnorm{k}", width * EXPANSION)
                k += 1
            cin = width * EXPANSION
    out.append((f"{PREFIX}_dense0_weight", (s.num_classes, cin), "linear"))
    out.append((f"{PREFIX}_dense0_bias", (s.num_classes,), "bias"))
    return out


def flops_per_image(s: Shape) -> int:
    """Operations of one image's forward from the published shapes: every
    convolution and the dense layer, a multiply-add counting 2 (BatchNorm,
    ReLU, pooling and the residual adds left out, as a FLOP counter of
    products leaves them out)."""
    flops = 0

    def conv(hw_out, cout, cin, k):
        nonlocal flops
        flops += 2 * hw_out * hw_out * cout * cin * k * k

    hw = s.image_size // 2
    conv(hw, 64, 3, 7)
    hw //= 2  # the max pool
    cin = 64
    for si, (blocks, width) in enumerate(STAGES):
        for b in range(blocks):
            out_hw = hw // 2 if (b == 0 and si > 0) else hw
            conv(out_hw, width, cin, 1)
            conv(out_hw, width, width, 3)
            conv(out_hw, width * EXPANSION, width, 1)
            if b == 0:
                conv(out_hw, width * EXPANSION, cin, 1)
            hw, cin = out_hw, width * EXPANSION
    return flops + 2 * cin * s.num_classes


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (B, H, W, 3) -> RGB float32 (B, 3, H, W) in [0, 1]."""
    return images.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0


def forward(w: dict[str, torch.Tensor], s: Shape,
            x: torch.Tensor) -> torch.Tensor:
    """Logits (B, num_classes) of a float32 RGB batch (B, 3, S, S)."""

    def bn(y, name):
        return F.batch_norm(y, w[f"{name}_running_mean"],
                            w[f"{name}_running_var"], w[f"{name}_gamma"],
                            w[f"{name}_beta"], False, 0.0, EPS)

    y = F.conv2d(x, w[f"{PREFIX}_conv0_weight"], stride=2, padding=3)
    y = F.max_pool2d(F.relu(bn(y, f"{PREFIX}_batchnorm0")), 3, 2, 1)
    for si, (blocks, _width) in enumerate(STAGES, 1):
        p = f"{PREFIX}_stage{si}_"
        k = 0
        for b in range(blocks):
            stride = 2 if (b == 0 and si > 1) else 1
            h = F.conv2d(y, w[f"{p}conv{k}_weight"], stride=stride)
            h = F.relu(bn(h, f"{p}batchnorm{k}"))
            h = F.conv2d(h, w[f"{p}conv{k + 1}_weight"], padding=1)
            h = F.relu(bn(h, f"{p}batchnorm{k + 1}"))
            h = bn(F.conv2d(h, w[f"{p}conv{k + 2}_weight"]),
                   f"{p}batchnorm{k + 2}")
            k += 3
            if b == 0:
                y = bn(F.conv2d(y, w[f"{p}conv{k}_weight"], stride=stride),
                       f"{p}batchnorm{k}")
                k += 1
            y = F.relu(h + y)
    pooled = y.mean(dim=(2, 3))
    return F.linear(pooled, w[f"{PREFIX}_dense0_weight"],
                    w[f"{PREFIX}_dense0_bias"])


@torch.no_grad()
def embed(w: dict[str, torch.Tensor], s: Shape, images: torch.Tensor,
          block: int = 256) -> torch.Tensor:
    """Float32 embeddings of BGR uint8 images, ``block`` rows at a time."""
    with no_tf32():
        return torch.cat([forward(w, s, preprocess(images[i:i + block]))
                          for i in range(0, images.shape[0], block)])

