"""ResNet50-v1 in PyTorch, architecture- and numerics-matched to the JAX
package's Flax tower (``imageclust_tpu/models/resnet50.py``), which in turn
matches resnet50-v1-7.onnx (Gluon ``BottleneckV1``: stride on the first 1x1
conv).

Layout: the public input stays the JAX package's — raw BGR uint8 NHWC for
the ``s2d_raw`` stem, float NCHW or NHWC for the standard stem. Inside, the
module runs NCHW tensors in ``torch.channels_last`` memory format.

Cast points mirror the Flax module so the bf16 tower stays close to the JAX
one: convolutions take their input and kernel in ``dtype``; BatchNorm
(running statistics, eps 1e-5) computes in float32 and returns
``norm_dtype`` (Flax's ``_normalize`` promotion); the residual is added in
the body's dtype; the pooled mean is taken in float32, rounded to the
activation dtype (``jnp.mean`` of a bf16 array) and returned as float32;
``dense0`` runs in float32. Convolutions are plain ``F.conv2d`` (cuDNN on
the card): the JAX package left them to XLA, so they are not TPU kernels.

Parameter names follow the Flax tree (``conv0``, ``bn0``,
``stage{s}_block{b}.conv{i}`` ...) so :mod:`.convert` maps one onto the
other by name.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNet50V1", "BottleneckV1", "fold_bn_variables",
           "GLUON_STAGE_LAYERS", "STAGE_WIDTHS"]

GLUON_STAGE_LAYERS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)  # bottleneck (inner) widths
_EPS = 1e-5


class _Conv(nn.Module):
    """A bias-optional conv whose weight is kept in float32 (Flax
    ``param_dtype``) and cast to the compute dtype at use."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 padding: int = 0, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride = stride
        self.padding = padding

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(dtype)
        return F.conv2d(x.to(dtype), self.weight.to(dtype), b,
                        stride=self.stride, padding=self.padding)


class _BatchNorm(nn.Module):
    """Inference BatchNorm over channel dim 1: float32 math, output in
    ``norm_dtype`` (Flax ``nn.BatchNorm(use_running_average=True)``)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, norm_dtype: torch.dtype) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        mul = torch.rsqrt(self.running_var + _EPS) * self.weight
        y = (x.float() - self.running_mean.view(shape)) * mul.view(shape)
        return (y + self.bias.view(shape)).to(norm_dtype)


class BottleneckV1(nn.Module):
    """Gluon BottleneckV1 (JAX resnet50.py:37-81). ``fold_bn=True`` is the
    inference layout: every conv has a bias and no BatchNorm."""

    def __init__(self, cin: int, width: int, stride: int, project: bool,
                 fold_bn: bool = False):
        super().__init__()
        out_ch = width * 4
        self.fold_bn = fold_bn
        self.conv0 = _Conv(cin, width, 1, stride, bias=fold_bn)
        self.conv1 = _Conv(width, width, 3, 1, padding=1, bias=fold_bn)
        self.conv2 = _Conv(width, out_ch, 1, bias=fold_bn)
        self.conv_proj = (_Conv(cin, out_ch, 1, stride, bias=fold_bn)
                          if project else None)
        if not fold_bn:
            self.bn0 = _BatchNorm(width)
            self.bn1 = _BatchNorm(width)
            self.bn2 = _BatchNorm(out_ch)
            self.bn_proj = _BatchNorm(out_ch) if project else None

    def _bn(self, name: str, y, norm_dtype):
        return y if self.fold_bn else getattr(self, name)(y, norm_dtype)

    def forward(self, x, dtype, norm_dtype):
        y = self._bn("bn0", self.conv0(x, dtype), norm_dtype).relu()
        y = self._bn("bn1", self.conv1(y, dtype), norm_dtype).relu()
        y = self._bn("bn2", self.conv2(y, dtype), norm_dtype)
        if self.conv_proj is not None:
            x = self._bn("bn_proj", self.conv_proj(x, dtype), norm_dtype)
        return (y + x.to(y.dtype)).relu()


def _dt(name) -> torch.dtype:
    if isinstance(name, torch.dtype):
        return name
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


class ResNet50V1(nn.Module):
    """Batched ResNet50 v1 (JAX resnet50.py:100-190).

    ``stem_mode="s2d_raw"`` takes RAW BGR uint8 NHWC: the batch is
    space-to-depth'd 2x2 to 12 channels and conv0's 7x7/2 kernel is
    rewritten into the equivalent 4x4/1 kernel with the 1/255 scale and the
    BGR->RGB flip folded in (JAX resnet50.py:139-155). The same weights
    serve both stems; ``forward(..., stem_mode=...)`` overrides per call.
    """

    def __init__(self, num_classes: int = 1000, dtype="bfloat16",
                 stage_layers: Sequence[int] = GLUON_STAGE_LAYERS,
                 norm_dtype="float32", fold_bn: bool = False,
                 stem_mode: str = "standard"):
        super().__init__()
        if stem_mode not in ("standard", "s2d_raw"):
            raise ValueError(f"unknown stem_mode {stem_mode!r}")
        self.dtype = _dt(dtype)
        self.norm_dtype = _dt(norm_dtype)
        self.stage_layers = tuple(stage_layers)
        self.fold_bn = fold_bn
        self.stem_mode = stem_mode
        self.num_classes = num_classes
        self.conv0 = _Conv(3, 64, 7, 2, padding=3, bias=fold_bn)
        if not fold_bn:
            self.bn0 = _BatchNorm(64)
        cin = 64
        for si, (n_blocks, width) in enumerate(
                zip(self.stage_layers, STAGE_WIDTHS)):
            for bi in range(n_blocks):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                self.add_module(
                    f"stage{si + 1}_block{bi}",
                    BottleneckV1(cin, width, stride, bi == 0, fold_bn))
                cin = width * 4
        self.dense0 = nn.Linear(cin, num_classes)

    # -- stems ---------------------------------------------------------------

    def _s2d_kernel(self) -> torch.Tensor:
        """(64, 12, 4, 4) OIHW kernel in ``dtype`` equivalent to conv0's
        7x7/2 over the BGR uint8 2x2 space-to-depth input."""
        w7 = self.conv0.weight.permute(2, 3, 1, 0)  # OIHW -> HWIO (7,7,3,64)
        w8 = w7.new_zeros((8, 8, 3, 64))
        w8[1:8, 1:8] = w7
        parts = [w8[p::2, q::2, 2 - c, :]
                 for p in (0, 1) for q in (0, 1) for c in (0, 1, 2)]
        w12 = torch.stack(parts, dim=2) * (1.0 / 255.0)  # (4,4,12,64) HWIO
        return w12.to(self.dtype).permute(3, 2, 0, 1).contiguous()

    def _stem_s2d(self, x: torch.Tensor) -> torch.Tensor:
        if (x.dim() != 4 or x.shape[-1] != 3 or x.shape[1] % 2
                or x.shape[2] % 2):
            raise ValueError(
                f"s2d_raw stem needs raw NHWC (B,H,W,3) with even H/W, "
                f"got {tuple(x.shape)}")
        b, h, w, _ = x.shape
        xs = x.reshape(b, h // 2, 2, w // 2, 2, 3)
        # channel index p*6 + q*3 + c, as the JAX transpose/reshape builds it
        xs = xs.permute(0, 2, 4, 5, 1, 3).reshape(b, 12, h // 2, w // 2)
        xs = xs.to(self.dtype).contiguous(memory_format=torch.channels_last)
        xs = F.pad(xs, (2, 1, 2, 1))  # JAX padding ((2, 1), (2, 1))
        bias = None if self.conv0.bias is None else self.conv0.bias.to(self.dtype)
        return F.conv2d(xs, self._s2d_kernel(), bias)

    def _stem_standard(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 3:  # NHWC -> NCHW (the JAX module accepts both)
            x = x.permute(0, 3, 1, 2)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return self.conv0(x, self.dtype)

    # -- forward ---------------------------------------------------------------

    def forward(self, x: torch.Tensor, return_features: bool = False,
                stem_mode: str | None = None):
        mode = stem_mode or self.stem_mode
        if mode == "s2d_raw":
            x = self._stem_s2d(x)
        elif mode == "standard":
            x = self._stem_standard(x)
        else:
            raise ValueError(f"unknown stem_mode {mode!r}")
        if not self.fold_bn:
            x = self.bn0(x, self.norm_dtype)
        x = F.max_pool2d(x.relu(), 3, 2, padding=1)  # -inf padding, as JAX
        for si, n_blocks in enumerate(self.stage_layers):
            for bi in range(n_blocks):
                x = getattr(self, f"stage{si + 1}_block{bi}")(
                    x, self.dtype, self.norm_dtype)
        # jnp.mean of the activation: f32 accumulation, result in its dtype
        pooled = x.float().mean(dim=(2, 3)).to(x.dtype).float()
        logits = F.linear(pooled, self.dense0.weight, self.dense0.bias)
        if return_features:
            return logits, pooled
        return logits

    # -- random init -------------------------------------------------------------

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "ResNet50V1":
        """Seeded init with Flax's initializer families: lecun_normal
        (truncated normal, fan-in) kernels, zero biases, BatchNorm scale 1 /
        shift 0 / mean 0 / var 1. A ``torch.Generator`` gives different
        numbers from ``jax.random`` for the same seed."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, _Conv):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _BatchNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                mod.running_mean.zero_()
                mod.running_var.fill_(1.0)
        _lecun_normal_(self.dense0.weight, self.dense0.in_features, gen)
        self.dense0.bias.zero_()
        return self


def _lecun_normal_(w: torch.Tensor, fan_in: int, gen: torch.Generator):
    """jax.nn.initializers.lecun_normal: truncated normal on [-2, 2]
    rescaled so the variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    tmp = torch.empty(w.shape, dtype=torch.float32)
    nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w.copy_(tmp * std)


@torch.no_grad()
def fold_bn_variables(model: ResNet50V1) -> ResNet50V1:
    """Fold every BatchNorm affine into its preceding conv (JAX
    resnet50.py:193-232): W' = W*g/sqrt(v+eps), b' = b - g*m/sqrt(v+eps),
    computed in float64 so the float32 weights round once. Returns a new
    ``fold_bn=True`` module on the same device."""
    folded = ResNet50V1(model.num_classes, model.dtype, model.stage_layers,
                        model.norm_dtype, fold_bn=True,
                        stem_mode=model.stem_mode)
    src = dict(model.named_modules())
    for name, conv in folded.named_modules():
        if not isinstance(conv, _Conv):
            continue
        prefix, _, cname = name.rpartition(".")
        bn_name = "bn0" if cname == "conv0" else cname.replace("conv", "bn")
        w = src[name].weight.double()
        bn = src[f"{prefix}.{bn_name}" if prefix else bn_name]
        inv = bn.weight.double() / torch.sqrt(bn.running_var.double() + _EPS)
        conv.weight.copy_((w * inv.view(-1, 1, 1, 1)).float())
        conv.bias.copy_((bn.bias.double()
                         - bn.running_mean.double() * inv).float())
    folded.dense0.load_state_dict(model.dense0.state_dict())
    return folded.to(model.dense0.weight.device)
