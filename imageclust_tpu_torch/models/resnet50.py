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
``dense0`` runs in float32. ``forward(..., train=True)`` normalises with
the batch statistics and updates the running ones as Flax does (see
:class:`_BatchNorm`). Convolutions are plain ``F.conv2d`` (cuDNN on
the card): the JAX package left them to XLA, so they are not TPU kernels.

Parameter names follow the Flax tree (``conv0``, ``bn0``,
``stage{s}_block{b}.conv{i}`` ...) so :mod:`.convert` maps one onto the
other by name. :func:`load_onnx_params` reads the reference's own
checkpoint (resnet50-v1-7.onnx, Gluon initializer names) into the same
``state_dict``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["ResNet50V1", "BottleneckV1", "fold_bn_variables",
           "load_onnx_params", "s2d_kernel", "s2d_input",
           "GLUON_STAGE_LAYERS", "STAGE_WIDTHS"]

GLUON_STAGE_LAYERS = (3, 4, 6, 3)
STAGE_WIDTHS = (64, 128, 256, 512)  # bottleneck (inner) widths
_EPS = 1e-5
_MOMENTUM = 0.9  # Flax BatchNorm(momentum=0.9)


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
    """BatchNorm over channel dim 1 with Flax's numerics
    (``nn.BatchNorm(momentum=0.9, epsilon=1e-5)``, ``use_fast_variance``):
    float32 math, output in ``norm_dtype``.

    ``train=False`` normalises with the running statistics. ``train=True``
    normalises with the batch's: ``mean = E[x]`` and the biased ``var =
    max(E[x^2] - mean^2, 0)`` over N, H and W in float32, and moves the
    running statistics to ``0.9 * running + 0.1 * batch`` outside
    autograd. ``F.batch_norm(training=True)`` would put the unbiased
    variance into the running buffer.

    ``stat_sum``, when set (the sharded train step sets it for the length
    of a step), takes the (2, C) float32 sums of x and x^2 over this
    rank's N, H and W and the element count, and returns the sums and
    count of the whole (global) batch, differentiably: the mean and the
    biased variance are then those of the global batch, as the JAX step's
    are (it normalises over the batch that the mesh shards)."""

    stat_sum = None

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, norm_dtype: torch.dtype,
                train: bool = False) -> torch.Tensor:
        shape = (1, -1, 1, 1)
        xf = x.float()
        if train and self.stat_sum is not None:
            sums, count = self.stat_sum(torch.stack(
                [xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))]),
                xf.shape[0] * xf.shape[2] * xf.shape[3])
            mean = sums[0] / count
            var = torch.clamp_min(sums[1] / count - mean * mean, 0.0)
        elif train:
            mean = xf.mean(dim=(0, 2, 3))
            var = torch.clamp_min(
                (xf * xf).mean(dim=(0, 2, 3)) - mean * mean, 0.0)
        if train:
            with torch.no_grad():
                self.running_mean.copy_(
                    _MOMENTUM * self.running_mean + (1 - _MOMENTUM) * mean)
                self.running_var.copy_(
                    _MOMENTUM * self.running_var + (1 - _MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + _EPS) * self.weight
        y = (xf - mean.view(shape)) * mul.view(shape)
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

    def _bn(self, name: str, y, norm_dtype, train: bool):
        return (y if self.fold_bn
                else getattr(self, name)(y, norm_dtype, train))

    def forward(self, x, dtype, norm_dtype, train: bool = False):
        y = self._bn("bn0", self.conv0(x, dtype), norm_dtype, train).relu()
        y = self._bn("bn1", self.conv1(y, dtype), norm_dtype, train).relu()
        y = self._bn("bn2", self.conv2(y, dtype), norm_dtype, train)
        if self.conv_proj is not None:
            x = self._bn("bn_proj", self.conv_proj(x, dtype), norm_dtype,
                         train)
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

    def _stem_s2d(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.conv0.bias is None else self.conv0.bias.to(self.dtype)
        return F.conv2d(s2d_input(x, self.dtype),
                        s2d_kernel(self.conv0.weight, self.dtype), bias)

    def _stem_standard(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] != 3:  # NHWC -> NCHW (the JAX module accepts both)
            x = x.permute(0, 3, 1, 2)
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        return self.conv0(x, self.dtype)

    # -- forward ---------------------------------------------------------------

    def forward(self, x: torch.Tensor, return_features: bool = False,
                stem_mode: str | None = None, train: bool = False):
        """Logits (and the pooled features with ``return_features``).
        ``train=True`` normalises with batch statistics and updates the
        running ones (JAX resnet50.py:130-190); it needs BatchNorm, so the
        folded layout raises."""
        if train and self.fold_bn:
            raise ValueError("fold_bn is an inference layout; train needs BN")
        mode = stem_mode or self.stem_mode
        if mode == "s2d_raw":
            x = self._stem_s2d(x)
        elif mode == "standard":
            x = self._stem_standard(x)
        else:
            raise ValueError(f"unknown stem_mode {mode!r}")
        if not self.fold_bn:
            x = self.bn0(x, self.norm_dtype, train)
        x = F.max_pool2d(x.relu(), 3, 2, padding=1)  # -inf padding, as JAX
        for si, n_blocks in enumerate(self.stage_layers):
            for bi in range(n_blocks):
                x = getattr(self, f"stage{si + 1}_block{bi}")(
                    x, self.dtype, self.norm_dtype, train)
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


def s2d_kernel(w7: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(64, 12, 4, 4) OIHW kernel in ``dtype`` equivalent to the (64, 3, 7,
    7) stem kernel ``w7`` (7x7/2) over the BGR uint8 2x2 space-to-depth
    input, with the 1/255 scale and the BGR->RGB flip folded in (JAX
    resnet50.py:139-155). Derived from ``w7`` at every call, so no copy
    outlives a weight load."""
    w7 = w7.permute(2, 3, 1, 0)  # OIHW -> HWIO (7,7,3,64)
    w8 = w7.new_zeros((8, 8, 3, 64))
    w8[1:8, 1:8] = w7
    parts = [w8[p::2, q::2, 2 - c, :]
             for p in (0, 1) for q in (0, 1) for c in (0, 1, 2)]
    w12 = torch.stack(parts, dim=2) * (1.0 / 255.0)  # (4,4,12,64) HWIO
    return w12.to(dtype).permute(3, 2, 0, 1).contiguous()


def s2d_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Raw NHWC (B, H, W, 3) -> the padded (B, 12, H/2 + 3, W/2 + 3) 2x2
    space-to-depth batch in ``dtype`` (channels_last) that
    :func:`s2d_kernel`'s 4x4/1 convolution takes."""
    if (x.dim() != 4 or x.shape[-1] != 3 or x.shape[1] % 2
            or x.shape[2] % 2):
        raise ValueError(
            f"s2d_raw stem needs raw NHWC (B,H,W,3) with even H/W, "
            f"got {tuple(x.shape)}")
    b, h, w, _ = x.shape
    xs = x.reshape(b, h // 2, 2, w // 2, 2, 3)
    # channel index p*6 + q*3 + c, as the JAX transpose/reshape builds it
    xs = xs.permute(0, 2, 4, 5, 1, 3).reshape(b, 12, h // 2, w // 2)
    xs = xs.to(dtype).contiguous(memory_format=torch.channels_last)
    return F.pad(xs, (2, 1, 2, 1))  # JAX padding ((2, 1), (2, 1))


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


# -- ONNX ingestion (resnet50-v1-7.onnx, Gluon names) --------------------------

def _gluon_name_map(stage_layers: Sequence[int] = GLUON_STAGE_LAYERS):
    """Map Gluon-ONNX initializer names (``resnetv17_*``) to Flax tree paths
    (JAX resnet50.py:235-270).

    Gluon numbers convs/batchnorms in creation order within each stage
    scope: per block the 3 body convs first, then the projection conv of
    the first block (BottleneckV1 creates body before downsample)."""
    m: dict[str, tuple[str, ...]] = {}

    def conv(onnx, *path):
        m[f"{onnx}_weight"] = (*path, "kernel")

    def bnorm(onnx, *path):
        m[f"{onnx}_gamma"] = ("params_scale", *path, "scale")
        m[f"{onnx}_beta"] = ("params_bias", *path, "bias")
        m[f"{onnx}_running_mean"] = ("stats_mean", *path, "mean")
        m[f"{onnx}_running_var"] = ("stats_var", *path, "var")

    conv("resnetv17_conv0", "conv0")
    bnorm("resnetv17_batchnorm0", "bn0")
    for si, n_blocks in enumerate(stage_layers):
        stage = f"resnetv17_stage{si + 1}"
        k = 0
        for bi in range(n_blocks):
            blk = f"stage{si + 1}_block{bi}"
            for ci in range(3):
                conv(f"{stage}_conv{k}", blk, f"conv{ci}")
                bnorm(f"{stage}_batchnorm{k}", blk, f"bn{ci}")
                k += 1
            if bi == 0:
                conv(f"{stage}_conv{k}", blk, "conv_proj")
                bnorm(f"{stage}_batchnorm{k}", blk, "bn_proj")
                k += 1
    m["resnetv17_dense0_weight"] = ("dense0", "kernel")
    m["resnetv17_dense0_bias"] = ("dense0", "bias")
    return m


def _set_path(tree: dict, path: tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _flax_shapes(model: ResNet50V1) -> tuple[dict, dict]:
    """The Flax ``params`` and ``batch_stats`` shape trees of ``model``
    (HWIO conv kernels, (in, out) dense kernel): the structure the JAX
    loader validates against."""
    params: dict = {}
    stats: dict = {}
    for name, mod in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(mod, _Conv):
            o, i, kh, kw = mod.weight.shape
            _set_path(params, (*path, "kernel"), (kh, kw, i, o))
            if mod.bias is not None:
                _set_path(params, (*path, "bias"), tuple(mod.bias.shape))
        elif isinstance(mod, _BatchNorm):
            c = (mod.weight.shape[0],)
            _set_path(params, (*path, "scale"), c)
            _set_path(params, (*path, "bias"), c)
            _set_path(stats, (*path, "mean"), c)
            _set_path(stats, (*path, "var"), c)
    o, i = model.dense0.weight.shape
    params["dense0"] = {"kernel": (i, o), "bias": (o,)}
    return params, stats


def _shape_diff(ref, got, prefix: str) -> list[str]:
    """Every missing, unexpected or mis-shaped leaf of ``got`` against the
    shape tree ``ref`` (JAX resnet50.py:330-344)."""
    out = []
    if isinstance(ref, dict):
        for k in ref:
            if not isinstance(got, dict) or k not in got:
                out.append(f"{prefix}/{k}: missing")
            else:
                out += _shape_diff(ref[k], got[k], f"{prefix}/{k}")
        if isinstance(got, dict):
            for k in got:
                if k not in ref:
                    out.append(f"{prefix}/{k}: unexpected")
    elif tuple(ref) != got.shape:
        out.append(f"{prefix}: shape {got.shape} != expected {tuple(ref)}")
    return out


def load_onnx_params(onnx_path: str,
                     model: ResNet50V1) -> dict[str, torch.Tensor]:
    """Ingest resnet50-v1-7.onnx weights (Gluon initializer names) as a
    ``state_dict`` for ``model``, an unfolded :class:`ResNet50V1` whose
    structure and shapes validate the file (JAX resnet50.py:280-327).

    The initializers go into a Flax-layout tree (conv OIHW -> HWIO, dense
    (out, in) -> (in, out)), which is held against ``model``'s Flax shapes
    as the JAX loader holds it against its init, then into torch's layout
    through :func:`~.convert.resnet50_state_dict_from_flax`: both layout
    changes are transposes, so the values keep their bits. Raises
    ValueError listing every missing or mis-shaped tensor, in the JAX
    loader's words."""
    from imageclust_tpu_torch.models.convert import (
        resnet50_state_dict_from_flax,
    )
    from imageclust_tpu_torch.models.onnx_io import read_onnx_initializers

    tensors = read_onnx_initializers(onnx_path)
    params: dict = {}
    stats: dict = {}
    problems: list[str] = []
    for onnx_name, path in _gluon_name_map(model.stage_layers).items():
        if onnx_name not in tensors:
            problems.append(f"missing initializer: {onnx_name}")
            continue
        arr = tensors[onnx_name]
        if path[0] in ("params_scale", "params_bias"):
            _set_path(params, path[1:], arr)
        elif path[0] in ("stats_mean", "stats_var"):
            _set_path(stats, path[1:], arr)
        elif path[-1] == "kernel" and arr.ndim == 4:
            _set_path(params, path, np.transpose(arr, (2, 3, 1, 0)))
        elif path[-1] == "kernel" and arr.ndim == 2:
            _set_path(params, path, arr.T)
        else:
            _set_path(params, path, arr)
    ref_params, ref_stats = _flax_shapes(model)
    problems += _shape_diff(ref_params, params, "params")
    problems += _shape_diff(ref_stats, stats, "batch_stats")
    if problems:
        raise ValueError(
            "ONNX->Flax conversion failed:\n  " + "\n  ".join(problems[:40]))
    return resnet50_state_dict_from_flax(
        {"params": params, "batch_stats": stats},
        stage_layers=model.stage_layers, num_classes=model.num_classes,
        fold_bn=False)
