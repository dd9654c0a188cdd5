"""Post-training int8 quantization of the ResNet50 tower (serving only), the
counterpart of ``imageclust_tpu/models/quantize.py``.

* weights: symmetric per-output-channel int8, scale = absmax / 127 of the
  BN-FOLDED float32 kernel (:func:`~.resnet50.fold_bn_variables`, in
  float64 as the JAX package computes it with numpy);
* activations: symmetric per-tensor int8, the scale calibrated from one
  float32 forward over a calibration batch (absmax or the 99.9th
  percentile of each body conv's input, times a margin);
* every bottleneck conv runs as an int8 product with exact int32
  accumulation (:func:`~imageclust_tpu_torch.ops.int8.int8_conv2d`), then
  ``y * (sx * w_scale) + bias`` in float32 (the product of the scales
  formed first, as in JAX), bf16 activations between layers;
* the 7x7 stem and the dense head stay float (the raw-uint8 s2d stem is
  taken for a uint8 batch, as JAX ``quant_apply`` dispatches on dtype).

Activations run NHWC (the int8 im2col's layout); the stem runs NCHW in
``channels_last`` memory, which is the same bytes. Buffer names follow the
JAX qparams tree (``stage{s}_block{b}.conv{i}.kernel_q`` ...), with the
int8 kernel stored OHWI so that its (kh * kw * cin, cout) matrix view is
column-major, the layout cuBLASLt's int8 GEMM takes.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imageclust_tpu_torch.models.resnet50 import (
    GLUON_STAGE_LAYERS,
    STAGE_WIDTHS,
    ResNet50V1,
    _Conv,
    _dt,
    fold_bn_variables,
    s2d_input,
    s2d_kernel,
)
from imageclust_tpu_torch.ops.int8 import int8_conv2d, quantize_act

__all__ = ["QuantResNet50", "quantize_resnet50", "abs_stats", "quantile"]

_EPS = 1e-12
_BODY = ("conv0", "conv1", "conv2", "conv_proj")


def quantile(flat: torch.Tensor, q: float) -> float:
    """``jnp.quantile(flat, q)`` (method "linear") of a 1-D float32 tensor,
    for any size (``torch.quantile`` refuses more than 2^24 elements): the
    position ``q * (n - 1)`` and the interpolation weights in float32, as
    JAX forms them, the two order statistics by ``torch.kthvalue``."""
    n = flat.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1))
    lo, hi = np.floor(pos), np.ceil(pos)
    w_hi = np.float32(pos - lo)
    w_lo = np.float32(1) - w_hi
    lo_i = int(min(max(lo, 0), n - 1))
    hi_i = int(min(max(hi, 0), n - 1))
    v_lo = flat.kthvalue(lo_i + 1).values
    v_hi = v_lo if hi_i == lo_i else flat.kthvalue(hi_i + 1).values
    return float(np.float32(v_lo.item()) * w_lo
                 + np.float32(v_hi.item()) * w_hi)


def abs_stats(x: torch.Tensor) -> tuple[float, float]:
    """(absmax, 99.9th percentile) of ``|x|`` in float32: the two
    calibration statistics JAX captures per quantized input."""
    ax = x.float().abs().flatten()
    return float(ax.max()), quantile(ax, 0.999)


class _QConv(nn.Module):
    """An int8 conv (JAX ``_qconv``): quantize the NHWC input with the
    calibrated ``act_scale``, int32 product, per-channel dequantize and
    bias in float32, result in the activation dtype."""

    def __init__(self, cin: int, cout: int, k: int, stride: int, pad: int):
        super().__init__()
        self.stride = stride
        self.pad = pad
        self.register_buffer("kernel_q",
                             torch.zeros(cout, k, k, cin, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(cout))
        self.register_buffer("bias", torch.zeros(cout))
        self.register_buffer("act_scale", torch.ones(()))

    def forward(self, x: torch.Tensor, act_dtype: torch.dtype):
        sx = self.act_scale
        y = int8_conv2d(quantize_act(x, sx), self.kernel_q, self.stride,
                        self.pad)
        y = y.float() * (sx * self.w_scale) + self.bias
        return y.to(act_dtype)


class _QBlock(nn.Module):
    """Gluon BottleneckV1 with int8 convs (stride on the first 1x1)."""

    def __init__(self, cin: int, width: int, stride: int, project: bool):
        super().__init__()
        out_ch = width * 4
        self.conv0 = _QConv(cin, width, 1, stride, 0)
        self.conv1 = _QConv(width, width, 3, 1, 1)
        self.conv2 = _QConv(width, out_ch, 1, 1, 0)
        self.conv_proj = (_QConv(cin, out_ch, 1, stride, 0) if project
                          else None)

    def forward(self, x, dt):
        y = self.conv0(x, dt).relu()
        y = self.conv1(y, dt).relu()
        y = self.conv2(y, dt)
        if self.conv_proj is not None:
            x = self.conv_proj(x, dt)
        return (y + x).relu()


class QuantResNet50(nn.Module):
    """The int8 ResNet50 (JAX ``quant_apply``). Input: a normalized float
    batch, NHWC or NCHW (NCHW only when ``shape[1] == 3`` and the last axis
    is not 3, as JAX decides), or a raw BGR uint8 NHWC batch for the s2d
    stem. Returns the float32 logits, and with ``return_features`` also the
    float32 pooled features. ``stem_mode`` is the stem the embedder feeds
    raw uint8 batches to (``"s2d_raw"``) or not (``"standard"``)."""

    def __init__(self, num_classes: int = 1000,
                 stage_layers: Sequence[int] = GLUON_STAGE_LAYERS,
                 act_dtype="bfloat16", stem_mode: str = "s2d_raw"):
        super().__init__()
        self.num_classes = num_classes
        self.stage_layers = tuple(stage_layers)
        self.act_dtype = _dt(act_dtype)
        self.stem_mode = stem_mode
        self.conv0 = _Conv(3, 64, 7, 2, padding=3, bias=True)
        cin = 64
        for si, (n_blocks, width) in enumerate(
                zip(self.stage_layers, STAGE_WIDTHS)):
            for bi in range(n_blocks):
                stride = (1 if si == 0 else 2) if bi == 0 else 1
                self.add_module(f"stage{si + 1}_block{bi}",
                                _QBlock(cin, width, stride, bi == 0))
                cin = width * 4
        self.dense0 = nn.Linear(cin, num_classes)

    def forward(self, x: torch.Tensor, return_features: bool = False,
                stem_mode: str | None = None):
        dt = self.act_dtype
        if (stem_mode or ("s2d_raw" if x.dtype == torch.uint8
                          else "standard")) == "s2d_raw":
            x = F.conv2d(s2d_input(x, dt), s2d_kernel(self.conv0.weight, dt),
                         self.conv0.bias.to(dt))
        else:
            if not (x.shape[1] == 3 and x.shape[-1] != 3):  # NHWC -> NCHW
                x = x.permute(0, 3, 1, 2)
            x = self.conv0(
                x.to(dt).contiguous(memory_format=torch.channels_last), dt)
        x = F.max_pool2d(x.relu(), 3, 2, padding=1)  # -inf padding, as JAX
        x = x.permute(0, 2, 3, 1).contiguous()  # NHWC for the int8 convs
        for si, n_blocks in enumerate(self.stage_layers):
            for bi in range(n_blocks):
                x = getattr(self, f"stage{si + 1}_block{bi}")(x, dt)
        # jnp.mean of the activation: f32 accumulation, result in its dtype
        pooled = x.float().mean(dim=(1, 2)).to(x.dtype).float()
        logits = F.linear(pooled, self.dense0.weight, self.dense0.bias)
        if return_features:
            return logits, pooled
        return logits


def _quantize_weight(w: torch.Tensor, reduce_dims) -> tuple:
    """Per-output-channel symmetric int8 of a float32 weight (output
    channels on dim 0), in float64 as JAX's numpy: (int8 weight, float32
    scale)."""
    w = w.detach().double()
    w_scale = torch.clamp_min(w.abs().amax(dim=reduce_dims) / 127.0, _EPS)
    shape = (-1,) + (1,) * (w.dim() - 1)
    wq = torch.clamp(torch.round(w / w_scale.view(shape)), -127, 127)
    return wq.to(torch.int8), w_scale.float()


@torch.no_grad()
def quantize_resnet50(model: ResNet50V1, calib, *, margin: float = 1.05,
                      calib_method: str = "absmax",
                      act_dtype="bfloat16") -> QuantResNet50:
    """Fold BN, calibrate activation scales on ``calib`` (a normalized
    float batch, NHWC or NCHW; one float32 forward on ``model``'s device)
    and quantize every bottleneck conv to per-channel int8 (JAX
    ``quantize_resnet50``). ``model`` is an unfolded :class:`ResNet50V1`
    with its weights loaded; calibrate after any load. ``calib_method``:
    "absmax" or "p999" (the 99.9th percentile). Returns a
    :class:`QuantResNet50` on the same device."""
    if calib_method not in ("absmax", "p999"):
        raise ValueError(f"unknown calib_method {calib_method!r}")
    stat_idx = 0 if calib_method == "absmax" else 1
    dev = model.dense0.weight.device
    folded = fold_bn_variables(model)
    folded.dtype = folded.norm_dtype = torch.float32  # the f32 forward
    stats: dict[str, tuple[float, float]] = {}
    hooks = []
    blocks = [f"stage{si + 1}_block{bi}"
              for si, n in enumerate(model.stage_layers) for bi in range(n)]
    for blk in blocks:
        for conv in _BODY:
            mod = getattr(getattr(folded, blk), conv)
            if mod is not None:
                hooks.append(mod.register_forward_pre_hook(
                    lambda _m, args, key=f"{blk}/{conv}":
                    stats.__setitem__(key, abs_stats(args[0]))))
    try:
        x = torch.as_tensor(np.asarray(calib, np.float32), device=dev)
        folded(x, stem_mode="standard")
    finally:
        for h in hooks:
            h.remove()

    sd = {"conv0.weight": folded.conv0.weight, "conv0.bias": folded.conv0.bias,
          "dense0.weight": folded.dense0.weight,
          "dense0.bias": folded.dense0.bias}
    for blk in blocks:
        for conv in _BODY:
            mod = getattr(getattr(folded, blk), conv)
            if mod is None:
                continue
            wq, w_scale = _quantize_weight(mod.weight, (1, 2, 3))
            sx = stats[f"{blk}/{conv}"][stat_idx] * margin / 127.0
            sd[f"{blk}.{conv}.kernel_q"] = wq.permute(0, 2, 3, 1)  # OHWI
            sd[f"{blk}.{conv}.w_scale"] = w_scale
            sd[f"{blk}.{conv}.bias"] = mod.bias
            sd[f"{blk}.{conv}.act_scale"] = torch.tensor(
                max(sx, _EPS), dtype=torch.float32)
    q = QuantResNet50(model.num_classes, model.stage_layers, act_dtype,
                      model.stem_mode).to(dev)
    q.load_state_dict(sd)
    return q
