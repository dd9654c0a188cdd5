"""Post-training int8 quantization of the ViT/SigLIP towers (serving only),
the counterpart of ``imageclust_tpu/models/quantize_vit.py``.

* quantized (W8A8): every encoder Dense (q, k, v, the attention output
  projection, mlp up and down): weights symmetric per-output-channel int8,
  activations symmetric per-tensor int8 with scales calibrated from one
  float32 forward (q, k and v share one input scale: they read the same
  LayerNorm output); the product is
  :func:`~imageclust_tpu_torch.ops.int8.int8_mm` with exact int32
  accumulation, then ``y * (sx * w_scale) + bias`` in float32;
* kept float: the patchify projection, the attention itself (through
  :func:`imageclust_tpu_torch.ops.attention.attention`: K5 on the card for
  T <= 128, the fused library path above, the twin on the CPU, as the bf16
  towers run it), the LayerNorms (float32), the final projection (float32)
  and the attention-pooling head (:class:`~.vit.MAPHead`) of the published
  SigLIP tower.

Activations between layers are bf16. Parameter and buffer names follow the
float tower's (:class:`~.vit.VisionTransformer`), with each quantized
Dense holding ``kernel_q`` (out, in) int8, ``w_scale``, ``bias`` and
``act_scale`` as the JAX qparams tree does.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from imageclust_tpu_torch.models.quantize import _quantize_weight, abs_stats
from imageclust_tpu_torch.models.resnet50 import _dt
from imageclust_tpu_torch.models.vit import (
    MAPHead,
    ViTConfig,
    VisionTransformer,
    _Dense,
    _gelu,
    _LayerNorm,
    _PatchConv,
)
from imageclust_tpu_torch.ops.attention import attention
from imageclust_tpu_torch.ops.int8 import int8_mm, quantize_act

__all__ = ["QuantViT", "quantize_vit"]

_EPS = 1e-12
_QDENSE = ("q", "k", "v", "proj", "mlp_up", "mlp_down")
# which captured activation scale each quantized Dense consumes
_ACT_KEY = {"q": "attn_in", "k": "attn_in", "v": "attn_in",
            "proj": "attn_out", "mlp_up": "mlp_in", "mlp_down": "mlp_mid"}


class _QDense(nn.Module):
    """An int8 Dense (JAX ``_qdense``): per-tensor input quantize, int32
    product with the (out, in) int8 kernel, per-output-channel dequantize
    and bias in float32, result in the activation dtype."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.register_buffer("kernel_q",
                             torch.zeros(dout, din, dtype=torch.int8))
        self.register_buffer("w_scale", torch.ones(dout))
        self.register_buffer("bias", torch.zeros(dout))
        self.register_buffer("act_scale", torch.ones(()))

    def forward(self, x: torch.Tensor, act_dtype: torch.dtype):
        sx = self.act_scale
        xq = quantize_act(x, sx)
        y = int8_mm(xq.reshape(-1, x.shape[-1]), self.kernel_q.t())
        y = y.reshape(*x.shape[:-1], -1).float() * (sx * self.w_scale)
        return (y + self.bias).to(act_dtype)


class _QBlock(nn.Module):
    """Pre-LN encoder block with int8 Dense layers (JAX quantize_vit.py
    :124-135)."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        w, m = cfg.width, cfg.mlp_width
        self.cfg = cfg
        self.ln1 = _LayerNorm(w, cfg.ln_eps)
        self.q = _QDense(w, w)
        self.k = _QDense(w, w)
        self.v = _QDense(w, w)
        self.proj = _QDense(w, w)
        self.ln2 = _LayerNorm(w, cfg.ln_eps)
        self.mlp_up = _QDense(w, m)
        self.mlp_down = _QDense(m, w)

    def forward(self, x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        c = self.cfg
        y = self.ln1(x, torch.float32).to(dt)
        b, t, _ = y.shape
        hd = c.width // c.heads
        q = self.q(y, dt).reshape(b, t, c.heads, hd)
        k = self.k(y, dt).reshape(b, t, c.heads, hd)
        v = self.v(y, dt).reshape(b, t, c.heads, hd)
        a = attention(q, k, v).reshape(b, t, c.width)
        x = x + self.proj(a, dt).to(x.dtype)
        y = self.ln2(x, torch.float32).to(dt)
        y = _gelu(self.mlp_up(y, dt), c.quick_gelu, c.gelu_approx)
        return x + self.mlp_down(y, dt).to(x.dtype)


class QuantViT(nn.Module):
    """The int8 ViT/SigLIP tower (JAX ``vit_quant_apply``): a normalized
    float batch (NHWC or NCHW, NCHW only when ``shape[1] == 3`` and the
    last axis is not 3) at ``cfg.image_size`` in, the float32 embedding
    (B, ``cfg.embed_dim``) out."""

    def __init__(self, cfg: ViTConfig, act_dtype="bfloat16"):
        super().__init__()
        self.cfg = cfg
        self.act_dtype = _dt(act_dtype)
        w = cfg.width
        self.patch = _PatchConv(cfg.patch, w, bias=not cfg.use_class_token)
        n_tok = (cfg.image_size // cfg.patch) ** 2
        if cfg.use_class_token:
            self.class_token = nn.Parameter(torch.zeros(1, 1, w))
            self.ln_pre = _LayerNorm(w)
            n_tok += 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, w))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", _QBlock(cfg))
        self.ln_post = _LayerNorm(w, cfg.ln_eps)
        if cfg.map_head:
            self.head = MAPHead(cfg)
        if cfg.projection:
            self.projection = _Dense(w, cfg.proj_dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.act_dtype
        if x.shape[1] == 3 and x.shape[-1] != 3:  # NCHW -> NHWC
            x = x.permute(0, 2, 3, 1)
        x = self.patch(x.to(dt), dt)
        b = x.shape[0]
        if c.use_class_token:
            cls = self.class_token.to(dt).expand(b, 1, c.width)
            x = torch.cat([cls, x], dim=1)
        x = x + self.pos_embed.to(dt)
        if c.use_class_token:
            x = self.ln_pre(x, torch.float32).to(dt)
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x, dt)
        if c.map_head:
            return self.head(self.ln_post(x, torch.float32).to(dt), dt)
        if c.use_class_token:
            feat = x[:, 0]
        else:  # jnp.mean: f32 accumulation, result in the activation dtype
            feat = x.float().mean(dim=1).to(x.dtype)
        feat = self.ln_post(feat, torch.float32)
        if not c.projection:
            return feat
        return self.projection(feat, torch.float32)


@torch.no_grad()
def quantize_vit(model: VisionTransformer, calib, *, margin: float = 1.05,
                 calib_method: str = "absmax",
                 act_dtype="bfloat16") -> QuantViT:
    """Calibrate activation scales on one float32 forward of ``model``'s
    weights over ``calib`` (a normalized float batch, NHWC or NCHW, on
    ``model``'s device) and quantize every encoder Dense to
    per-output-channel int8 (JAX ``quantize_vit``). Calibrate after any
    weight load. ``margin`` and ``calib_method`` ("absmax" | "p999") as in
    :func:`~.quantize.quantize_resnet50`. Returns a :class:`QuantViT` on
    the same device."""
    if calib_method not in ("absmax", "p999"):
        raise ValueError(f"unknown calib_method {calib_method!r}")
    stat_idx = 0 if calib_method == "absmax" else 1
    cfg = model.cfg
    dev = model.pos_embed.device
    src = model.state_dict()
    with torch.device(dev):
        f32 = VisionTransformer(cfg, dtype="float32", norm_dtype="float32")
    f32.load_state_dict(src)
    stats: dict[str, tuple[float, float]] = {}
    hooks = []
    for i in range(cfg.depth):
        for name in ("q", "proj", "mlp_up", "mlp_down"):
            key = f"block{i}/{_ACT_KEY[name]}"
            hooks.append(getattr(f32, f"block{i}").get_submodule(name)
                         .register_forward_pre_hook(
                             lambda _m, args, key=key:
                             stats.__setitem__(key, abs_stats(args[0]))))
    try:
        f32(torch.as_tensor(np.asarray(calib, np.float32), device=dev))
    finally:
        for h in hooks:
            h.remove()
    del f32

    # the float parts as they are; block{i}.{dense}.* are replaced below
    sd = {k: v for k, v in src.items()
          if not (k.startswith("block") and k.split(".")[1] in _QDENSE)}
    for i in range(cfg.depth):
        for name in _QDENSE:
            key = f"block{i}.{name}"
            wq, w_scale = _quantize_weight(src[f"{key}.weight"], (1,))
            sx = stats[f"block{i}/{_ACT_KEY[name]}"][stat_idx] * margin / 127.0
            sd[f"{key}.kernel_q"] = wq
            sd[f"{key}.w_scale"] = w_scale
            sd[f"{key}.bias"] = src[f"{key}.bias"]
            sd[f"{key}.act_scale"] = torch.tensor(max(sx, _EPS),
                                                  dtype=torch.float32)
    q = QuantViT(cfg, act_dtype).to(dev)
    q.load_state_dict(sd)
    return q
