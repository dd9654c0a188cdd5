"""Vision Transformer image towers (CLIP / SigLIP families) in PyTorch,
architecture- and numerics-matched to the JAX package's Flax towers
(``imageclust_tpu/models/vit.py``).

Cast points mirror the Flax module: the patch projection, the encoder's
Dense layers and the GELU run in ``dtype`` (bf16 by default; parameters
are kept in float32 and cast at use); the residual stream stays in
``dtype``; every LayerNorm computes in float32 on an upcast input and
returns ``norm_dtype`` (``ln_pre`` and ``ln_post`` return float32);
``ln_post`` and ``projection`` run in float32. Attention goes through
:func:`imageclust_tpu_torch.ops.attention.attention` (K5 on the card at
T <= 128, the plain path otherwise). The LayerNorms are ``F.layer_norm``;
Flax computes the variance as ``E[x²] - E[x]²``, a difference at the
tolerance level of the tests. The patch convolution (stride = kernel) is
one matrix product over the flattened patches.

Parameter names follow the Flax tree (``patch``, ``class_token``,
``pos_embed``, ``ln_pre``, ``block{i}.{ln1,q,k,v,proj,ln2,mlp_up,mlp_down}``,
``ln_post``, ``projection``) so :mod:`.convert` maps one onto the other by
name. :func:`load_clip_vision_state_dict` maps a HuggingFace
``CLIPVisionModel`` (+ ``visual_projection``) state dict onto the same
names.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from imageclust_tpu_torch.models.resnet50 import _dt, _lecun_normal_
from imageclust_tpu_torch.ops.attention import attention

__all__ = ["ViTConfig", "VIT_CONFIGS", "EncoderBlock", "VisionTransformer",
           "load_clip_vision_state_dict"]

_EPS = 1e-5


@dataclass(frozen=True)
class ViTConfig:
    patch: int
    width: int
    depth: int
    heads: int
    proj_dim: int
    image_size: int = 224
    use_class_token: bool = True
    quick_gelu: bool = True  # CLIP's x * sigmoid(1.702 x)
    # preprocessing (CLIP normalization; the resnet50 path keeps the
    # reference's raw 1/255 pixels instead)
    mean: tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    std: tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)


VIT_CONFIGS: dict[str, ViTConfig] = {
    "vit_b32": ViTConfig(patch=32, width=768, depth=12, heads=12, proj_dim=512),
    "vit_b16": ViTConfig(patch=16, width=768, depth=12, heads=12, proj_dim=512),
    "vit_l14": ViTConfig(patch=14, width=1024, depth=24, heads=16, proj_dim=768),
    "vit_l14_336": ViTConfig(
        patch=14, width=1024, depth=24, heads=16, proj_dim=768, image_size=336
    ),
    "siglip_so400m": ViTConfig(
        patch=14, width=1152, depth=27, heads=16, proj_dim=1152,
        use_class_token=False, quick_gelu=False,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5),
    ),
}


def _gelu(x: torch.Tensor, quick: bool) -> torch.Tensor:
    if quick:
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate="none")


class _Dense(nn.Module):
    """Flax ``nn.Dense``: float32 weight (stored (out, in)) and bias, input,
    weight and bias cast to the compute dtype at use."""

    def __init__(self, din: int, dout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(dout, din))
        self.bias = nn.Parameter(torch.zeros(dout)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), b)


class _LayerNorm(nn.Module):
    """Flax ``nn.LayerNorm(epsilon=1e-5)``: float32 statistics and affine on
    the upcast input, result in ``out_dtype``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         _EPS)
        return y.to(out_dtype)


class _PatchConv(nn.Module):
    """The patchify conv (kernel = stride = patch, no padding), OIHW weight
    as Flax's HWIO kernel transposed; optional bias (SigLIP)."""

    def __init__(self, patch: int, width: int, bias: bool):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))
        self.bias = nn.Parameter(torch.zeros(width)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (B, H, W, 3) -> (B, (H/p)*(W/p), width) in ``dtype``."""
        b, h, w, c = x.shape
        p = self.patch
        if h % p or w % p:
            raise ValueError(f"input {h}x{w} is not a multiple of the "
                             f"patch size {p}")
        gh, gw = h // p, w // p
        xp = x.reshape(b, gh, p, gw, p, c).permute(0, 1, 3, 2, 4, 5)
        xp = xp.reshape(b, gh * gw, p * p * c)
        wt = self.weight.permute(0, 2, 3, 1).reshape(self.weight.shape[0], -1)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(xp.to(dtype), wt.to(dtype), bias)


class EncoderBlock(nn.Module):
    """Pre-LN transformer block (JAX vit.py:99-125)."""

    def __init__(self, cfg: ViTConfig, dtype, norm_dtype):
        super().__init__()
        self.cfg = cfg
        self.dtype = _dt(dtype)
        self.norm_dtype = _dt(norm_dtype)
        w = cfg.width
        self.ln1 = _LayerNorm(w)
        self.q = _Dense(w, w)
        self.k = _Dense(w, w)
        self.v = _Dense(w, w)
        self.proj = _Dense(w, w)
        self.ln2 = _LayerNorm(w)
        self.mlp_up = _Dense(w, 4 * w)
        self.mlp_down = _Dense(4 * w, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        y = self.ln1(x, self.norm_dtype).to(dt)
        b, t, _ = y.shape
        hd = c.width // c.heads
        q = self.q(y, dt).reshape(b, t, c.heads, hd)
        k = self.k(y, dt).reshape(b, t, c.heads, hd)
        v = self.v(y, dt).reshape(b, t, c.heads, hd)
        a = attention(q, k, v)
        a = self.proj(a.reshape(b, t, c.width), dt)
        x = x + a.to(x.dtype)
        y = self.ln2(x, self.norm_dtype).to(dt)
        y = _gelu(self.mlp_up(y, dt), c.quick_gelu)
        y = self.mlp_down(y, dt)
        return x + y.to(x.dtype)


class VisionTransformer(nn.Module):
    """CLIP/SigLIP-style image tower (JAX vit.py:128-184). Input NCHW or
    NHWC float, already normalized per ``ViTConfig.mean/std``, at
    ``cfg.image_size``. Returns the projected embedding (B, proj_dim), and
    with ``return_features`` also the float32 pooled features (B, width)."""

    def __init__(self, cfg: ViTConfig, dtype="bfloat16",
                 norm_dtype="float32"):
        super().__init__()
        self.cfg = cfg
        self.dtype = _dt(dtype)
        self.norm_dtype = _dt(norm_dtype)
        w = cfg.width
        # CLIP's patch conv has no bias; SigLIP's has one
        self.patch = _PatchConv(cfg.patch, w, bias=not cfg.use_class_token)
        n_tok = (cfg.image_size // cfg.patch) ** 2
        if cfg.use_class_token:
            self.class_token = nn.Parameter(torch.zeros(1, 1, w))
            self.ln_pre = _LayerNorm(w)
            n_tok += 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, w))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", EncoderBlock(cfg, dtype, norm_dtype))
        self.ln_post = _LayerNorm(w)
        self.projection = _Dense(w, cfg.proj_dim, bias=False)

    def forward(self, x: torch.Tensor, return_features: bool = False):
        c, dt = self.cfg, self.dtype
        if x.shape[1] == 3:
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
            x = getattr(self, f"block{i}")(x)
        if c.use_class_token:
            feat = x[:, 0]
        else:  # jnp.mean: f32 accumulation, result in the activation dtype
            feat = x.float().mean(dim=1).to(x.dtype)
        feat = self.ln_post(feat, torch.float32)
        emb = self.projection(feat, torch.float32)
        if return_features:
            return emb, feat
        return emb

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "VisionTransformer":
        """Seeded init with Flax's initializer families: normal(0.02) for
        the class token and position embeddings, lecun_normal (truncated
        normal, fan-in) for Dense and conv kernels, zero biases, LayerNorm
        scale 1 / shift 0. A ``torch.Generator`` gives different numbers
        from ``jax.random`` for the same seed."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (_Dense, _PatchConv)):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        for name in ("class_token", "pos_embed"):
            if hasattr(self, name):
                p = getattr(self, name)
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self


def _hf_pairs(cfg: ViTConfig):
    """(port key, HF key without ``vision_model.``) for every tensor a HF
    CLIPVisionModel holds for this config."""
    yield "patch.weight", "embeddings.patch_embedding.weight"
    if cfg.use_class_token:
        yield "class_token", "embeddings.class_embedding"
        yield "ln_pre.weight", "pre_layrnorm.weight"
        yield "ln_pre.bias", "pre_layrnorm.bias"
    else:
        yield "patch.bias", "embeddings.patch_embedding.bias"
    yield "pos_embed", "embeddings.position_embedding.weight"
    lin = [("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
           ("v", "self_attn.v_proj"), ("proj", "self_attn.out_proj"),
           ("mlp_up", "mlp.fc1"), ("mlp_down", "mlp.fc2"),
           ("ln1", "layer_norm1"), ("ln2", "layer_norm2")]
    for i in range(cfg.depth):
        for ours, theirs in lin:
            for leaf in ("weight", "bias"):
                yield (f"block{i}.{ours}.{leaf}",
                       f"encoder.layers.{i}.{theirs}.{leaf}")
    yield "ln_post.weight", "post_layernorm.weight"
    yield "ln_post.bias", "post_layernorm.bias"


def load_clip_vision_state_dict(state_dict: Mapping,
                                cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Map a HuggingFace ``CLIPVisionModel`` (+ ``visual_projection``)
    state dict (tensors or numpy arrays) onto :class:`VisionTransformer`'s
    names: the counterpart of JAX ``load_clip_vision_torch``. HF's Linear
    and Conv weights already have the port's (out, in) / OIHW layout, where
    the JAX loader transposes them into Flax's; the class token becomes
    (1, 1, width) and the position table (1, T, width), as there. Returns
    float32 tensors; ``projection.weight`` is left out when the checkpoint
    has no ``visual_projection`` (the caller keeps its own, as the JAX
    loader does). The tower without a class token (SigLIP style) also
    needs ``embeddings.patch_embedding.bias``, which the JAX loader leaves
    out. Raises ValueError listing every missing or mis-shaped tensor."""
    sd = {k.replace("vision_model.", ""): v for k, v in state_dict.items()}
    with torch.device("meta"):
        want = {k: tuple(v.shape)
                for k, v in VisionTransformer(cfg).state_dict().items()}
    pairs = list(_hf_pairs(cfg))
    if "visual_projection.weight" in sd:
        pairs.append(("projection.weight", "visual_projection.weight"))
    out: dict[str, torch.Tensor] = {}
    problems = []
    for ours, theirs in pairs:
        if theirs not in sd:
            problems.append(f"{theirs}: missing")
            continue
        val = sd[theirs]
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().float().numpy()
        arr = np.asarray(val, np.float32)
        if ours == "class_token":
            arr = arr.reshape(1, 1, -1)
        elif ours == "pos_embed":
            arr = arr[None]
        if tuple(arr.shape) != want[ours]:
            problems.append(f"{theirs}: {tuple(arr.shape)} != {want[ours]}")
            continue
        out[ours] = torch.tensor(arr)
    if problems:
        raise ValueError("CLIP vision state dict does not fit the tower:\n  "
                         + "\n  ".join(problems[:40]))
    return out
