"""Vision Transformer image towers (CLIP / SigLIP families) in PyTorch,
architecture- and numerics-matched to the JAX package's Flax towers
(``imageclust_tpu/models/vit.py``), and the published SigLIP So400m/14@384
vision tower, which the JAX package does not have.

Cast points mirror the Flax module: the patch projection, the encoder's
Dense layers and the GELU run in ``dtype`` (bf16 by default; parameters
are kept in float32 and cast at use); the residual stream stays in
``dtype``; every LayerNorm computes in float32 on an upcast input and
returns ``norm_dtype`` (``ln_pre`` and ``ln_post`` return float32);
``ln_post`` and ``projection`` run in float32. Attention goes through
:func:`imageclust_tpu_torch.ops.attention.attention` (K5 on the card at
T <= 128, the fused library path above, the plain twin on the CPU), inside
a ``vit/attention`` profiler range. The LayerNorms are ``F.layer_norm``;
Flax computes the variance as ``E[x²] - E[x]²``, a difference at the
tolerance level of the tests. The patch convolution (stride = kernel, no
padding: rows and columns past the last whole patch are dropped) is one
matrix product over the flattened patches.

``siglip_so400m`` is the JAX package's SigLIP-style tower (4 x width MLP,
exact GELU, epsilon 1e-5, 224 px, token mean and a projection), not the
published model. ``siglip_so400m_384`` is the published one
(``google/siglip-so400m-patch14-384``, HF ``SiglipVisionModel``): a
4,304-wide MLP, the tanh GELU, epsilon 1e-6, 384 px (T = 729), and in place
of the mean and the projection, ``post_layernorm`` over every token and
then the multihead attention-pooling head (:class:`MAPHead`, in a
``vit/head`` profiler range); its embedding is the head's 1152-d output.

Parameter names follow the Flax tree (``patch``, ``class_token``,
``pos_embed``, ``ln_pre``, ``block{i}.{ln1,q,k,v,proj,ln2,mlp_up,mlp_down}``,
``ln_post``, ``projection``; the head's ``head.{probe,q,k,v,proj,ln,mlp_up,
mlp_down}``) so :mod:`.convert` maps one onto the other by name.
:func:`load_clip_vision_state_dict` maps a HuggingFace ``CLIPVisionModel``
(+ ``visual_projection``) state dict onto the same names, and
:func:`load_siglip_vision_state_dict` a ``SiglipVisionModel``'s.
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
from imageclust_tpu_torch.utils.metrics import traced

__all__ = ["ViTConfig", "VIT_CONFIGS", "EncoderBlock", "MAPHead",
           "VisionTransformer", "load_clip_vision_state_dict",
           "load_siglip_vision_state_dict"]

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
    # the port's own fields; the JAX package's towers keep these defaults
    mlp_dim: int = 0  # the MLP's hidden width; 0 is 4 x width
    gelu_approx: str = "none"  # without quick_gelu: F.gelu's "none" or "tanh"
    ln_eps: float = _EPS
    map_head: bool = False  # pool with the attention-pooling head (SigLIP)
    projection: bool = True  # a bias-free projection to proj_dim follows

    @property
    def mlp_width(self) -> int:
        return self.mlp_dim or 4 * self.width

    @property
    def embed_dim(self) -> int:
        """The width of the tower's embedding."""
        return self.proj_dim if self.projection else self.width


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
    "siglip_so400m_384": ViTConfig(
        patch=14, width=1152, depth=27, heads=16, proj_dim=1152,
        image_size=384, use_class_token=False, quick_gelu=False,
        mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5), mlp_dim=4304,
        gelu_approx="tanh", ln_eps=1e-6, map_head=True, projection=False,
    ),
}


def _gelu(x: torch.Tensor, quick: bool,
          approximate: str = "none") -> torch.Tensor:
    if quick:
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x, approximate=approximate)


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
    """Flax ``nn.LayerNorm(epsilon=eps)``: float32 statistics and affine on
    the upcast input, result in ``out_dtype``."""

    def __init__(self, c: int, eps: float = _EPS):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        y = F.layer_norm(x.float(), (x.shape[-1],), self.weight, self.bias,
                         self.eps)
        return y.to(out_dtype)


class _PatchConv(nn.Module):
    """The patchify conv (kernel = stride = patch, no padding: rows and
    columns past the last whole patch are dropped, as a ``padding="valid"``
    convolution drops them), OIHW weight as Flax's HWIO kernel transposed;
    optional bias (SigLIP)."""

    def __init__(self, patch: int, width: int, bias: bool):
        super().__init__()
        self.patch = patch
        self.weight = nn.Parameter(torch.empty(width, 3, patch, patch))
        self.bias = nn.Parameter(torch.zeros(width)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (B, H, W, 3) -> (B, (H//p)*(W//p), width) in ``dtype``."""
        b, h, w, c = x.shape
        p = self.patch
        gh, gw = h // p, w // p
        if not gh or not gw:
            raise ValueError(f"input {h}x{w} is smaller than the patch "
                             f"size {p}")
        if (h, w) != (gh * p, gw * p):
            x = x[:, :gh * p, :gw * p]
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
        w, m = cfg.width, cfg.mlp_width
        self.ln1 = _LayerNorm(w, cfg.ln_eps)
        self.q = _Dense(w, w)
        self.k = _Dense(w, w)
        self.v = _Dense(w, w)
        self.proj = _Dense(w, w)
        self.ln2 = _LayerNorm(w, cfg.ln_eps)
        self.mlp_up = _Dense(w, m)
        self.mlp_down = _Dense(m, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c, dt = self.cfg, self.dtype
        y = self.ln1(x, self.norm_dtype).to(dt)
        b, t, _ = y.shape
        hd = c.width // c.heads
        q = self.q(y, dt).reshape(b, t, c.heads, hd)
        k = self.k(y, dt).reshape(b, t, c.heads, hd)
        v = self.v(y, dt).reshape(b, t, c.heads, hd)
        with traced("vit/attention"):
            a = attention(q, k, v)
        a = self.proj(a.reshape(b, t, c.width), dt)
        x = x + a.to(x.dtype)
        y = self.ln2(x, self.norm_dtype).to(dt)
        y = _gelu(self.mlp_up(y, dt), c.quick_gelu, c.gelu_approx)
        y = self.mlp_down(y, dt)
        return x + y.to(x.dtype)


class MAPHead(nn.Module):
    """SigLIP's multihead attention-pooling head (HF
    ``SiglipMultiheadAttentionPoolingHead``): a learned probe attends over
    the tokens as ``nn.MultiheadAttention`` does (q from the probe, k and v
    from the tokens, scores scaled by head_dim^-0.5, the output
    projection), then ``h + mlp(layernorm(h))``. One query, so its
    attention is plain products with float32 scores, not the fused path.
    The probe's path, the LayerNorm and the MLP run in float32; k and v
    over the tokens in ``dtype``."""

    def __init__(self, cfg: ViTConfig):
        super().__init__()
        self.cfg = cfg
        w, m = cfg.width, cfg.mlp_width
        self.probe = nn.Parameter(torch.zeros(1, 1, w))
        self.q = _Dense(w, w)
        self.k = _Dense(w, w)
        self.v = _Dense(w, w)
        self.proj = _Dense(w, w)
        self.ln = _LayerNorm(w, cfg.ln_eps)
        self.mlp_up = _Dense(w, m)
        self.mlp_down = _Dense(m, w)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """x (B, T, width) after ``post_layernorm`` -> float32 (B, width)."""
        c, f32 = self.cfg, torch.float32
        b, t, w = x.shape
        hd = w // c.heads
        # the probe is a parameter: it enters F.linear directly, since a
        # module call with it as input breaks FLOP counters' module hooks
        q = F.linear(self.probe[0], self.q.weight, self.q.bias)
        q = q.view(c.heads, hd) * hd ** -0.5
        k = self.k(x, dtype).view(b, t, c.heads, hd)
        v = self.v(x, dtype).view(b, t, c.heads, hd)
        p = torch.softmax(torch.einsum("hd,bthd->bht", q, k.float()), dim=-1)
        o = torch.einsum("bht,bthd->bhd", p, v.float()).reshape(b, w)
        h = self.proj(o, f32)
        y = _gelu(self.mlp_up(self.ln(h, f32), f32), c.quick_gelu,
                  c.gelu_approx)
        return h + self.mlp_down(y, f32)


class VisionTransformer(nn.Module):
    """CLIP/SigLIP-style image tower (JAX vit.py:128-184). Input NCHW or
    NHWC float, already normalized per ``ViTConfig.mean/std``, at
    ``cfg.image_size``. Returns the embedding (B, ``cfg.embed_dim``): the
    projection's, or without one the pooled features; with
    ``return_features`` also the float32 pooled features (B, width)."""

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
            self.ln_pre = _LayerNorm(w, cfg.ln_eps)
            n_tok += 1
        self.pos_embed = nn.Parameter(torch.zeros(1, n_tok, w))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", EncoderBlock(cfg, dtype, norm_dtype))
        self.ln_post = _LayerNorm(w, cfg.ln_eps)
        if cfg.map_head:
            self.head = MAPHead(cfg)
        if cfg.projection:
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
        if c.map_head:
            x = self.ln_post(x, self.norm_dtype).to(dt)
            with traced("vit/head"):
                feat = self.head(x, dt)
        else:
            if c.use_class_token:
                feat = x[:, 0]
            else:  # jnp.mean: f32 accumulation, result in the activation dtype
                feat = x.float().mean(dim=1).to(x.dtype)
            feat = self.ln_post(feat, torch.float32)
        emb = self.projection(feat, torch.float32) if c.projection else feat
        if return_features:
            return emb, feat
        return emb

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "VisionTransformer":
        """Seeded init with Flax's initializer families: normal(0.02) for
        the class token, the position embeddings and the head's probe,
        lecun_normal (truncated normal, fan-in) for Dense and conv kernels,
        zero biases, LayerNorm scale 1 / shift 0. A ``torch.Generator``
        gives different numbers from ``jax.random`` for the same seed."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, (_Dense, _PatchConv)):
                _lecun_normal_(mod.weight, mod.weight[0].numel(), gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        tables = [getattr(self, name) for name in ("class_token", "pos_embed")
                  if hasattr(self, name)]
        if self.cfg.map_head:
            tables.append(self.head.probe)
        for p in tables:
            p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
        return self


_HF_BLOCK = [("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
             ("v", "self_attn.v_proj"), ("proj", "self_attn.out_proj"),
             ("mlp_up", "mlp.fc1"), ("mlp_down", "mlp.fc2"),
             ("ln1", "layer_norm1"), ("ln2", "layer_norm2")]
_HF_HEAD = [("proj", "attention.out_proj"), ("ln", "layernorm"),
            ("mlp_up", "mlp.fc1"), ("mlp_down", "mlp.fc2")]


def _hf_pairs(cfg: ViTConfig):
    """(port key, HF key without ``vision_model.``, third) for every tensor
    a HF CLIPVisionModel or SiglipVisionModel holds for this config;
    ``third`` is None, or which third (q, k, v) of the head's packed
    ``in_proj`` tensor the port's one is."""
    yield "patch.weight", "embeddings.patch_embedding.weight", None
    if cfg.use_class_token:
        yield "class_token", "embeddings.class_embedding", None
        yield "ln_pre.weight", "pre_layrnorm.weight", None
        yield "ln_pre.bias", "pre_layrnorm.bias", None
    else:
        yield "patch.bias", "embeddings.patch_embedding.bias", None
    yield "pos_embed", "embeddings.position_embedding.weight", None
    for i in range(cfg.depth):
        for ours, theirs in _HF_BLOCK:
            for leaf in ("weight", "bias"):
                yield (f"block{i}.{ours}.{leaf}",
                       f"encoder.layers.{i}.{theirs}.{leaf}", None)
    yield "ln_post.weight", "post_layernorm.weight", None
    yield "ln_post.bias", "post_layernorm.bias", None
    if cfg.map_head:
        yield "head.probe", "head.probe", None
        for j, ours in enumerate(("q", "k", "v")):
            yield f"head.{ours}.weight", "head.attention.in_proj_weight", j
            yield f"head.{ours}.bias", "head.attention.in_proj_bias", j
        for ours, theirs in _HF_HEAD:
            for leaf in ("weight", "bias"):
                yield f"head.{ours}.{leaf}", f"head.{theirs}.{leaf}", None


def _load_hf_vision(state_dict: Mapping, cfg: ViTConfig, family: str,
                    pairs: list) -> dict[str, torch.Tensor]:
    sd = {k.replace("vision_model.", ""): v for k, v in state_dict.items()}
    with torch.device("meta"):
        want = {k: tuple(v.shape)
                for k, v in VisionTransformer(cfg).state_dict().items()}
    out: dict[str, torch.Tensor] = {}
    problems = []
    for ours, theirs, third in pairs:
        if theirs not in sd:
            if f"{theirs}: missing" not in problems:
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
        elif third is not None:
            n = want[ours][0]
            if arr.shape[0] != 3 * n:
                problems.append(f"{theirs}: {tuple(arr.shape)} is not three "
                                f"{want[ours]}")
                continue
            arr = arr[third * n:(third + 1) * n]
        if tuple(arr.shape) != want[ours]:
            problems.append(f"{theirs}: {tuple(arr.shape)} != {want[ours]}")
            continue
        out[ours] = torch.tensor(arr)
    if problems:
        raise ValueError(f"{family} vision state dict does not fit the "
                         "tower:\n  " + "\n  ".join(problems[:40]))
    return out


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
    pairs = list(_hf_pairs(cfg))
    if cfg.projection and "visual_projection.weight" in {
            k.replace("vision_model.", "") for k in state_dict}:
        pairs.append(("projection.weight", "visual_projection.weight", None))
    return _load_hf_vision(state_dict, cfg, "CLIP", pairs)


def load_siglip_vision_state_dict(state_dict: Mapping,
                                  cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Map a HuggingFace ``SiglipVisionModel`` state dict (tensors or numpy
    arrays; a whole ``SiglipModel``'s text tensors are ignored) onto
    :class:`VisionTransformer`'s names for a tower with the
    attention-pooling head (``cfg.map_head``): the encoder as in
    :func:`load_clip_vision_state_dict`, ``head.probe`` as it is, the
    head's packed ``attention.in_proj_{weight,bias}`` split into
    ``head.{q,k,v}``, ``attention.out_proj`` to ``head.proj``,
    ``layernorm`` to ``head.ln`` and ``mlp.fc1``/``fc2`` to
    ``head.mlp_up``/``mlp_down``. Returns float32 tensors. Raises
    ValueError listing every missing or mis-shaped tensor."""
    if not cfg.map_head:
        raise ValueError("a SigLIP vision state dict loads into a tower "
                         "with the attention-pooling head (map_head)")
    return _load_hf_vision(state_dict, cfg, "SigLIP", list(_hf_pairs(cfg)))
