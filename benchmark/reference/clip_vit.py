"""Plain float32 CLIP vision tower with its projection (OpenAI CLIP ViT).

The network as published (Radford et al. 2021, "Learning Transferable
Visual Models From Natural Language Supervision"; HuggingFace
``CLIPVisionModelWithProjection``): a patch convolution without bias
(kernel = stride = patch), a learned class embedding and position table,
``pre_layrnorm``, pre-LN encoder layers (multi-head self-attention with
biased q, k, v and output projections, scores scaled by head_dim^-0.5; an
MLP of ``fc1``, QuickGELU ``x * sigmoid(1.702 x)`` and ``fc2``), the
class token through ``post_layernorm`` and the projection without bias.
LayerNorm epsilon 1e-5.

Weights are a dict keyed by the HuggingFace names
(``vision_model.embeddings.patch_embedding.weight``, ...,
``visual_projection.weight``), linear weights (out, in). The input is the
system's: BGR uint8 images at the tower's size, flipped to RGB, scaled by
1/255 and normalised by CLIP's mean and standard deviation.

Plain torch operations only, no kernel of the program, and TF32 off while
it runs (:func:`embed`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import no_tf32

EPS = 1e-5
MEAN = (0.48145466, 0.4578275, 0.40821073)
STD = (0.26862954, 0.26130258, 0.27577711)


@dataclass(frozen=True)
class Shape:
    image_size: int
    patch_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int
    projection_dim: int

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2 + 1

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def shape_of(config: dict) -> Shape:
    """The tower's sizes from a configuration file's keys."""
    return Shape(**{k: int(config[k]) for k in Shape.__dataclass_fields__})


def initializers(s: Shape) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the published state dict."""
    d, p = s.hidden_size, "vision_model."
    out = [
        (f"{p}embeddings.patch_embedding.weight",
         (d, 3, s.patch_size, s.patch_size), "conv"),
        (f"{p}embeddings.class_embedding", (d,), "embedding"),
        (f"{p}embeddings.position_embedding.weight", (s.tokens, d),
         "embedding"),
        (f"{p}pre_layrnorm.weight", (d,), "ln_weight"),
        (f"{p}pre_layrnorm.bias", (d,), "ln_bias"),
    ]
    for i in range(s.num_hidden_layers):
        q = f"{p}encoder.layers.{i}."
        for name, dout, din in (("self_attn.q_proj", d, d),
                                ("self_attn.k_proj", d, d),
                                ("self_attn.v_proj", d, d),
                                ("self_attn.out_proj", d, d),
                                ("mlp.fc1", s.intermediate_size, d),
                                ("mlp.fc2", d, s.intermediate_size)):
            out.append((f"{q}{name}.weight", (dout, din), "linear"))
            out.append((f"{q}{name}.bias", (dout,), "bias"))
        for name in ("layer_norm1", "layer_norm2"):
            out.append((f"{q}{name}.weight", (d,), "ln_weight"))
            out.append((f"{q}{name}.bias", (d,), "ln_bias"))
    out += [
        (f"{p}post_layernorm.weight", (d,), "ln_weight"),
        (f"{p}post_layernorm.bias", (d,), "ln_bias"),
        ("visual_projection.weight", (s.projection_dim, d), "linear"),
    ]
    return out


def flops_per_image(s: Shape) -> int:
    """Operations of one image's forward from the published shapes: the
    patch convolution, every linear layer, the attention scores and their
    product with the values, and the projection, a multiply-add counting 2
    (LayerNorm, softmax and the activation left out, as a FLOP counter of
    products leaves them out)."""
    d, t, i = s.hidden_size, s.tokens, s.intermediate_size
    patch = 2 * (t - 1) * d * 3 * s.patch_size ** 2
    layer = (4 * 2 * t * d * d  # q, k, v, out
             + 2 * 2 * t * t * d  # scores and values, over all heads
             + 2 * 2 * t * d * i)  # fc1, fc2
    return patch + s.num_hidden_layers * layer + 2 * d * s.projection_dim


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (B, H, W, 3) -> normalised RGB float32 (B, 3, H, W)."""
    x = images.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def forward(w: dict[str, torch.Tensor], s: Shape,
            x: torch.Tensor) -> torch.Tensor:
    """Projected embeddings (B, projection_dim) of a normalised batch."""
    p = "vision_model."
    d, h, hd = s.hidden_size, s.num_attention_heads, s.head_dim

    def ln(y, name):
        return F.layer_norm(y, (d,), w[f"{name}.weight"], w[f"{name}.bias"],
                            EPS)

    def lin(y, name):
        return F.linear(y, w[f"{name}.weight"], w[f"{name}.bias"])

    y = F.conv2d(x, w[f"{p}embeddings.patch_embedding.weight"],
                 stride=s.patch_size)
    y = y.flatten(2).transpose(1, 2)
    b, t = y.shape[0], s.tokens
    cls = w[f"{p}embeddings.class_embedding"].view(1, 1, d).expand(b, 1, d)
    y = torch.cat([cls, y], dim=1) + w[f"{p}embeddings.position_embedding"
                                       ".weight"]
    y = ln(y, f"{p}pre_layrnorm")
    for i in range(s.num_hidden_layers):
        q = f"{p}encoder.layers.{i}."
        z = ln(y, f"{q}layer_norm1")

        def heads(name):
            return lin(z, f"{q}self_attn.{name}").view(b, t, h, hd).transpose(
                1, 2)

        scores = (heads("q_proj") * hd ** -0.5) @ heads("k_proj").transpose(
            -1, -2)
        a = torch.softmax(scores, dim=-1) @ heads("v_proj")
        y = y + lin(a.transpose(1, 2).reshape(b, t, d),
                    f"{q}self_attn.out_proj")
        z = lin(ln(y, f"{q}layer_norm2"), f"{q}mlp.fc1")
        y = y + lin(z * torch.sigmoid(1.702 * z), f"{q}mlp.fc2")
    pooled = ln(y[:, 0], f"{p}post_layernorm")
    return F.linear(pooled, w["visual_projection.weight"])


@torch.no_grad()
def embed(w: dict[str, torch.Tensor], s: Shape, images: torch.Tensor,
          block: int = 256) -> torch.Tensor:
    """Float32 embeddings of BGR uint8 images, ``block`` rows at a time."""
    with no_tf32():
        return torch.cat([forward(w, s, preprocess(images[i:i + block]))
                          for i in range(0, images.shape[0], block)])
