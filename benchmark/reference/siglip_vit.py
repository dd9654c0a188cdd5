"""Plain float32 SigLIP vision tower with its attention-pooling head
(SigLIP So400m/14@384).

The network as published (Zhai et al. 2023, "Sigmoid Loss for Language
Image Pre-Training", arXiv 2303.15343, with the So400m shape of
Alabdulmohsin et al. 2023, arXiv 2305.13035; HuggingFace
``SiglipVisionModel``, whose ``pooler_output`` this returns): a patch
convolution with bias (kernel = stride = patch, ``padding="valid"``, so at
384 px the last 6 rows and columns are dropped), a learned position table
and no class token, pre-LN encoder layers (multi-head self-attention with
biased q, k, v and output projections, scores scaled by head_dim^-0.5; an
MLP of ``fc1``, the tanh-approximated GELU and ``fc2``), ``post_layernorm``
over every token, then the multihead attention-pooling head: a learned
probe attends over the tokens through ``nn.MultiheadAttention``'s
arithmetic (its packed ``in_proj`` split into q, k and v, the output
projection), then ``h + mlp(layernorm(h))``, whose one row is the
embedding. LayerNorm epsilon 1e-6. No projection follows.

Weights are a dict keyed by the HuggingFace names
(``vision_model.embeddings.patch_embedding.weight``, ...,
``vision_model.head.mlp.fc2.bias``), linear weights (out, in). The input is
the system's: BGR uint8 images at the tower's size, flipped to RGB, scaled
by 1/255 and normalised by mean and standard deviation 0.5.

Plain torch operations only, no kernel of the program, and TF32 off while
it runs (:func:`embed`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from benchmark.reference import no_tf32

EPS = 1e-6
MEAN = (0.5, 0.5, 0.5)
STD = (0.5, 0.5, 0.5)


@dataclass(frozen=True)
class Shape:
    image_size: int
    patch_size: int
    hidden_size: int
    intermediate_size: int
    num_hidden_layers: int
    num_attention_heads: int

    @property
    def tokens(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


def shape_of(config: dict) -> Shape:
    """The tower's sizes from a configuration file's keys."""
    return Shape(**{k: int(config[k]) for k in Shape.__dataclass_fields__})


def initializers(s: Shape) -> list[tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the published state dict."""
    d, i, p = s.hidden_size, s.intermediate_size, "vision_model."
    out = [
        (f"{p}embeddings.patch_embedding.weight",
         (d, 3, s.patch_size, s.patch_size), "conv"),
        (f"{p}embeddings.patch_embedding.bias", (d,), "bias"),
        (f"{p}embeddings.position_embedding.weight", (s.tokens, d),
         "embedding"),
    ]

    def linear(name, dout, din):
        out.append((f"{name}.weight", (dout, din), "linear"))
        out.append((f"{name}.bias", (dout,), "bias"))

    def norm(name):
        out.append((f"{name}.weight", (d,), "ln_weight"))
        out.append((f"{name}.bias", (d,), "ln_bias"))

    for j in range(s.num_hidden_layers):
        q = f"{p}encoder.layers.{j}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{q}self_attn.{name}", d, d)
        linear(f"{q}mlp.fc1", i, d)
        linear(f"{q}mlp.fc2", d, i)
        norm(f"{q}layer_norm1")
        norm(f"{q}layer_norm2")
    norm(f"{p}post_layernorm")
    h = f"{p}head."
    out += [(f"{h}probe", (1, 1, d), "embedding"),
            (f"{h}attention.in_proj_weight", (3 * d, d), "linear"),
            (f"{h}attention.in_proj_bias", (3 * d,), "bias")]
    linear(f"{h}attention.out_proj", d, d)
    norm(f"{h}layernorm")
    linear(f"{h}mlp.fc1", i, d)
    linear(f"{h}mlp.fc2", d, i)
    return out


def flops_per_image(s: Shape) -> int:
    """Operations of one image's forward from the published shapes: the
    patch convolution, every linear layer, the attention scores and their
    product with the values, and the head's single-query attention, a
    multiply-add counting 2 (LayerNorm, softmax and the activation left
    out, as a FLOP counter of products leaves them out)."""
    d, t, i = s.hidden_size, s.tokens, s.intermediate_size
    patch = 2 * t * d * 3 * s.patch_size ** 2
    layer = (4 * 2 * t * d * d  # q, k, v, out
             + 2 * 2 * t * t * d  # scores and values, over all heads
             + 2 * 2 * t * d * i)  # fc1, fc2
    head = (2 * 2 * t * d * d  # k and v over the tokens
            + 2 * 2 * d * d  # the probe's q, the output projection
            + 2 * 2 * t * d  # one query's scores and values
            + 2 * 2 * d * i)  # fc1, fc2
    return patch + s.num_hidden_layers * layer + head


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (B, H, W, 3) -> normalised RGB float32 (B, 3, H, W)."""
    x = images.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    mean = torch.tensor(MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


def forward(w: dict[str, torch.Tensor], s: Shape,
            x: torch.Tensor) -> torch.Tensor:
    """Pooled embeddings (B, hidden_size) of a normalised batch."""
    p = "vision_model."
    d, h, hd = s.hidden_size, s.num_attention_heads, s.head_dim

    def ln(y, name):
        return F.layer_norm(y, (d,), w[f"{name}.weight"], w[f"{name}.bias"],
                            EPS)

    def lin(y, name):
        return F.linear(y, w[f"{name}.weight"], w[f"{name}.bias"])

    def mlp(y, name):
        return lin(F.gelu(lin(y, f"{name}.fc1"), approximate="tanh"),
                   f"{name}.fc2")

    def attend(q, k, v):
        """q (b, tq, d), k and v (b, t, d) -> (b, tq, d)."""
        b = q.shape[0]

        def heads(z):
            return z.view(b, -1, h, hd).transpose(1, 2)

        scores = (heads(q) * hd ** -0.5) @ heads(k).transpose(-1, -2)
        a = torch.softmax(scores, dim=-1) @ heads(v)
        return a.transpose(1, 2).reshape(b, -1, d)

    y = F.conv2d(x, w[f"{p}embeddings.patch_embedding.weight"],
                 w[f"{p}embeddings.patch_embedding.bias"],
                 stride=s.patch_size)
    y = y.flatten(2).transpose(1, 2) + w[
        f"{p}embeddings.position_embedding.weight"]
    for i in range(s.num_hidden_layers):
        q = f"{p}encoder.layers.{i}."
        z = ln(y, f"{q}layer_norm1")
        y = y + lin(attend(lin(z, f"{q}self_attn.q_proj"),
                           lin(z, f"{q}self_attn.k_proj"),
                           lin(z, f"{q}self_attn.v_proj")),
                    f"{q}self_attn.out_proj")
        y = y + mlp(ln(y, f"{q}layer_norm2"), f"{q}mlp")
    y = ln(y, f"{p}post_layernorm")
    hp = f"{p}head."
    win = w[f"{hp}attention.in_proj_weight"]
    bin_ = w[f"{hp}attention.in_proj_bias"]
    probe = w[f"{hp}probe"].expand(y.shape[0], 1, d)
    a = attend(F.linear(probe, win[:d], bin_[:d]),
               F.linear(y, win[d:2 * d], bin_[d:2 * d]),
               F.linear(y, win[2 * d:], bin_[2 * d:]))
    pooled = lin(a, f"{hp}attention.out_proj")
    pooled = pooled + mlp(ln(pooled, f"{hp}layernorm"), f"{hp}mlp")
    return pooled[:, 0]


@torch.no_grad()
def embed(w: dict[str, torch.Tensor], s: Shape, images: torch.Tensor,
          block: int = 64) -> torch.Tensor:
    """Float32 embeddings of BGR uint8 images, ``block`` rows at a time
    (at 729 tokens a block's float32 logits are 2.2 GB a layer)."""
    with no_tf32():
        return torch.cat([forward(w, s, preprocess(images[i:i + block]))
                          for i in range(0, images.shape[0], block)])
