"""A plain float32 SigLIP vision tower with its attention-pooling head:
HuggingFace ``SiglipVisionModel``'s ``pooler_output`` written out in
plain ``torch`` operations, the yardstick for the port's
``siglip_so400m_384`` in the CPU tests.

It imports neither JAX nor either package. Weights are a dict of HF-named
tensors (``vision_model.embeddings.patch_embedding.{weight,bias}``,
``...position_embedding.weight``, ``...encoder.layers.{i}.{self_attn.
{q,k,v,out}_proj,layer_norm1,layer_norm2,mlp.fc1,mlp.fc2}``,
``vision_model.post_layernorm``, ``vision_model.head.{probe,attention.
in_proj_weight,attention.in_proj_bias,attention.out_proj,layernorm,mlp.fc1,
mlp.fc2}``), linear weights (out, in); every size but the head count is
read from their shapes. The forward: a valid-padding patch convolution
with bias, the position table, pre-LN layers (scores scaled by
head_dim^-0.5, the tanh GELU, LayerNorm epsilon 1e-6), ``post_layernorm``
over every token, then the probe through ``nn.MultiheadAttention``'s
arithmetic (the packed in-projection split into q, k and v, the output
projection), ``h + mlp(layernorm(h))`` and its one row. The input is the
system's: BGR uint8, flipped to RGB, times 1/255, then (x - 0.5) / 0.5.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

EPS = 1e-6
V = "vision_model."


def random_weights(width: int, depth: int, heads: int, mlp: int, patch: int,
                   tokens: int, seed: int = 0) -> dict[str, torch.Tensor]:
    """Seeded HF-named float32 weights: linear and patch weights of
    variance 1/fan_in, biases, LayerNorm affines, the probe and the
    position table all perturbed so none is left at a trivial value."""
    gen = torch.Generator().manual_seed(seed)
    out = {}

    def put(name, *shape, scale=None, base=0.0):
        if scale is None:
            scale = torch.Size(shape[1:]).numel() ** -0.5
        out[name] = base + scale * torch.randn(shape, generator=gen)

    def linear(name, dout, din):
        put(f"{name}.weight", dout, din)
        put(f"{name}.bias", dout, scale=0.05)

    def norm(name):
        put(f"{name}.weight", width, scale=0.1, base=1.0)
        put(f"{name}.bias", width, scale=0.1)

    put(f"{V}embeddings.patch_embedding.weight", width, 3, patch, patch)
    put(f"{V}embeddings.patch_embedding.bias", width, scale=0.05)
    put(f"{V}embeddings.position_embedding.weight", tokens, width, scale=0.1)
    for i in range(depth):
        q = f"{V}encoder.layers.{i}."
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            linear(f"{q}self_attn.{name}", width, width)
        linear(f"{q}mlp.fc1", mlp, width)
        linear(f"{q}mlp.fc2", width, mlp)
        norm(f"{q}layer_norm1")
        norm(f"{q}layer_norm2")
    norm(f"{V}post_layernorm")
    put(f"{V}head.probe", 1, 1, width, scale=0.5)
    put(f"{V}head.attention.in_proj_weight", 3 * width, width)
    put(f"{V}head.attention.in_proj_bias", 3 * width, scale=0.05)
    linear(f"{V}head.attention.out_proj", width, width)
    norm(f"{V}head.layernorm")
    linear(f"{V}head.mlp.fc1", mlp, width)
    linear(f"{V}head.mlp.fc2", width, mlp)
    return out


def _attend(q, k, v, heads):
    b, tq, d = q.shape
    hd = d // heads

    def split(z):
        return z.reshape(b, -1, heads, hd).transpose(1, 2)

    scores = (split(q) * hd ** -0.5) @ split(k).transpose(-1, -2)
    a = torch.softmax(scores, dim=-1) @ split(v)
    return a.transpose(1, 2).reshape(b, tq, d)


def forward(w: dict[str, torch.Tensor], x: torch.Tensor,
            heads: int) -> torch.Tensor:
    """``pooler_output`` (B, width) of a normalised NCHW float32 batch."""
    pw = w[f"{V}embeddings.patch_embedding.weight"]
    d, patch = pw.shape[0], pw.shape[-1]

    def ln(y, name):
        return F.layer_norm(y, (d,), w[f"{name}.weight"], w[f"{name}.bias"],
                            EPS)

    def lin(y, name):
        return F.linear(y, w[f"{name}.weight"], w[f"{name}.bias"])

    def mlp(y, name):
        return lin(F.gelu(lin(y, f"{name}.fc1"), approximate="tanh"),
                   f"{name}.fc2")

    y = F.conv2d(x, pw, w[f"{V}embeddings.patch_embedding.bias"],
                 stride=patch)
    y = y.flatten(2).transpose(1, 2)
    y = y + w[f"{V}embeddings.position_embedding.weight"]
    i = 0
    while f"{V}encoder.layers.{i}.layer_norm1.weight" in w:
        q = f"{V}encoder.layers.{i}."
        z = ln(y, f"{q}layer_norm1")
        a = _attend(lin(z, f"{q}self_attn.q_proj"),
                    lin(z, f"{q}self_attn.k_proj"),
                    lin(z, f"{q}self_attn.v_proj"), heads)
        y = y + lin(a, f"{q}self_attn.out_proj")
        y = y + mlp(ln(y, f"{q}layer_norm2"), f"{q}mlp")
        i += 1
    y = ln(y, f"{V}post_layernorm")
    h = f"{V}head."
    wq, wk, wv = w[f"{h}attention.in_proj_weight"].chunk(3)
    bq, bk, bv = w[f"{h}attention.in_proj_bias"].chunk(3)
    probe = w[f"{h}probe"].expand(y.shape[0], 1, d)
    a = _attend(F.linear(probe, wq, bq), F.linear(y, wk, bk),
                F.linear(y, wv, bv), heads)
    pooled = lin(a, f"{h}attention.out_proj")
    pooled = pooled + mlp(ln(pooled, f"{h}layernorm"), f"{h}mlp")
    return pooled[:, 0]


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """BGR uint8 (B, H, W, 3) -> normalised RGB float32 (B, 3, H, W)."""
    x = images.flip(-1).permute(0, 3, 1, 2).to(torch.float32) / 255.0
    return (x - 0.5) / 0.5


@torch.no_grad()
def embed(w: dict[str, torch.Tensor], images: torch.Tensor,
          heads: int) -> torch.Tensor:
    """Float32 embeddings of BGR uint8 images, TF32 off."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return forward(w, preprocess(images), heads)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
