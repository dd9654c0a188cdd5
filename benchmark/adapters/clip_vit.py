"""A CLIP vision tower's HuggingFace tensors as the program's variables."""

from __future__ import annotations

import numpy as np


def to_program(weights: dict) -> dict:
    w = {k: v.detach().cpu().numpy() for k, v in weights.items()}
    p = "vision_model."

    def norm(name: str) -> dict:
        return {"scale": w[f"{name}.weight"], "bias": w[f"{name}.bias"]}

    def dense(name: str, bias: bool = True) -> dict:
        out = {"kernel": w[f"{name}.weight"].T}
        if bias:
            out["bias"] = w[f"{name}.bias"]
        return out

    cls = w[f"{p}embeddings.class_embedding"]
    pos = w[f"{p}embeddings.position_embedding.weight"]
    params = {
        "patch": {"kernel": np.transpose(
            w[f"{p}embeddings.patch_embedding.weight"], (2, 3, 1, 0))},
        "class_token": cls.reshape(1, 1, -1),
        "pos_embed": pos[None],
        "ln_pre": norm(f"{p}pre_layrnorm"),
        "ln_post": norm(f"{p}post_layernorm"),
        "projection": dense("visual_projection", bias=False),
    }
    i = 0
    while f"{p}encoder.layers.{i}.layer_norm1.weight" in w:
        q = f"{p}encoder.layers.{i}."
        params[f"block{i}"] = {
            "ln1": norm(f"{q}layer_norm1"),
            "q": dense(f"{q}self_attn.q_proj"),
            "k": dense(f"{q}self_attn.k_proj"),
            "v": dense(f"{q}self_attn.v_proj"),
            "proj": dense(f"{q}self_attn.out_proj"),
            "ln2": norm(f"{q}layer_norm2"),
            "mlp_up": dense(f"{q}mlp.fc1"),
            "mlp_down": dense(f"{q}mlp.fc2"),
        }
        i += 1
    return {"params": params}
