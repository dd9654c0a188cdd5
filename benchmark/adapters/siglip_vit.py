"""A SigLIP vision tower's HuggingFace tensors, its attention-pooling head
among them, as the program's variables."""

from __future__ import annotations

import numpy as np


def to_program(weights: dict) -> dict:
    w = {k: v.detach().cpu().numpy() for k, v in weights.items()}
    p = "vision_model."

    def norm(name: str) -> dict:
        return {"scale": w[f"{name}.weight"], "bias": w[f"{name}.bias"]}

    def dense(name: str) -> dict:
        return {"kernel": w[f"{name}.weight"].T, "bias": w[f"{name}.bias"]}

    params = {
        "patch": {"kernel": np.transpose(
            w[f"{p}embeddings.patch_embedding.weight"], (2, 3, 1, 0)),
            "bias": w[f"{p}embeddings.patch_embedding.bias"]},
        "pos_embed": w[f"{p}embeddings.position_embedding.weight"][None],
        "ln_post": norm(f"{p}post_layernorm"),
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
    h = f"{p}head."
    win = w[f"{h}attention.in_proj_weight"]
    bin_ = w[f"{h}attention.in_proj_bias"]
    d = win.shape[1]
    params["head"] = {
        "probe": w[f"{h}probe"],
        **{name: {"kernel": win[j * d:(j + 1) * d].T,
                  "bias": bin_[j * d:(j + 1) * d]}
           for j, name in enumerate(("q", "k", "v"))},
        "proj": dense(f"{h}attention.out_proj"),
        "ln": norm(f"{h}layernorm"),
        "mlp_up": dense(f"{h}mlp.fc1"),
        "mlp_down": dense(f"{h}mlp.fc2"),
    }
    return {"params": params}
