"""Embedder registry and the batched embed executor on PyTorch.

Counterpart of ``imageclust_tpu/models/registry.py`` for the main path's
tower: ``resnet50`` (the 1000-d logits the reference reads as its
embedding, embeddings.go:140, or the 2048-d pooled features). The
ViT/SigLIP towers and ``quantize="int8"`` are not ported yet and raise
``NotImplementedError`` (ROADMAP.md queue 1).

Images arrive as one uint8 BGR (N, H, W, 3) batch. At the input size they
go straight into the s2d stem (raw uint8, scale and channel flip folded
into conv0); other sizes take the device resize first. Batches are padded
to the smallest power of two that covers the job (capped at
``batch_size``), as the JAX executor does.
"""

from __future__ import annotations

import hashlib
import logging
import os
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from imageclust_tpu_torch.config import EmbedConfig
from imageclust_tpu_torch.device import resolve_device
from imageclust_tpu_torch.ops.preprocess import preprocess_batch

log = logging.getLogger(__name__)

__all__ = ["DEFAULT_BATCH", "Embedder", "EmbedderSpec", "create_embedder",
           "list_models"]

# The JAX package's per-tower batch defaults (EmbedConfig.batch_size = 0).
DEFAULT_BATCH = {
    "resnet50": 512,
    "vit_b32": 1024,
    "vit_b16": 256,
    "vit_l14": 128,
    "vit_l14_336": 64,
    "siglip_so400m": 128,
}


@dataclass(frozen=True)
class EmbedderSpec:
    name: str
    input_size: int
    dim: int
    scale: float
    mean: tuple[float, float, float]
    std: tuple[float, float, float]
    # reference keeps BGR->RGB conversion before the blob (embeddings.go:82)
    bgr_input: bool


def list_models() -> list[str]:
    """Towers this port can build."""
    return ["resnet50"]


class Embedder:
    """Batched embedding executor for one tower on one device."""

    def __init__(self, spec: EmbedderSpec, model: torch.nn.Module,
                 batch_size: int, device: torch.device, tag: str = "",
                 pooled: bool = False, weights_loaded: bool = False):
        self.spec = spec
        self.model = model.to(device).eval()
        self.batch_size = batch_size
        self.device = device
        self.tag = tag or spec.name  # identity for the embedding cache
        self.pooled = pooled
        # provenance: True iff real weights were ingested
        self.weights_loaded = weights_loaded

    def load_flax_variables(self, variables: Mapping) -> None:
        """Load the JAX package's Flax variables (nested numpy dicts) into
        the tower, so both packages run the same numbers."""
        from imageclust_tpu_torch.models.convert import (
            resnet50_state_dict_from_flax,
        )

        sd = resnet50_state_dict_from_flax(
            variables, stage_layers=self.model.stage_layers,
            num_classes=self.model.num_classes, fold_bn=self.model.fold_bn)
        self.model.load_state_dict(sd)
        self.model.to(self.device)

    @torch.inference_mode()
    def _forward(self, chunk: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        if chunk.shape[1:3] == (spec.input_size, spec.input_size):
            if self.model.stem_mode == "s2d_raw":
                out = self.model(chunk, return_features=True)
            else:
                x = chunk.to(torch.float32)
                if spec.bgr_input:
                    x = x.flip(-1)
                mean = torch.tensor(spec.mean, device=x.device)
                std = torch.tensor(spec.std, device=x.device)
                x = (x * spec.scale - mean) / std
                out = self.model(x, return_features=True,
                                 stem_mode="standard")
        else:
            x = preprocess_batch(
                chunk, size=spec.input_size, scale=spec.scale,
                mean=spec.mean, std=spec.std, bgr_to_rgb=spec.bgr_input,
                channels_first=False)
            out = self.model(x, return_features=True, stem_mode="standard")
        logits, feats = out
        return feats if self.pooled else logits

    def _embed_chunks(self, images) -> list[torch.Tensor]:
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (N,H,W,3), got {images.shape}")
        n = images.shape[0]
        # smallest power-of-two batch that covers the job, capped at
        # batch_size (JAX registry.py:195-198)
        bs = min(self.batch_size, max(8, 1 << (n - 1).bit_length()))
        chunks = []
        for start in range(0, n, bs):
            chunk = images[start:start + bs]
            c = chunk.shape[0]
            if c < bs:  # pad the tail to the batch shape
                pad = np.zeros((bs - c, *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            x = torch.from_numpy(np.ascontiguousarray(chunk)).to(
                self.device, non_blocking=True)
            emb = self._forward(x)
            chunks.append(emb[:c] if c < bs else emb)
        return chunks

    def embed(self, images) -> np.ndarray:
        """Embed a uint8 (N, H, W, 3) batch (BGR if spec.bgr_input).
        Returns float32 (N, dim) on the host."""
        chunks = self._embed_chunks(images)
        if not chunks:
            return np.zeros((0, self.spec.dim), np.float32)
        return torch.cat(chunks).float().cpu().numpy()

    def embed_device(self, images) -> torch.Tensor:
        """Like :meth:`embed` but the result stays on the device."""
        return torch.cat(self._embed_chunks(images))


def _weights_tag(cfg: EmbedConfig, seed: int) -> str:
    """Embedding-cache identity. The port's random init differs from the JAX
    package's (torch.Generator vs jax.random), so its tag differs too: a
    shared cache never mixes the two."""
    return f"{cfg.model}:{cfg.output}:torch-randominit-{seed}"


def _build_resnet50(cfg: EmbedConfig, seed: int):
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1

    if cfg.checkpoint_path:
        raise NotImplementedError(
            "embed.checkpoint_path (Orbax) is not ported yet (ROADMAP.md "
            "queue 1, tooling)")
    if cfg.onnx_path and os.path.exists(cfg.onnx_path):
        raise NotImplementedError(
            f"loading ONNX weights ({cfg.onnx_path}) is not ported yet "
            "(ROADMAP.md queue 1, ONNX ingestion); move the file away to "
            "run with random init")
    log.warning("ONNX checkpoint %s not found — using random init "
                "(torch.Generator seed %d)", cfg.onnx_path, seed)
    model = ResNet50V1(num_classes=cfg.num_classes, dtype=cfg.dtype,
                       norm_dtype=cfg.norm_dtype,
                       stem_mode="s2d_raw" if cfg.s2d_stem else "standard")
    model.init_random(seed)
    pooled = cfg.output == "pooled"
    spec = EmbedderSpec(
        name="resnet50",
        input_size=224,
        dim=2048 if pooled else cfg.num_classes,
        scale=1.0 / 255.0,  # embeddings.go:96 — no mean/std
        mean=(0.0, 0.0, 0.0),
        std=(1.0, 1.0, 1.0),
        bgr_input=True,
    )
    return spec, model, pooled


def create_embedder(
    cfg: EmbedConfig | None = None,
    *,
    device: str | torch.device | None = None,
    seed: int = 0,
    variables: Mapping | None = None,
) -> Embedder:
    """Build the configured tower on ``device`` (default ``"cuda"``).
    ``variables``: Flax variables from the JAX package to load instead of
    the seeded random init."""
    cfg = cfg or EmbedConfig()
    dev = resolve_device(device)
    if cfg.quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
    if cfg.quantize == "int8":
        raise NotImplementedError(
            "embed.quantize='int8' is not ported yet (ROADMAP.md queue 1, "
            "int8 PTQ)")
    if cfg.model in DEFAULT_BATCH and cfg.model != "resnet50":
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet (ROADMAP.md queue 1, "
            "ViT/SigLIP towers)")
    if cfg.model != "resnet50":
        raise ValueError(f"unknown model {cfg.model!r}; know {list_models()}")
    spec, model, pooled = _build_resnet50(cfg, seed)
    batch = cfg.batch_size or DEFAULT_BATCH[cfg.model]
    emb = Embedder(spec, model, batch, dev, tag=_weights_tag(cfg, seed),
                   pooled=pooled)
    if variables is not None:
        emb.load_flax_variables(variables)
        h = hashlib.sha256()
        for k, v in sorted(emb.model.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
        emb.tag = f"{cfg.model}:{cfg.output}:flax-{h.hexdigest()[:12]}"
    return emb
