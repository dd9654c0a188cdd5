"""Embedder registry and the batched embed executor on PyTorch.

Counterpart of ``imageclust_tpu/models/registry.py``: ``resnet50`` (the
1000-d logits the reference reads as its embedding, embeddings.go:140, or
the 2048-d pooled features) and the ViT/SigLIP towers of
:data:`~.vit.VIT_CONFIGS` (``vit_b32``, ``vit_b16``, ``vit_l14``,
``vit_l14_336``, ``siglip_so400m``; the projected embedding). Of these,
``siglip_so400m`` is the JAX package's SigLIP-style tower, not the
published model; the port adds ``siglip_so400m_384``, the published SigLIP
So400m/14@384 vision tower (its 1152-d attention-pooled embedding, no
projection), which the JAX package does not have.
``quantize="int8"`` builds the int8 PTQ variant of either family
(:mod:`.quantize`, :mod:`.quantize_vit`), calibrated after any weight
load. ``embed.checkpoint_path`` restores a tuned ResNet50 from an Orbax
checkpoint (either package's); else ``embed.onnx_path`` loads the
reference's resnet50-v1-7.onnx when the file exists (random init, with a
warning, when it does not).

Images arrive as one uint8 BGR (N, H, W, 3) batch. At the input size the
ResNet50 batch goes straight into the s2d stem (raw uint8, scale and
channel flip folded into conv0) and a ViT batch is flipped to RGB and
normalised on the device (JAX ``_embed_fn``); other sizes take the device
resize first. Batches are padded to the smallest power of two that covers
the job (capped at ``batch_size``), as the JAX executor does.

With ``mesh=`` (JAX registry.py:79-137) the executor is data-parallel
over the mesh's ``data`` ranks: the batch size rounds to a multiple of D,
each rank embeds its row block of the job (``rows_per = ceil(n / D)``
rows) with the weights it holds, and the features come back row-sharded
(:class:`~imageclust_tpu_torch.core.mesh.ShardedRows`, for the engines)
or gathered (``embed``, the whole array on every rank).
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
from imageclust_tpu_torch.models.quantize_vit import QuantViT
from imageclust_tpu_torch.models.resnet50 import ResNet50V1
from imageclust_tpu_torch.models.vit import (
    VIT_CONFIGS,
    VisionTransformer,
    load_clip_vision_state_dict,
    load_siglip_vision_state_dict,
)
from imageclust_tpu_torch.ops.pref_kernels import to_grid
from imageclust_tpu_torch.ops.preprocess import preprocess_batch

log = logging.getLogger(__name__)

__all__ = ["DEFAULT_BATCH", "Embedder", "EmbedderSpec", "create_embedder",
           "list_models"]

# The JAX package's per-tower batch defaults (EmbedConfig.batch_size = 0),
# and the port's own tower's.
DEFAULT_BATCH = {
    "resnet50": 512,
    "vit_b32": 1024,
    "vit_b16": 256,
    "vit_l14": 128,
    "vit_l14_336": 64,
    "siglip_so400m": 128,
    "siglip_so400m_384": 128,
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
    return ["resnet50", *VIT_CONFIGS]


class Embedder:
    """Batched embedding executor for one tower on one device, or
    data-parallel over a mesh's ``data`` ranks (``mesh``; the device is
    then the mesh's)."""

    def __init__(self, spec: EmbedderSpec, model: torch.nn.Module,
                 batch_size: int, device: torch.device, tag: str = "",
                 pooled: bool = False, weights_loaded: bool = False,
                 mesh=None):
        from imageclust_tpu_torch.core.mesh import check_mesh

        self.mesh = check_mesh(mesh)
        if mesh is not None:
            device = mesh.device
            # the effective size everyone sees: producers chunk at it
            ndata = mesh.shape["data"]
            batch_size = max(ndata, batch_size // ndata * ndata)
        self.spec = spec
        self.model = model.to(device).eval()
        self._vit = isinstance(model, (VisionTransformer, QuantViT))
        self.batch_size = batch_size
        self.device = device
        self.tag = tag or spec.name  # identity for the embedding cache
        self.pooled = pooled
        # provenance: True iff real weights were ingested
        self.weights_loaded = weights_loaded

    def load_flax_variables(self, variables: Mapping) -> None:
        """Load the JAX package's Flax variables (nested numpy dicts) into
        the tower, so both packages run the same numbers."""
        _load_flax(self.model, variables)
        self.model.to(self.device)

    @torch.inference_mode()
    def _forward(self, chunk: torch.Tensor) -> torch.Tensor:
        spec = self.spec
        at_size = chunk.shape[1:3] == (spec.input_size, spec.input_size)
        if at_size and not self._vit and self.model.stem_mode == "s2d_raw":
            logits, feats = self.model(chunk, return_features=True)
            return feats if self.pooled else logits
        if at_size:  # JAX registry.py:162-168
            x = chunk.to(torch.float32)
            if spec.bgr_input:
                x = x.flip(-1)
            mean = torch.tensor(spec.mean, device=x.device)
            std = torch.tensor(spec.std, device=x.device)
            x = (x * spec.scale - mean) / std
        else:
            x = preprocess_batch(
                chunk, size=spec.input_size, scale=spec.scale,
                mean=spec.mean, std=spec.std, bgr_to_rgb=spec.bgr_input,
                channels_first=False)
        return self._tower(x)

    def _tower(self, x: torch.Tensor) -> torch.Tensor:
        """The tower on a preprocessed float batch, NHWC or NCHW (JAX
        ``_apply_fn``)."""
        if self._vit:
            return self.model(x)
        logits, feats = self.model(x, return_features=True,
                                   stem_mode="standard")
        return feats if self.pooled else logits

    def _embed_chunks(self, images) -> list[torch.Tensor]:
        images = np.asarray(images)
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(f"expected (N,H,W,3), got {images.shape}")
        n = images.shape[0]
        # smallest power-of-two batch that covers the job, capped at
        # batch_size (JAX registry.py:195-198)
        bs = min(self.batch_size, max(8, 1 << (n - 1).bit_length()))
        if self.mesh is not None:  # this rank's rows, its share of a batch
            from imageclust_tpu_torch.core.mesh import row_block

            ndata = self.mesh.shape["data"]
            bs = max(ndata, bs // ndata * ndata) // ndata
            r0, n = row_block(n, self.mesh)
            images = images[r0:r0 + n]
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
        Returns float32 (N, dim) on the host (on a mesh: every rank embeds
        its rows, and every rank gets the whole array)."""
        if self.mesh is not None:
            return self.embed_device(images).gather().float().cpu().numpy()
        chunks = self._embed_chunks(images)
        if not chunks:
            return np.zeros((0, self.spec.dim), np.float32)
        return torch.cat(chunks).float().cpu().numpy()

    @torch.inference_mode()
    def embed_blob(self, blob) -> np.ndarray:
        """Embed an already-preprocessed float32 (N, 3, S, S) blob, the
        exact tensor the reference feeds its DNN (embeddings.go:103; JAX
        registry.py:380-387). Returns float32 (N, dim) on the host. On a
        mesh every rank embeds the whole blob on its own device."""
        x = torch.from_numpy(np.ascontiguousarray(blob, np.float32)).to(
            self.device)
        return self._tower(x).float().cpu().numpy()

    def embed_device(self, images):
        """Like :meth:`embed` but the result stays on the device: a tensor,
        or on a mesh this rank's row block as ``ShardedRows``."""
        chunks = self._embed_chunks(images)
        if self.mesh is None:
            return torch.cat(chunks)
        from imageclust_tpu_torch.core.mesh import ShardedRows

        local = torch.cat(chunks) if chunks else torch.zeros(
            (0, self.spec.dim), device=self.device)
        return ShardedRows.pad(local, len(images), self.mesh)

    def embed_stream(self, chunks, inflight: int = 4,
                     total: int | None = None) -> torch.Tensor:
        """Embed an iterable of uint8 (b, S, S, 3) chunks (S = input size,
        b <= batch_size) and return float32 (N, dim) on the device.

        While the card runs chunk k the producer (e.g.
        :func:`imageclust_tpu_torch.data.loader.stream_decode`) decodes
        chunk k+1. ``inflight`` bounds the work queued ahead of the card:
        every ``inflight`` chunks the host waits for the CUDA event recorded
        one window back (a lagged fence, so the queue never drains)."""
        return self.embed_stream_quantized(chunks, inflight, total=total)[0]

    @torch.inference_mode()
    def embed_stream_quantized(self, chunks, inflight: int = 4,
                               out_dtype=None, margin: float = 1.25,
                               total: int | None = None):
        """The stream loop (JAX registry.py:251-378) with each chunk cast to
        a residency dtype before it accumulates, so the f32 matrix never
        exists. ``out_dtype`` None or float32: identity; torch.bfloat16: a
        per-chunk rounding; torch.int8: a symmetric grid with its scale
        calibrated on the FIRST chunk (absmax * ``margin`` / 127, at least
        1e-30; later outliers clip). Returns ``(embeddings, scale)``;
        scale is 1.0 unless int8: divide any block concatenated onto these
        features (label fusion) by it.

        Chunks are host arrays or uint8 tensors (a CUDA tensor feeds the
        forward with no transfer). ``total``: the job size, when known;
        embeddings then go into ONE preallocated (total, dim) buffer of the
        residency dtype, so the list path's final concatenation (2x the
        feature bytes) never happens.

        On a mesh each rank passes the chunks of ITS row block (rows
        ``[d * ceil(total / D), ...)`` of the job, in order; ``total`` is
        the job's size and required) and gets its block back as
        ``ShardedRows``. The int8 scale is then the single device's: the
        largest |value| of the job's first ``batch_size`` rows, taken
        across ranks (one all_gather, which every rank joins at its first
        chunk)."""
        if self.mesh is not None and total is None:
            raise ValueError("a mesh stream needs total= (the job's size)")
        if out_dtype in (None, torch.float32, np.float32, "float32"):
            out_dtype = torch.float32
        elif out_dtype not in (torch.bfloat16, torch.int8):
            raise ValueError(f"unsupported residency dtype {out_dtype}")
        bs = self.batch_size
        expect = (self.spec.input_size, self.spec.input_size, 3)
        buf = None
        n_out = total
        if self.mesh is not None:
            from imageclust_tpu_torch.core.mesh import row_block

            row0, n_out = row_block(total, self.mesh)
        if total is not None:
            buf = torch.empty((n_out, self.spec.dim), dtype=out_dtype,
                              device=self.device)
        outs: list[torch.Tensor] = []
        written = 0
        n_chunks = 0
        scale = 1.0
        fence = None
        for chunk in chunks:
            if not isinstance(chunk, torch.Tensor):
                chunk = torch.from_numpy(np.ascontiguousarray(chunk))
            if tuple(chunk.shape[1:]) != expect or chunk.shape[0] > bs:
                raise ValueError(
                    f"stream chunk must be (<= {bs}, {expect}), "
                    f"got {tuple(chunk.shape)}")
            c = chunk.shape[0]
            x = chunk.to(self.device, non_blocking=True)
            if c < bs:  # pad to the one batch shape
                x = torch.cat([x, x.new_zeros((bs - c, *expect))])
            emb = self._forward(x).to(torch.float32)
            emb = emb[:c] if c < bs else emb
            if out_dtype == torch.int8:
                if n_chunks == 0:  # one host read, first chunk only
                    if self.mesh is not None:
                        scale = self._mesh_scale(emb[:max(0, bs - row0)],
                                                 margin)
                    else:
                        scale = max(float(torch.amax(torch.abs(emb)))
                                    * margin / 127.0, 1e-30)
                    s = torch.tensor(scale, dtype=torch.float32,
                                     device=emb.device)
                emb = to_grid(emb, s)
            else:
                emb = emb.to(out_dtype)
            n_chunks += 1
            if buf is not None:
                if written + c > total:
                    raise ValueError(
                        f"stream yielded more than total={total} rows")
                buf[written:written + c] = emb
            else:
                outs.append(emb)
            written += c
            if (inflight and n_chunks % inflight == 0
                    and self.device.type == "cuda"):
                if fence is not None:
                    fence.synchronize()  # bound the queued work
                fence = torch.cuda.Event()
                fence.record()
        if (self.mesh is not None and out_dtype == torch.int8
                and n_chunks == 0):  # join the calibration all the same
            scale = self._mesh_scale(buf[:0], margin)
        if buf is not None:
            if written != n_out:
                mine = "" if self.mesh is None else (
                    f" ({n_out} in this rank's block)")
                raise ValueError(f"stream yielded {written} rows, expected "
                                 f"total={total}{mine}")
            if self.mesh is not None:
                from imageclust_tpu_torch.core.mesh import ShardedRows

                return ShardedRows.pad(buf, total, self.mesh), scale
            return buf, scale
        if not outs:
            return torch.zeros((0, self.spec.dim), dtype=out_dtype,
                               device=self.device), scale
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), scale


    def _mesh_scale(self, first_rows: torch.Tensor, margin: float) -> float:
        """The int8 scale from the job's first ``batch_size`` rows across
        the mesh's ranks (``first_rows``: this rank's share of them)."""
        from imageclust_tpu_torch.core.collectives import pmax

        amax = (torch.amax(torch.abs(first_rows)) if first_rows.numel()
                else torch.zeros((), device=self.device))
        amax = pmax(amax.view(1).float(), self.mesh)[0]
        return max(float(amax) * margin / 127.0, 1e-30)


def _load_flax(model: torch.nn.Module, variables: Mapping) -> None:
    """Load the JAX package's Flax variables (nested numpy dicts) into a
    float tower."""
    from imageclust_tpu_torch.models.convert import (
        resnet50_state_dict_from_flax,
        vit_state_dict_from_flax,
    )

    if isinstance(model, VisionTransformer):
        sd = vit_state_dict_from_flax(variables, model.cfg)
    elif isinstance(model, ResNet50V1):
        sd = resnet50_state_dict_from_flax(
            variables, stage_layers=model.stage_layers,
            num_classes=model.num_classes, fold_bn=model.fold_bn)
    else:
        raise TypeError("Flax variables load into a float tower; build an "
                        "int8 tower with create_embedder(..., variables=)")
    model.load_state_dict(sd)


def _calib_batch(size: int, weights_loaded: bool) -> np.ndarray:
    """int8 calibration batch (JAX registry.py:390-409): the
    IMAGECLUST_CALIB_NPY uint8 sample when set (its first 32 images), else
    seeded uniform noise (8 images, the JAX package's). Production: point
    IMAGECLUST_CALIB_NPY at a (B, size, size, 3) uint8 BGR sample of the
    corpus (warned when real weights calibrate on noise)."""
    calib_path = os.environ.get("IMAGECLUST_CALIB_NPY", "")
    if calib_path and os.path.exists(calib_path):
        return np.load(calib_path)[:32]
    if weights_loaded:
        log.warning(
            "int8 calibration is running on SYNTHETIC uniform-noise images "
            "against real (non-random-init) weights — the activation scales "
            "will not reflect real data and may clip; set "
            "IMAGECLUST_CALIB_NPY to a (B,%d,%d,3) uint8 sample of your "
            "corpus", size, size,
        )
    return np.random.default_rng(0).integers(
        0, 256, (8, size, size, 3), np.uint8)


def _quantize(model: torch.nn.Module, spec: EmbedderSpec, cfg: EmbedConfig,
              weights_loaded: bool) -> torch.nn.Module:
    """The int8 tower of ``model`` (loaded weights, on its device),
    calibrated on :func:`_calib_batch` normalised as the embedder
    normalises a batch (BGR -> RGB, 1/255, the tower's mean/std)."""
    from imageclust_tpu_torch.models.quantize import quantize_resnet50
    from imageclust_tpu_torch.models.quantize_vit import quantize_vit

    calib = _calib_batch(spec.input_size, weights_loaded).astype(
        np.float32)[..., ::-1] / 255.0  # BGR -> RGB, as JAX builds it
    calib = ((calib - np.asarray(spec.mean, np.float32))
             / np.asarray(spec.std, np.float32))
    if isinstance(model, VisionTransformer):
        return quantize_vit(model, calib, calib_method=cfg.calib_method)
    return quantize_resnet50(model, calib, calib_method=cfg.calib_method)


def _quant_suffix(cfg: EmbedConfig) -> str:
    return f":{cfg.quantize}-{cfg.calib_method}" if cfg.quantize else ""


def _weights_tag(cfg: EmbedConfig, seed: int, checkpoint: str = "") -> str:
    """Embedding-cache identity. The port's random init differs from the JAX
    package's (torch.Generator vs jax.random), so its tag differs too: a
    shared cache never mixes the two. An existing ``embed.checkpoint_path``
    (Orbax) is fingerprinted as the JAX package does (``ckpt-`` and the
    sha256 of its path, size and mtime), whichever tower is built; else a
    loaded ``checkpoint`` (ONNX or HF) is (its first MiB, size, mtime).
    An int8 tower adds the JAX package's ``:{quantize}-{calib_method}``:
    its embeddings differ from the float tower's, and the calibration
    statistic changes them."""
    q = _quant_suffix(cfg)
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        # JAX registry.py:583-588: path, size and mtime of the checkpoint
        st = os.stat(cfg.checkpoint_path)
        fp = hashlib.sha256(
            f"{cfg.checkpoint_path}:{st.st_size}:{int(st.st_mtime)}".encode()
        ).hexdigest()[:12]
        return f"{cfg.model}:{cfg.output}{q}:torch-ckpt-{fp}"
    if checkpoint:
        h = hashlib.sha256()
        with open(checkpoint, "rb") as fh:
            h.update(fh.read(1 << 20))
        st = os.stat(checkpoint)
        h.update(str((st.st_size, int(st.st_mtime))).encode())
        return f"{cfg.model}:{cfg.output}{q}:torch-{h.hexdigest()[:12]}"
    return f"{cfg.model}:{cfg.output}{q}:torch-randominit-{seed}"


def _build_resnet50(cfg: EmbedConfig, seed: int):
    """ResNet50 with the Orbax checkpoint at ``embed.checkpoint_path`` (a
    tuned tower, ``cfg.num_classes`` wide) when it exists, else the ONNX
    weights at ``embed.onnx_path`` when that file exists (JAX
    registry.py:418-434), else seeded random init. Returns (spec, model,
    pooled, loaded path or "")."""
    from imageclust_tpu_torch.models.convert import (
        resnet50_flax_from_state_dict,
        resnet50_state_dict_from_flax,
    )
    from imageclust_tpu_torch.models.resnet50 import load_onnx_params
    from imageclust_tpu_torch.utils.checkpoint import restore_variables

    model = ResNet50V1(num_classes=cfg.num_classes, dtype=cfg.dtype,
                       norm_dtype=cfg.norm_dtype,
                       stem_mode="s2d_raw" if cfg.s2d_stem else "standard")
    loaded = ""
    if cfg.checkpoint_path and os.path.exists(cfg.checkpoint_path):
        # the fresh model is the template: a head of another width or a
        # missing tensor raises, naming the leaf
        restored = restore_variables(cfg.checkpoint_path,
                                     resnet50_flax_from_state_dict(model))
        model.load_state_dict(resnet50_state_dict_from_flax(
            restored, stage_layers=model.stage_layers,
            num_classes=cfg.num_classes, fold_bn=False))
        loaded = cfg.checkpoint_path
        log.info("restored checkpoint %s", cfg.checkpoint_path)
    elif cfg.onnx_path and os.path.exists(cfg.onnx_path):
        model.load_state_dict(load_onnx_params(cfg.onnx_path, model))
        loaded = cfg.onnx_path
        log.info("loaded ONNX weights from %s", cfg.onnx_path)
    else:
        log.warning("ONNX checkpoint %s not found — using random init "
                    "(torch.Generator seed %d)", cfg.onnx_path, seed)
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
    return spec, model, pooled, loaded


def _build_vit(name: str, cfg: EmbedConfig, seed: int):
    """The ViT/SigLIP tower ``name`` with seeded random init, or the HF
    vision checkpoint at ``embed.onnx_path`` when it is a ``.npz``,
    ``.pt`` or ``.bin`` file (JAX registry.py:499-571): a
    ``SiglipVisionModel``'s for the tower with the attention-pooling head,
    else a ``CLIPVisionModel``'s. The config's default ``.onnx`` path is
    skipped quietly; any other path that cannot be loaded is warned about. ``embed.checkpoint_path`` does not load
    weights here, as in the JAX package (registry.py:499-520); it only
    enters the cache tag. Returns (spec, model, loaded path or "")."""
    vcfg = VIT_CONFIGS[name]
    model = VisionTransformer(vcfg, dtype=cfg.dtype, norm_dtype=cfg.norm_dtype)
    model.init_random(seed)
    ckpt = cfg.onnx_path
    loaded = ""
    if ckpt and os.path.exists(ckpt) and ckpt.endswith((".pt", ".bin",
                                                         ".npz")):
        # every tensor but an absent projection (kept from the init)
        model.load_state_dict(_load_vit_checkpoint(ckpt, vcfg), strict=False)
        loaded = ckpt
        log.info("loaded ViT checkpoint %s", ckpt)
    elif ckpt and not ckpt.endswith(".onnx"):
        # .onnx is the config's resnet-oriented default: skipping it for a
        # ViT tower is intended; any other path was an explicit ask
        log.warning(
            "ViT checkpoint %s not loaded (%s) — using random init "
            "(torch.Generator seed %d)", ckpt,
            "file missing" if not os.path.exists(ckpt)
            else "unsupported extension; want .pt/.bin/.npz", seed)
    spec = EmbedderSpec(
        name=name,
        input_size=vcfg.image_size,
        dim=vcfg.embed_dim,
        scale=1.0 / 255.0,
        mean=vcfg.mean,
        std=vcfg.std,
        bgr_input=True,
    )
    return spec, model, loaded


def _load_vit_checkpoint(path: str, vcfg) -> dict[str, torch.Tensor]:
    if path.endswith(".npz"):
        with np.load(path) as z:
            sd = dict(z)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if vcfg.map_head:
        return load_siglip_vision_state_dict(sd, vcfg)
    return load_clip_vision_state_dict(sd, vcfg)


def create_embedder(
    cfg: EmbedConfig | None = None,
    *,
    device: str | torch.device | None = None,
    seed: int = 0,
    variables: Mapping | None = None,
    mesh=None,
) -> Embedder:
    """Build the configured tower on ``device`` (default ``"cuda"``).
    ``variables``: Flax variables from the JAX package to load instead of
    the seeded random init. With ``embed.quantize="int8"`` the tower is
    quantized after its weights are loaded (ONNX, HF checkpoint or
    ``variables``), calibrating on the device. ``mesh``: the data-parallel
    executor on the mesh's device (every rank builds the same tower)."""
    cfg = cfg or EmbedConfig()
    dev = mesh.device if mesh is not None else resolve_device(device)
    if cfg.quantize not in ("", "int8"):
        raise ValueError(f"unknown quantize mode {cfg.quantize!r}")
    if cfg.model not in list_models():
        raise ValueError(f"unknown model {cfg.model!r}; know {list_models()}")
    if cfg.model == "resnet50":
        spec, model, pooled, loaded = _build_resnet50(cfg, seed)
    else:
        spec, model, loaded = _build_vit(cfg.model, cfg, seed)
        pooled = False
    tag = _weights_tag(cfg, seed, loaded)
    if variables is not None:
        _load_flax(model, variables)
        h = hashlib.sha256()
        for k, v in sorted(model.state_dict().items()):
            h.update(k.encode())
            h.update(v.detach().cpu().numpy().tobytes())
        tag = (f"{cfg.model}:{cfg.output}{_quant_suffix(cfg)}:"
               f"flax-{h.hexdigest()[:12]}")
    weights_loaded = bool(loaded)
    if cfg.quantize == "int8":
        model = _quantize(model.to(dev), spec, cfg, weights_loaded)
    batch = cfg.batch_size or DEFAULT_BATCH[cfg.model]
    return Embedder(spec, model, batch, dev, tag=tag, pooled=pooled,
                    weights_loaded=weights_loaded, mesh=mesh)
