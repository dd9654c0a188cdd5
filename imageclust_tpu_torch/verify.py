"""One-command weight-parity gate: ``imageclust-torch verify --onnx <file>``.

A user holding the real ``resnet50-v1-7.onnx`` (or any compatible export)
runs one command and gets a verdict covering the full parity chain the
reference defines (the JAX package's ``verify.py``, with the port's towers
and engine on ``device``):

1. **Ingest** — the ONNX initializers load into the port's float32
   ResNet50 through the gluon-name converter with shape validation
   (models/resnet50.py ``load_onnx_params``).
2. **Embed** — fixed, seeded synthetic images (or ``--images dir``) go
   through OUR forward on ``device`` (the reference's numerics: BGR->RGB,
   1/255, no mean/std — embeddings.go:46-116), float32 with TF32 off
   (``device.resolve_device``).
3. **Cross-runtime compare** — the SAME blobs run through OpenCV DNN
   (``cv2.dnn.readNetFromONNX``), the exact runtime the reference drives
   via gocv (embeddings.go:28-43), reading the same
   ``resnetv17_dense0_fwd`` head (embeddings.go:140). Gate: per-image
   cosine > 1 - 1e-5 (SURVEY §7 "hard parts" threshold). cv2 is imported
   inside :func:`verify_onnx` only; without it the gate raises.
4. **Assignment equality** — both embedding sets cluster through the
   exact engine on ``device`` (K1 on a card); the partitions must match.

With ``--clip``/``--bpe``, the CLIP tower and byte-level BPE tokenizer are
additionally loaded and sanity-gated (dims, finite outputs, golden
tokenization shape); there is no second independent CLIP runtime, so these
are load-and-shape gates, not numerics gates. They need no cv2.
"""

from __future__ import annotations

import numpy as np

__all__ = ["verify_onnx", "verify_clip", "verify_clip_text", "run_verify"]

COSINE_GATE = 1.0 - 1e-5
# int8 is a documented NON-parity serving mode (embeddings shift within
# quantization error), so its gate is a quality floor, not a parity bound.
INT8_GATE = 0.99


def _int8_check(model: str, path: str, images_u8, report: dict,
                device="cuda") -> bool:
    """int8-vs-default cosine on the SAME ingested weights and images —
    the real-weight quality sign-off the int8 docs defer to weight holders
    (README "quantize=int8"). Both towers build through the production
    registry path, so calibration follows deployment rules
    (IMAGECLUST_CALIB_NPY if set, else synthetic with a warning); the
    fixture images are never used to calibrate."""
    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models.registry import create_embedder

    base = create_embedder(
        EmbedConfig(model=model, onnx_path=path, batch_size=8), device=device)
    quant = create_embedder(
        EmbedConfig(model=model, onnx_path=path, batch_size=8,
                    quantize="int8"), device=device)
    vf = np.asarray(base.embed(images_u8), np.float32)
    vq = np.asarray(quant.embed(images_u8), np.float32)
    cos = np.sum(vf * vq, axis=1) / (
        np.linalg.norm(vf, axis=1) * np.linalg.norm(vq, axis=1) + 1e-12)
    report["checks"]["int8_cosine_min"] = float(cos.min())
    report["checks"]["int8_cosine_mean"] = float(cos.mean())
    report["checks"]["int8_gate"] = INT8_GATE
    return bool(cos.min() > INT8_GATE)


def _fixture_images(images_dir: str | None, sample: int, size: int = 224):
    """Deterministic verification batch: either real images from a
    directory or seeded structured synthetics (color fields + gradients +
    noise — enough activation diversity to exercise every stage)."""
    if images_dir:
        from imageclust_tpu_torch.data.loader import load_image_dir

        names, batch = load_image_dir(images_dir, size=size)
        if len(batch) == 0:
            raise ValueError(f"no images found under {images_dir}")
        return names[:sample], batch[:sample]
    rng = np.random.default_rng(20240817)
    imgs = []
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
    for i in range(sample):
        base = np.stack([
            np.full((size, size), 40 * i % 256, np.float32),
            255.0 * yy * ((i % 3) + 1) / 3.0,
            255.0 * xx * ((i % 5) + 1) / 5.0,
        ], axis=-1)
        noise = rng.normal(0, 12, (size, size, 3))
        imgs.append(np.clip(base + noise, 0, 255).astype(np.uint8))
    names = [f"fixture_{i}" for i in range(sample)]
    return names, np.stack(imgs)


def _blob_from_images(images_u8: np.ndarray) -> np.ndarray:
    """The reference's exact blob: BGR uint8 -> RGB, 1/255, NCHW float32
    (embeddings.go:82-104)."""
    x = images_u8[..., ::-1].astype(np.float32) / 255.0
    return np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2)))


def verify_onnx(onnx_path: str, images_dir: str | None = None,
                sample: int = 8, quantize: str = "",
                device="cuda") -> dict:
    """Run the ResNet50 weight-parity gate on ``device`` (default
    ``"cuda"``). Returns a report dict with ``ok`` plus per-check details;
    raises on structural failures (bad file, shape mismatch) and where cv2,
    the reference's runtime, is not installed."""
    try:
        import cv2
    except ImportError as exc:
        raise RuntimeError(
            "verify --onnx compares against cv2.dnn, the reference's "
            "runtime, and cv2 is not installed") from exc
    import torch

    from imageclust_tpu_torch.cluster.ward import constrained_ward
    from imageclust_tpu_torch.device import resolve_device
    from imageclust_tpu_torch.models.resnet50 import (
        ResNet50V1,
        load_onnx_params,
    )

    dev = resolve_device(device)  # TF32 off: float32 means float32
    report: dict = {"onnx": onnx_path, "checks": {}}

    # 1. ingest (raises on any shape diff — the converter validates)
    model = ResNet50V1(dtype="float32", norm_dtype="float32")
    model.load_state_dict(load_onnx_params(onnx_path, model))
    model = model.to(dev).eval()
    report["checks"]["ingest"] = "ok"

    names, images = _fixture_images(images_dir, sample)
    blob = _blob_from_images(images)

    # 2. our forward (float32 end to end for a tight numerics gate)
    with torch.inference_mode():
        ours = model(torch.from_numpy(blob).to(dev)).cpu().numpy()

    # 3. the reference's own runtime on the same blobs
    net = cv2.dnn.readNetFromONNX(onnx_path)
    theirs = []
    for i in range(blob.shape[0]):
        net.setInput(blob[i:i + 1])
        theirs.append(net.forward("resnetv17_dense0_fwd"))
    theirs = np.concatenate(theirs)

    num = np.sum(ours * theirs, axis=1)
    den = (np.linalg.norm(ours, axis=1) * np.linalg.norm(theirs, axis=1)
           + 1e-12)
    cosines = num / den
    report["checks"]["cosine_min"] = float(cosines.min())
    report["checks"]["cosine_gate"] = COSINE_GATE
    rel = np.abs(ours - theirs).max() / (np.abs(theirs).max() + 1e-12)
    report["checks"]["max_rel_err"] = float(rel)
    cosine_ok = bool(cosines.min() > COSINE_GATE)

    # 4. assignment equality through the exact engine
    mn, mx = (1, len(names)) if len(names) < 6 else (2, 4)
    res_ours = constrained_ward(ours, names, min_size=mn, max_size=mx,
                                device=dev)
    res_theirs = constrained_ward(theirs, names, min_size=mn, max_size=mx,
                                  device=dev)
    part_ours = {frozenset(m) for m in res_ours.cluster_map.values()}
    part_theirs = {frozenset(m) for m in res_theirs.cluster_map.values()}
    assign_ok = (part_ours == part_theirs
                 and set(res_ours.dropped) == set(res_theirs.dropped))
    report["checks"]["assignments_equal"] = bool(assign_ok)

    report["ok"] = cosine_ok and assign_ok
    if quantize == "int8":
        int8_ok = _int8_check("resnet50", onnx_path, images, report, dev)
        report["checks"]["int8_ok"] = int8_ok
        report["ok"] = report["ok"] and int8_ok
    return report


def verify_clip(clip_path: str, bpe_path: str | None = None,
                quantize: str = "", device="cuda") -> dict:
    """Load-and-shape gate for a CLIP vision checkpoint (+ optional BPE
    vocabulary) on ``device``. No independent CLIP runtime exists, so this
    verifies ingestion and output structure, not numerics."""
    import os

    from imageclust_tpu_torch.config import EmbedConfig
    from imageclust_tpu_torch.models.registry import create_embedder

    if not os.path.exists(clip_path):
        raise ValueError(f"CLIP checkpoint not found: {clip_path}")
    report: dict = {"clip": clip_path, "checks": {}}
    emb = create_embedder(EmbedConfig(model="vit_b32", onnx_path=clip_path,
                                      batch_size=8), device=device)
    # a gate that certifies random init is worse than no gate: the registry
    # silently keeps the fresh init when the file has an extension it does
    # not ingest — surface that as a FAIL, not a PASS
    report["checks"]["ingested"] = bool(emb.weights_loaded)
    _, images = _fixture_images(None, 4, size=emb.spec.input_size)
    vecs = emb.embed(images)
    report["checks"]["image_dim"] = int(vecs.shape[1])
    report["checks"]["image_finite"] = bool(np.isfinite(vecs).all())

    if bpe_path:
        from imageclust_tpu_torch.models.text import TextEncoder

        enc = TextEncoder(bpe_path=bpe_path, device=device)
        toks = enc.tokenize("a photo of a cat")
        report["checks"]["bpe_vocab"] = int(enc.cfg.vocab)
        report["checks"]["bpe_context"] = int(toks.shape[0])
        tvec = enc.encode(["a photo of a cat", "a photo of a dog"])
        report["checks"]["text_dim"] = int(tvec.shape[1])
        report["checks"]["text_finite"] = bool(np.isfinite(tvec).all())

    report["ok"] = bool(report["checks"]["ingested"]
                        and report["checks"]["image_finite"]
                        and report["checks"].get("text_finite", True))
    if quantize == "int8" and report["checks"]["ingested"]:
        int8_ok = _int8_check("vit_b32", clip_path, images, report, device)
        report["checks"]["int8_ok"] = int8_ok
        report["ok"] = report["ok"] and int8_ok
    return report


def verify_clip_text(text_path: str, bpe_path: str | None = None,
                     device="cuda") -> dict:
    """Load-and-shape gate for a CLIPTextModel checkpoint (the
    labels.fusion="text" / zero-shot-bank tower) on ``device``. Checks
    real ingestion (weights_loaded provenance), finite embeddings, distinct
    outputs for distinct texts, and — when a BPE file is given — that the
    tokenizer actually adopted it (vocabulary ids match the trained
    table)."""
    import os

    from imageclust_tpu_torch.models.text import TextEncoder

    if not os.path.exists(text_path):
        raise ValueError(f"text checkpoint not found: {text_path}")
    report: dict = {"clip_text": text_path, "checks": {}}
    enc = TextEncoder.from_checkpoint(text_path, bpe_path=bpe_path,
                                      device=device)
    report["checks"]["ingested"] = bool(enc.weights_loaded)
    report["checks"]["bpe_adopted"] = enc.tokenizer is not None
    report["checks"]["vocab"] = int(enc.cfg.vocab)
    vecs = enc.encode(["a photo of a cat", "a photo of a dog"])
    report["checks"]["text_dim"] = int(vecs.shape[1])
    report["checks"]["text_finite"] = bool(np.isfinite(vecs).all())
    report["checks"]["distinct"] = not np.allclose(vecs[0], vecs[1])
    report["ok"] = bool(
        report["checks"]["ingested"] and report["checks"]["text_finite"]
        and report["checks"]["distinct"]
        and (enc.tokenizer is not None or not bpe_path))
    return report


def run_verify(onnx: str | None, clip: str | None = None,
               bpe: str | None = None, images: str | None = None,
               sample: int = 8, clip_text: str | None = None,
               quantize: str = "", device="cuda") -> tuple[bool, dict]:
    """Drive every requested gate on ``device``; returns (all_ok, combined
    report)."""
    combined: dict = {}
    ok = True
    if onnx:
        r = verify_onnx(onnx, images_dir=images, sample=sample,
                        quantize=quantize, device=device)
        combined["resnet50"] = r
        ok = ok and r["ok"]
    if clip:
        r = verify_clip(clip, bpe_path=bpe, quantize=quantize, device=device)
        combined["clip"] = r
        ok = ok and r["ok"]
    if clip_text:
        r = verify_clip_text(clip_text, bpe_path=bpe, device=device)
        combined["clip_text"] = r
        ok = ok and r["ok"]
    if not combined:
        raise ValueError(
            "nothing to verify: pass --onnx, --clip and/or --clip-text")
    combined["ok"] = ok
    return ok, combined
