"""Local open-vocabulary labeler: zero-shot over a prototype label bank.

The port of ``imageclust_tpu/labels/zero_shot.py``. The reference is
unusable without AWS credentials (every run calls Rekognition,
workflow.go:129). This backend labels images locally on the card: cosine
similarity between the image embedding and a bank of label prototype
vectors (CLIP text embeddings, or centroids of labeled examples from ``cli
bank``). Confidences are mapped to Rekognition's 0-100 scale so the
downstream thresholds (75/80, workflow.go:129 / embeddings.go:208) keep
meaning.

:meth:`ZeroShotLabeler.labels_from_embeddings` scores a whole embedding
matrix on the device it lives on, in row chunks (a bf16 or int8 matrix
never gets a float32 copy of its own size), and only the (n, k) winners
cross to the host. Ties go to the lower bank index, as ``jax.lax.top_k``
resolves them.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from imageclust_tpu_torch.labels.base import Label

log = logging.getLogger(__name__)

__all__ = ["ZeroShotLabeler"]

# rows scored per chunk: bounds the float32 copy of a bf16/int8 matrix
_SCORE_ROWS = 1 << 16


class ZeroShotLabeler:
    def __init__(self, names: list[str], bank: np.ndarray, embedder):
        """``bank``: (n_labels, d) prototype matrix, rows need not be
        normalized; ``embedder``: an :class:`~imageclust_tpu_torch.models.
        registry.Embedder` whose dim matches d."""
        if bank.shape[0] != len(names):
            raise ValueError("bank rows must match names")
        norms = np.linalg.norm(bank, axis=1, keepdims=True)
        self.bank = (bank / np.maximum(norms, 1e-8)).astype(np.float32)
        self.names = names
        self.embedder = embedder

    @classmethod
    def from_texts(cls, names: list[str], embedder,
                   text_encoder=None) -> "ZeroShotLabeler":
        """Build the bank from label STRINGS via the CLIP-style text tower
        (models/text.py) — joint visual+text features with zero example
        images. Meaningful similarity requires image/text towers trained into
        the same space (load matched checkpoints); offline random init still
        produces a valid, deterministic bank for wiring."""
        if text_encoder is None:
            from imageclust_tpu_torch.models.text import (
                TextConfig,
                TextEncoder,
            )

            text_encoder = TextEncoder(
                TextConfig(width=256, depth=4, heads=4,
                           proj_dim=embedder.spec.dim, vocab=16384),
                device=getattr(embedder, "device", None))
        bank = text_encoder.encode([f"a photo of {n}" for n in names])
        return cls(names, bank, embedder)

    @classmethod
    def default(cls, embedder, bank_path: str | None = None,
                text_checkpoint: str | None = None) -> "ZeroShotLabeler":
        """Build the bank by priority: an explicit npz bank
        (IMAGECLUST_LABEL_BANK / ``bank_path``, from ``cli bank``), else a
        real text tower over the builtin vocabulary when ``text_checkpoint``
        (labels.text_checkpoint_path) is set — with MATCHED image/text CLIP
        checkpoints that makes open-vocabulary labels semantically live with
        no extra steps — else the inert random demo bank. The text tower
        runs on the embedder's device."""
        bank_path = bank_path or os.environ.get("IMAGECLUST_LABEL_BANK", "")
        if embedder is None:
            raise ValueError("zero_shot labeler needs an embedder")
        if not (bank_path and os.path.exists(bank_path)) and text_checkpoint:
            from imageclust_tpu_torch.labels.fake import _VOCAB
            from imageclust_tpu_torch.models.text import TextEncoder

            enc = TextEncoder.from_checkpoint(
                text_checkpoint, device=getattr(embedder, "device", None))
            if enc.cfg.proj_dim != embedder.spec.dim:
                # cosine against image embeddings needs a shared space — a
                # CLIP text tower cannot pair with e.g. 1000-d logits. The
                # checkpoint may have been configured for the FUSION tower
                # only (labels.fusion=text shares the config field), so
                # degrade to the inert demo bank instead of aborting the
                # job — loudly.
                log.warning(
                    "labels.text_checkpoint_path tower dim %d != embedder "
                    "dim %d — zero-shot needs matched image/text halves of "
                    "one CLIP model; falling back to the inert demo bank "
                    "(labels will stay empty at default thresholds)",
                    enc.cfg.proj_dim, embedder.spec.dim)
            else:
                return cls.from_texts(list(_VOCAB), embedder,
                                      text_encoder=enc)
        if bank_path and os.path.exists(bank_path):
            # allow_pickle stays False: `cli bank` writes plain string/float
            # arrays, and a tampered npz must not execute code.
            data = np.load(bank_path, allow_pickle=False)
            names = [str(n) for n in data["names"]]
            return cls(names, np.asarray(data["vectors"], np.float32), embedder)
        # Deterministic demo bank: stable pseudo-prototypes in embed space.
        # NOTE: random prototypes give cosines near 0 -> confidences near 50,
        # below the reference-parity default threshold (75), so labels stay
        # empty until a real bank is supplied (IMAGECLUST_LABEL_BANK npz from
        # `cli bank`, or matched image/text checkpoints) or the threshold is
        # lowered. That is deliberate: the demo bank must not fabricate
        # confident labels.
        rng = np.random.default_rng(7)
        from imageclust_tpu_torch.labels.fake import _VOCAB

        bank = rng.normal(size=(len(_VOCAB), embedder.spec.dim)).astype(np.float32)
        return cls(list(_VOCAB), bank, embedder)

    def detect_labels(
        self, image_bytes: bytes, max_labels: int, min_confidence: float
    ) -> list[Label]:
        from imageclust_tpu_torch.data.loader import DecodeError, _decode_one

        try:  # BGR uint8 at the file's own size, as cv2.imdecode gives it
            img = _decode_one(image_bytes, None)
        except DecodeError as exc:
            raise ValueError(
                "failed to decode image for zero-shot labeling") from exc
        emb = self.embedder.embed(img[None])[0]
        return self._labels_for(emb, max_labels, min_confidence)

    def _labels_for(self, emb: np.ndarray, max_labels: int,
                    min_confidence: float) -> list[Label]:
        emb = emb / max(np.linalg.norm(emb), 1e-8)
        sims = self.bank @ emb  # cosine in [-1, 1]
        conf = (sims + 1.0) * 50.0  # -> [0, 100], Rekognition-style scale
        order = np.argsort(-conf)[: max_labels]
        return [
            Label(self.names[i], float(conf[i]))
            for i in order
            if conf[i] >= min_confidence
        ]

    @torch.inference_mode()
    def labels_from_embeddings(
        self, embeddings, max_labels: int, min_confidence: float
    ) -> list[list[Label]]:
        """Batched zero-shot: label a whole (n, d) embedding matrix at once.

        ``embeddings``: a tensor in float32, bfloat16 or int8 (cosine is
        scale-free, so the int8 grid needs no scale), scored on its own
        device; a host array is moved to the embedder's device first. Each
        chunk of rows is upcast, normalized and multiplied by the bank, and
        its top k (ties to the lower bank index) stays on the device; only
        the (n, k) winners cross to the host."""
        from imageclust_tpu_torch.device import resolve_device

        if not isinstance(embeddings, torch.Tensor):
            embeddings = torch.from_numpy(np.asarray(embeddings)).to(
                resolve_device(getattr(self.embedder, "device", None)))
        n = embeddings.shape[0]
        k = min(max_labels, len(self.names))
        if k <= 0 or n == 0:
            return [[] for _ in range(n)]
        bank_t = torch.from_numpy(self.bank).to(embeddings.device).T
        vals, idx = [], []
        for s in range(0, n, _SCORE_ROWS):
            e = embeddings[s:s + _SCORE_ROWS].to(torch.float32)
            norms = torch.linalg.vector_norm(e, dim=1, keepdim=True)
            conf = ((e / norms.clamp_min(1e-8)) @ bank_t + 1.0) * 50.0
            # a stable descending sort keeps equal scores in bank order
            v, i = torch.sort(conf, dim=1, descending=True, stable=True)
            vals.append(v[:, :k])
            idx.append(i[:, :k].to(torch.int32))
        vals = torch.cat(vals).cpu().tolist()
        idx = torch.cat(idx).cpu().tolist()
        names = self.names
        return [
            [Label(names[j], c)
             for j, c in zip(row_idx, row_vals) if c >= min_confidence]
            for row_idx, row_vals in zip(idx, vals)
        ]
