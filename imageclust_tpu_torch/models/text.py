"""CLIP-style text tower in PyTorch: label names -> embedding space.

The port of ``imageclust_tpu/models/text.py`` (BASELINE config 5's text
half): a causal-masked transformer whose projected embeddings share the
image tower's space, so zero-shot label banks (labels/zero_shot.py) and the
dense text-label block (labels/text_fusion.py) come from label strings.

Numerics follow the Flax module: float32 throughout, LayerNorm eps 1e-5,
separate q/k/v/proj Dense layers, quick-GELU ``y * sigmoid(1.702 y)``,
pooling at ``argmax(token_ids)`` (CLIP BPE, where ``<|endoftext|>`` has
the highest id) or at the first ``eot_id``, and a bias-free projection.
Attention is plain float32 torch, as ``jax.nn.dot_product_attention``
computes it: ``(q kᵀ) / sqrt(hd)``, causally masked, softmax, ``@ v``. JAX
masks with a large negative number and the port with ``-inf``; every row
keeps its diagonal, so the softmax is the same. K5 is not used here (it
has no mask).

Parameter names follow the Flax tree (``token_embed``, ``pos_embed``,
``block{i}.{ln1,q,k,v,proj,ln2,mlp_up,mlp_down}``, ``ln_final``,
``projection``) so :mod:`.convert` maps one onto the other by name.
:func:`load_clip_text_state_dict` maps a HuggingFace ``CLIPTextModel``
(+ ``text_projection``) state dict onto the same names.

The seeded random init draws from a ``torch.Generator``: the same seed
gives other numbers than the JAX package's ``jax.random`` init.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
import math
import os
from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch
from torch import nn

from imageclust_tpu_torch.device import resolve_device
from imageclust_tpu_torch.models.resnet50 import _lecun_normal_
from imageclust_tpu_torch.models.vit import _Dense, _gelu, _LayerNorm

log = logging.getLogger(__name__)

__all__ = ["TextConfig", "TextTransformer", "TextEncoder", "hash_tokenize",
           "load_clip_text_state_dict", "text_config_from_state_dict"]

_F32 = torch.float32


@dataclass(frozen=True)
class TextConfig:
    vocab: int = 49408  # CLIP BPE vocab size
    width: int = 512
    depth: int = 12
    heads: int = 8
    proj_dim: int = 512
    context: int = 77
    quick_gelu: bool = True
    # Pooling position: None = argmax(token_ids), the CLIP-BPE convention
    # where <end> carries the highest id; set to the <end> token id when the
    # tokenizer doesn't satisfy that (the hashing tokenizer uses 2).
    eot_id: int | None = None


def hash_tokenize(text: str, vocab: int, context: int) -> np.ndarray:
    """Deterministic offline tokenizer: lowercase word pieces hashed into the
    vocab (ids 3..vocab-1); 0=<pad> 1=<start> 2=<end>. A drop-in stand-in for
    the CLIP BPE when no tokenizer file is available — stable across runs so
    banks and caches stay valid."""
    ids = [1]
    for word in text.lower().strip().split():
        h = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
        ids.append(3 + h % (vocab - 3))
        if len(ids) >= context - 1:
            break
    ids.append(2)
    out = np.zeros(context, np.int32)
    out[: len(ids)] = ids
    return out


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, H, hd): softmax attention in which position
    t sees positions <= t."""
    t, hd = q.shape[1], q.shape[3]
    logits = torch.einsum("bthd,bshd->bhts", q, k) * (1.0 / math.sqrt(hd))
    causal = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
    logits = logits.masked_fill(~causal, float("-inf"))
    return torch.einsum("bhts,bshd->bthd", torch.softmax(logits, dim=-1), v)


class TextBlock(nn.Module):
    """Pre-LN causal transformer block (JAX text.py:63-85)."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.ln1 = _LayerNorm(w)
        self.q = _Dense(w, w)
        self.k = _Dense(w, w)
        self.v = _Dense(w, w)
        self.proj = _Dense(w, w)
        self.ln2 = _LayerNorm(w)
        self.mlp_up = _Dense(w, 4 * w)
        self.mlp_down = _Dense(4 * w, w)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        y = self.ln1(x, _F32)
        b, t, _ = y.shape
        hd = c.width // c.heads
        q = self.q(y, _F32).reshape(b, t, c.heads, hd)
        k = self.k(y, _F32).reshape(b, t, c.heads, hd)
        v = self.v(y, _F32).reshape(b, t, c.heads, hd)
        x = x + self.proj(causal_attention(q, k, v).reshape(b, t, c.width),
                          _F32)
        y = _gelu(self.mlp_up(self.ln2(x, _F32), _F32), c.quick_gelu)
        return x + self.mlp_down(y, _F32)


class TextTransformer(nn.Module):
    """token_ids (B, context) integer -> (B, proj_dim) float32 embeddings,
    pooled at the <end> token (JAX text.py:88-116)."""

    def __init__(self, cfg: TextConfig):
        super().__init__()
        self.cfg = cfg
        self.token_embed = nn.Embedding(cfg.vocab, cfg.width)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.context, cfg.width))
        for i in range(cfg.depth):
            self.add_module(f"block{i}", TextBlock(cfg))
        self.ln_final = _LayerNorm(cfg.width)
        self.projection = _Dense(cfg.width, cfg.proj_dim, bias=False)

    def forward(self, token_ids: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        token_ids = token_ids.long()
        x = self.token_embed(token_ids) + self.pos_embed[:, :token_ids.shape[1]]
        for i in range(c.depth):
            x = getattr(self, f"block{i}")(x)
        x = self.ln_final(x, _F32)
        if c.eot_id is None:  # CLIP BPE: <end> has the highest id
            eot = torch.argmax(token_ids, dim=1)
        else:  # the first <end> (hashing tokenizer: 2)
            eot = torch.argmax((token_ids == c.eot_id).to(torch.int32), dim=1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return self.projection(pooled, _F32)

    @torch.no_grad()
    def init_random(self, seed: int = 0) -> "TextTransformer":
        """Seeded init with Flax's initializer families: normal with std
        1/sqrt(width) for the token table, normal(0.01) for the position
        table, lecun_normal for Dense kernels, zero biases, LayerNorm scale
        1 / shift 0; drawn from a ``torch.Generator``."""
        gen = torch.Generator(device="cpu").manual_seed(seed)
        for mod in self.modules():
            if isinstance(mod, _Dense):
                _lecun_normal_(mod.weight, mod.weight.shape[1], gen)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, _LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
        w = self.token_embed.weight
        w.copy_(torch.randn(w.shape, generator=gen) / math.sqrt(w.shape[1]))
        self.pos_embed.copy_(
            torch.randn(self.pos_embed.shape, generator=gen) * 0.01)
        return self


def text_config_from_state_dict(state_dict) -> TextConfig:
    """Infer the tower dims from a HuggingFace CLIPTextModel(+projection)
    state dict: vocab/width from the token embedding, context from the
    position embedding, depth by counting encoder layers, proj_dim from
    text_projection (width when absent). heads follows CLIP's width/64
    convention (the only dim a state dict cannot encode)."""
    sd = {k.replace("text_model.", ""): v for k, v in state_dict.items()}
    tok = np.asarray(sd["embeddings.token_embedding.weight"])
    pos = np.asarray(sd["embeddings.position_embedding.weight"])
    depth = 1 + max(
        int(k.split(".")[2]) for k in sd if k.startswith("encoder.layers."))
    proj = sd.get("text_projection.weight")
    vocab, width = tok.shape
    return TextConfig(
        vocab=int(vocab), width=int(width), depth=depth,
        heads=max(1, int(width) // 64),
        proj_dim=int(np.asarray(proj).shape[0]) if proj is not None
        else int(width),
        context=int(pos.shape[0]),
    )


def _hf_pairs(cfg: TextConfig):
    """(port key, HF key without ``text_model.``) for every tensor of a HF
    CLIPTextModel of this config."""
    yield "token_embed.weight", "embeddings.token_embedding.weight"
    yield "pos_embed", "embeddings.position_embedding.weight"
    lin = [("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
           ("v", "self_attn.v_proj"), ("proj", "self_attn.out_proj"),
           ("mlp_up", "mlp.fc1"), ("mlp_down", "mlp.fc2"),
           ("ln1", "layer_norm1"), ("ln2", "layer_norm2")]
    for i in range(cfg.depth):
        for ours, theirs in lin:
            for leaf in ("weight", "bias"):
                yield (f"block{i}.{ours}.{leaf}",
                       f"encoder.layers.{i}.{theirs}.{leaf}")
    yield "ln_final.weight", "final_layer_norm.weight"
    yield "ln_final.bias", "final_layer_norm.bias"


def load_clip_text_state_dict(state_dict: Mapping,
                              cfg: TextConfig) -> dict[str, torch.Tensor]:
    """Map a HuggingFace ``CLIPTextModel`` (+ ``text_projection``) state
    dict (tensors or numpy arrays) onto :class:`TextTransformer`'s names:
    the counterpart of JAX ``load_clip_text_torch``. HF's Linear weights
    already have the port's (out, in) layout; the position table becomes
    (1, context, width). Returns float32 tensors; ``projection.weight`` is
    left out when the checkpoint has no ``text_projection`` (the tower
    keeps its own, as the JAX loader does). Raises ValueError listing every
    missing or mis-shaped tensor."""
    sd = {k.replace("text_model.", ""): v for k, v in state_dict.items()}
    with torch.device("meta"):
        want = {k: tuple(v.shape)
                for k, v in TextTransformer(cfg).state_dict().items()}
    pairs = list(_hf_pairs(cfg))
    if "text_projection.weight" in sd:
        pairs.append(("projection.weight", "text_projection.weight"))
    out: dict[str, torch.Tensor] = {}
    problems = []
    for ours, theirs in pairs:
        if theirs not in sd:
            problems.append(f"{theirs}: missing")
            continue
        val = sd[theirs]
        if isinstance(val, torch.Tensor):
            val = val.detach().cpu().float().numpy()
        arr = np.asarray(val, np.float32)
        if ours == "pos_embed":
            arr = arr[None]
        if tuple(arr.shape) != want[ours]:
            problems.append(f"{theirs}: {tuple(arr.shape)} != {want[ours]}")
            continue
        out[ours] = torch.tensor(arr)
    if problems:
        raise ValueError("CLIP text state dict does not fit the tower:\n  "
                         + "\n  ".join(problems[:40]))
    return out


class _VocabMismatch(ValueError):
    def __init__(self, bpe_vocab: int, table_rows: int):
        super().__init__(f"BPE vocabulary size {bpe_vocab} != the token "
                         f"table's {table_rows} rows")
        self.bpe_vocab, self.table_rows = bpe_vocab, table_rows


def _read_state_dict(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return dict(z)
    return dict(torch.load(path, map_location="cpu", weights_only=True))


class TextEncoder:
    """Batched text embedding on ``device`` (default ``"cuda"``; raises
    without a card, ``device="cpu"`` runs on the CPU).

    Tokenization: CLIP's byte-level BPE when a merges file is available
    (``bpe_path``, else ``IMAGECLUST_BPE_PATH`` / the conventional filename
    — models/tokenizer.py), else the deterministic hashing tokenizer. With
    BPE, ``<|endoftext|>`` has the highest id, so the tower pools at the
    argmax (eot_id=None). ``state_dict``: the port's tensors (e.g. from
    :func:`load_clip_text_state_dict` or
    :func:`~imageclust_tpu_torch.models.convert.text_state_dict_from_flax`)
    to load over the seeded init; only ``projection.weight`` may be
    absent. ``bpe_path=""`` keeps the hashing tokenizer whatever the
    environment says."""

    # rows per forward: bounds the activations however many names come
    _ENCODE_BATCH = 256

    def __init__(self, cfg: TextConfig | None = None, seed: int = 0,
                 state_dict: Mapping | None = None,
                 bpe_path: str | None = None, device=None):
        from imageclust_tpu_torch.models.tokenizer import (
            BPETokenizer,
            default_bpe_path,
        )

        self.device = resolve_device(device)
        path = bpe_path or default_bpe_path()
        self.tokenizer = None
        # With caller-provided weights (e.g. a checkpoint trained with the
        # hash tokenizer, vocab 16384) a conventionally placed merges file
        # would rewire vocab/eot_id and break the load, so with weights the
        # BPE path needs an explicit ask: the bpe_path argument or the
        # IMAGECLUST_BPE_PATH env var.
        adopt_bpe = bpe_path != "" and (
            bpe_path is not None
            or bool(os.environ.get("IMAGECLUST_BPE_PATH"))
            or state_dict is None)
        if adopt_bpe and os.path.exists(path):
            self.tokenizer = BPETokenizer(
                path, context=(cfg or TextConfig()).context)
        if self.tokenizer is not None:
            # full CLIP-base dims only make sense with real weights; at
            # random init keep the small offline tower
            base = cfg or (
                TextConfig() if state_dict is not None
                else TextConfig(width=256, depth=4, heads=4, proj_dim=512,
                                vocab=0))
            self.cfg = dataclasses.replace(
                base, vocab=self.tokenizer.vocab_size, eot_id=None)
        else:
            self.cfg = cfg or TextConfig(width=256, depth=4, heads=4,
                                         proj_dim=512, vocab=16384, eot_id=2)
            if self.cfg.eot_id is None:
                # hash_tokenize's <end> is 2 (not the highest id)
                self.cfg = dataclasses.replace(self.cfg, eot_id=2)
        self.weights_loaded = state_dict is not None
        if state_dict is not None and "token_embed.weight" in state_dict:
            rows = int(state_dict["token_embed.weight"].shape[0])
            if self.tokenizer is not None and rows != self.cfg.vocab:
                raise _VocabMismatch(self.cfg.vocab, rows)
        model = TextTransformer(self.cfg).init_random(seed)
        if state_dict is not None:
            missing, unexpected = model.load_state_dict(dict(state_dict),
                                                        strict=False)
            missing = [k for k in missing if k != "projection.weight"]
            if missing or unexpected:
                raise ValueError(f"text state dict: missing {missing}, "
                                 f"unexpected {unexpected}")
        self.model = model.to(self.device).eval()

    @classmethod
    def from_checkpoint(cls, path: str, bpe_path: str | None = None,
                        cfg: TextConfig | None = None,
                        device=None) -> "TextEncoder":
        """Build the tower from a HuggingFace CLIPTextModel(WithProjection)
        checkpoint — torch ``.pt``/``.bin`` or an ``.npz`` export. Dims are
        inferred from the state dict (:func:`text_config_from_state_dict`)
        unless ``cfg`` overrides them. Pass the CLIP merges file as
        ``bpe_path`` so token ids match the trained embedding table; the
        hashing fallback produces ids the checkpoint never saw (warned)."""
        sd = _read_state_dict(path)
        cfg = cfg or text_config_from_state_dict(sd)
        state = load_clip_text_state_dict(sd, cfg)
        if bpe_path is None:
            # a real CLIP checkpoint is BPE-trained by definition, so the
            # conventionally placed merges file is adopted, guarded below by
            # the vocab check against the checkpoint's own embedding table
            from imageclust_tpu_torch.models.tokenizer import default_bpe_path

            conv = default_bpe_path()
            if os.path.exists(conv):
                bpe_path = conv
        try:
            enc = cls(cfg, state_dict=state, bpe_path=bpe_path, device=device)
        except _VocabMismatch as exc:
            log.warning(
                "BPE vocabulary size %d != checkpoint embedding table %d — "
                "falling back to the hashing tokenizer (wrong merges file "
                "for this checkpoint?)", exc.bpe_vocab, exc.table_rows)
            enc = cls(cfg, state_dict=state, bpe_path="", device=device)
        if enc.tokenizer is None:
            log.warning(
                "text checkpoint %s loaded with the HASHING tokenizer — "
                "token ids will not match the trained vocabulary; pass the "
                "CLIP merges file (bpe_path / IMAGECLUST_BPE_PATH) for "
                "meaningful embeddings", path)
        return enc

    def tokenize(self, text: str) -> np.ndarray:
        if self.tokenizer is not None:
            return self.tokenizer(text)
        return hash_tokenize(text, self.cfg.vocab, self.cfg.context)

    @torch.inference_mode()
    def encode(self, texts: list[str]) -> np.ndarray:
        """(len(texts), proj_dim) float32 on the host, in input order."""
        if not texts:
            return np.zeros((0, self.cfg.proj_dim), np.float32)
        toks = torch.from_numpy(np.stack([self.tokenize(t) for t in texts]))
        bs = self._ENCODE_BATCH
        outs = [self.model(toks[s:s + bs].to(self.device, torch.long))
                for s in range(0, len(texts), bs)]
        return torch.cat(outs).cpu().numpy()
