"""The port's zero-shot labeler (``imageclust_tpu_torch/labels/zero_shot.py``)
against the JAX package's on the same bank and embeddings: per-image and
batched labels in float32, bfloat16 and on the int8 grid, the tie rule of
``jax.lax.top_k``, the three bank sources of ``default()``, ``detect_labels``
on a BMP and ``create_labeler("zero_shot")``.

Names and their order must be equal and confidences allclose at 1e-5, on
data whose top scores are at least 1e-3 apart.
"""

import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.labels.zero_shot import ZeroShotLabeler as JaxZeroShot
from imageclust_tpu.models import text as jax_text
from imageclust_tpu_torch.config import LabelConfig
from imageclust_tpu_torch.labels import CachedLabeler, create_labeler
from imageclust_tpu_torch.labels.fake import _VOCAB
from imageclust_tpu_torch.labels.zero_shot import ZeroShotLabeler
from imageclust_tpu_torch.models import text
from imageclust_tpu_torch.models.convert import text_state_dict_from_flax

from helpers import MeanColorEmbedder

torch.set_num_threads(1)

_TOL = dict(rtol=1e-5, atol=1e-5)


class _Embedder:
    """A stand-in embedder on the CPU: only ``spec.dim`` and ``device``
    matter to the labeler's bank and batched path."""

    def __init__(self, dim):
        self.spec = type("spec", (), {"dim": dim})
        self.device = torch.device("cpu")


class _ColorEmbedder(MeanColorEmbedder):
    device = torch.device("cpu")


def _bank(rng, n, d):
    return rng.normal(size=(n, d)).astype(np.float32)


def _tie_free(x, bank, k, gap=1e-3):
    """Rows whose top k + 1 cosines (float64) are at least ``gap`` apart."""
    b = bank / np.linalg.norm(bank, axis=1, keepdims=True)
    xs = x.astype(np.float64)
    conf = (xs / np.linalg.norm(xs, axis=1, keepdims=True)) @ b.T * 50
    top = -np.sort(-conf, axis=1)[:, :k + 1]
    return x[(np.diff(-top, axis=1) >= gap).all(axis=1)]


def _view(rows):
    return [[l.name for l in r] for r in rows], [
        [l.confidence for l in r] for r in rows]


def _assert_same(got, want):
    gn, gc = _view(got)
    wn, wc = _view(want)
    assert gn == wn
    for a, b in zip(gc, wc):
        np.testing.assert_allclose(a, b, **_TOL)


@pytest.fixture()
def pair(rng):
    d = 32
    names = [f"label{i}" for i in range(16)]
    bank = _bank(rng, 16, d)
    return (JaxZeroShot(names, bank, _Embedder(d)),
            ZeroShotLabeler(names, bank, _Embedder(d)))


class TestScoring:
    def test_bank_normalized_equal(self, pair):
        np.testing.assert_array_equal(pair[1].bank, pair[0].bank)

    @pytest.mark.parametrize("max_labels,min_conf", [(3, 0.0), (10, 55.0),
                                                     (40, 0.0), (1, 75.0)])
    def test_labels_for_equal(self, pair, rng, max_labels, min_conf):
        j, p = pair
        x = _tie_free(rng.normal(size=(40, 32)).astype(np.float32), j.bank,
                      min(max_labels, 16))
        for e in x:
            _assert_same([p._labels_for(e, max_labels, min_conf)],
                         [j._labels_for(e, max_labels, min_conf)])

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
    @pytest.mark.parametrize("max_labels,min_conf", [(3, 0.0), (10, 55.0),
                                                     (40, 50.0)])
    def test_batched_equal(self, pair, rng, dtype, max_labels, min_conf):
        j, p = pair
        x = rng.normal(size=(600, 32)).astype(np.float32)
        if dtype == "int8":
            x = np.clip(np.round(x * 30), -127, 127)
        elif dtype == "bfloat16":
            x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        x = _tie_free(x, j.bank, min(max_labels, 16))
        jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
               "int8": jnp.int8}[dtype]
        tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16,
               "int8": torch.int8}[dtype]
        want = j.labels_from_embeddings(jnp.asarray(x, jdt), max_labels,
                                        min_conf)
        got = p.labels_from_embeddings(torch.from_numpy(x).to(tdt),
                                       max_labels, min_conf)
        _assert_same(got, want)

    def test_chunks_and_host_input(self, pair, rng, monkeypatch):
        from imageclust_tpu_torch.labels import zero_shot

        j, p = pair
        x = _tie_free(rng.normal(size=(300, 32)).astype(np.float32), j.bank,
                      4)
        whole = p.labels_from_embeddings(x, 4, 0.0)  # host array input
        monkeypatch.setattr(zero_shot, "_SCORE_ROWS", 7)
        _assert_same(p.labels_from_embeddings(torch.from_numpy(x), 4, 0.0),
                     whole)
        _assert_same(whole, j.labels_from_embeddings(x, 4, 0.0))

    def test_ties_go_to_the_lower_bank_index(self, rng):
        """Duplicated bank rows score exactly equal: lax.top_k lists the
        lower index first, and so must the port."""
        base = _bank(rng, 6, 16)
        bank = np.concatenate([base, base[[4, 1, 4]]])  # rows 6, 7, 8
        names = [f"n{i}" for i in range(9)]
        j = JaxZeroShot(names, bank, _Embedder(16))
        p = ZeroShotLabeler(names, bank, _Embedder(16))
        x = np.concatenate([base[[4, 1]],
                            rng.normal(size=(50, 16)).astype(np.float32)])
        want = j.labels_from_embeddings(x, 9, 0.0)
        got = p.labels_from_embeddings(torch.from_numpy(x), 9, 0.0)
        assert _view(got)[0] == _view(want)[0]
        for row in _view(got)[0]:
            for a, b in (("n4", "n6"), ("n4", "n8"), ("n6", "n8"),
                         ("n1", "n7")):
                assert row.index(a) < row.index(b)
        assert _view(got)[0][0][:3] == ["n4", "n6", "n8"]

    def test_empty_inputs(self, pair):
        _, p = pair
        assert p.labels_from_embeddings(torch.zeros((0, 32)), 3, 0.0) == []
        assert p.labels_from_embeddings(torch.ones((2, 32)), 0, 0.0) == [
            [], []]

    def test_bank_rows_must_match_names(self):
        with pytest.raises(ValueError, match="bank rows"):
            ZeroShotLabeler(["a"], np.zeros((2, 4), np.float32),
                            _Embedder(4))


def _hf_text_npz(path, proj_dim, seed=0, vocab=300, width=32):
    """A seeded HF CLIPTextModel(+projection) checkpoint (.npz) whose
    inferred heads (width // 64 -> 1) both packages share."""
    rng = np.random.default_rng(seed)
    pre = "text_model."

    def normal(*shape, s=0.05):
        return rng.normal(0, s, shape).astype(np.float32)

    sd = {pre + "embeddings.token_embedding.weight": normal(vocab, width),
          pre + "embeddings.position_embedding.weight": normal(77, width)}
    for i in range(2):
        hf = f"{pre}encoder.layers.{i}"
        for name in ("layer_norm1", "layer_norm2"):
            sd[f"{hf}.{name}.weight"] = 1 + normal(width)
            sd[f"{hf}.{name}.bias"] = normal(width)
        for name, (o, n) in (
                ("self_attn.q_proj", (width, width)),
                ("self_attn.k_proj", (width, width)),
                ("self_attn.v_proj", (width, width)),
                ("self_attn.out_proj", (width, width)),
                ("mlp.fc1", (4 * width, width)),
                ("mlp.fc2", (width, 4 * width))):
            sd[f"{hf}.{name}.weight"] = normal(o, n, s=n ** -0.5)
            sd[f"{hf}.{name}.bias"] = normal(o)
    sd[pre + "final_layer_norm.weight"] = 1 + normal(width)
    sd[pre + "final_layer_norm.bias"] = normal(width)
    sd["text_projection.weight"] = normal(proj_dim, width, s=width ** -0.5)
    np.savez(path, **sd)
    return str(path)


class TestDefaultBank:
    def test_demo_bank_bit_equal(self, monkeypatch):
        monkeypatch.delenv("IMAGECLUST_LABEL_BANK", raising=False)
        j = JaxZeroShot.default(_Embedder(48))
        p = ZeroShotLabeler.default(_Embedder(48))
        assert p.names == j.names == list(_VOCAB)
        np.testing.assert_array_equal(p.bank, j.bank)

    @pytest.mark.parametrize("via", ["env", "argument"])
    def test_npz_bank(self, tmp_path, rng, monkeypatch, via):
        path = str(tmp_path / "bank.npz")
        np.savez(path, names=np.array(["red", "green", "blue"]),
                 vectors=_bank(rng, 3, 8))
        ckpt = _hf_text_npz(tmp_path / "text.npz", 8)
        kw = {}
        if via == "env":
            monkeypatch.setenv("IMAGECLUST_LABEL_BANK", path)
        else:
            monkeypatch.delenv("IMAGECLUST_LABEL_BANK", raising=False)
            kw["bank_path"] = path
        # the bank wins over a text checkpoint
        j = JaxZeroShot.default(_Embedder(8), text_checkpoint=ckpt, **kw)
        p = ZeroShotLabeler.default(_Embedder(8), text_checkpoint=ckpt,
                                    **kw)
        assert p.names == j.names == ["red", "green", "blue"]
        np.testing.assert_array_equal(p.bank, j.bank)

    def test_text_checkpoint_bank(self, tmp_path, monkeypatch):
        monkeypatch.delenv("IMAGECLUST_LABEL_BANK", raising=False)
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)
        ckpt = _hf_text_npz(tmp_path / "text.npz", 24)
        j = JaxZeroShot.default(_Embedder(24), text_checkpoint=ckpt)
        p = ZeroShotLabeler.default(_Embedder(24), text_checkpoint=ckpt)
        assert p.names == j.names == list(_VOCAB)
        np.testing.assert_allclose(p.bank, j.bank, **_TOL)
        np.testing.assert_allclose(np.linalg.norm(p.bank, axis=1), 1.0,
                                   rtol=1e-6)

    def test_text_checkpoint_dim_mismatch_drops_to_demo_bank(
            self, tmp_path, monkeypatch, caplog):
        monkeypatch.delenv("IMAGECLUST_LABEL_BANK", raising=False)
        ckpt = _hf_text_npz(tmp_path / "text.npz", 24)
        with caplog.at_level(logging.WARNING):
            p = ZeroShotLabeler.default(_Embedder(40), text_checkpoint=ckpt)
        j = JaxZeroShot.default(_Embedder(40), text_checkpoint=ckpt)
        np.testing.assert_array_equal(p.bank, j.bank)
        assert any("demo bank" in r.getMessage() for r in caplog.records
                   if r.name == "imageclust_tpu_torch.labels.zero_shot")

    def test_needs_an_embedder(self):
        with pytest.raises(ValueError, match="embedder"):
            ZeroShotLabeler.default(None)

    def test_from_texts_matches_jax(self):
        jcfg = jax_text.TextConfig(vocab=300, width=32, depth=2, heads=2,
                                   proj_dim=12, context=16, eot_id=2)
        variables = jax_text.TextTransformer(jcfg).init(
            jax.random.PRNGKey(3), jnp.zeros((1, 16), jnp.int32))
        variables = jax.tree.map(np.asarray, variables)
        jenc = jax_text.TextEncoder(jcfg, variables=variables)
        penc = text.TextEncoder(
            text.TextConfig(**{f: getattr(jcfg, f)
                               for f in jcfg.__dataclass_fields__}),
            state_dict=text_state_dict_from_flax(variables), device="cpu")
        names = ["Shoes", "Hats", "Bags", "red running shoe"]
        j = JaxZeroShot.from_texts(names, _Embedder(12), text_encoder=jenc)
        p = ZeroShotLabeler.from_texts(names, _Embedder(12),
                                       text_encoder=penc)
        np.testing.assert_allclose(p.bank, j.bank, **_TOL)


def _bmp(bgr, rng, size=40):
    img = np.full((size, size, 3), bgr, np.uint8)
    img = img + rng.integers(0, 10, img.shape, dtype=np.uint8)
    ok, enc = cv2.imencode(".bmp", img)
    return enc.tobytes()


class TestDetectLabels:
    @pytest.fixture()
    def labelers(self, rng):
        emb = _ColorEmbedder()
        names, vecs = [], []
        for name, bgr in (("red", (0, 0, 220)), ("green", (0, 220, 0)),
                          ("blue", (220, 0, 0))):
            imgs = np.stack([np.full((32, 32, 3), bgr, np.uint8)] * 2)
            vecs.append(emb.embed(imgs).mean(axis=0))
            names.append(name)
        bank = np.stack(vecs)
        return JaxZeroShot(names, bank, emb), ZeroShotLabeler(names, bank,
                                                              emb)

    @pytest.mark.parametrize("bgr,want", [((0, 0, 200), "red"),
                                          ((0, 200, 0), "green"),
                                          ((200, 0, 0), "blue")])
    def test_bmp_matches_jax(self, labelers, rng, bgr, want):
        j, p = labelers
        data = _bmp(bgr, rng)
        got = p.detect_labels(data, 3, 75.0)
        _assert_same([got], [j.detect_labels(data, 3, 75.0)])
        assert got[0].name == want

    def test_undecodable_raises(self, labelers):
        with pytest.raises(ValueError, match="decode"):
            labelers[1].detect_labels(b"not an image", 3, 75.0)


class TestCreateLabeler:
    def test_zero_shot_backend(self, tmp_path, monkeypatch):
        monkeypatch.delenv("IMAGECLUST_LABEL_BANK", raising=False)
        inner = create_labeler(LabelConfig(backend="zero_shot", cache=False),
                               embedder=_Embedder(16))
        assert isinstance(inner, ZeroShotLabeler)
        assert inner.bank.shape == (len(_VOCAB), 16)
        cached = create_labeler(LabelConfig(backend="zero_shot"),
                                str(tmp_path), embedder=_Embedder(16))
        assert isinstance(cached, CachedLabeler)
        assert isinstance(cached.inner, ZeroShotLabeler)

    def test_text_checkpoint_from_config(self, tmp_path, monkeypatch):
        monkeypatch.delenv("IMAGECLUST_LABEL_BANK", raising=False)
        ckpt = _hf_text_npz(tmp_path / "text.npz", 16)
        zs = create_labeler(LabelConfig(backend="zero_shot",
                                        text_checkpoint_path=ckpt),
                            embedder=_Embedder(16))
        want = JaxZeroShot.default(_Embedder(16), text_checkpoint=ckpt)
        np.testing.assert_allclose(zs.bank, want.bank, **_TOL)

    def test_rekognition_still_raises(self, tmp_path):
        """``backend="rekognition"`` builds the port's RekognitionLabeler,
        wrapped in CachedLabeler when given a cache dir (the name is from
        before Rekognition was ported, when it refused)."""
        from imageclust_tpu_torch.labels.rekognition import (
            RekognitionLabeler,
        )

        cfg = LabelConfig(backend="rekognition", region="eu-west-1")
        bare = create_labeler(cfg)
        assert isinstance(bare, RekognitionLabeler)
        assert (bare.region, bare.max_payload_bytes) == (
            "eu-west-1", cfg.max_payload_bytes)
        cached = create_labeler(cfg, str(tmp_path))
        assert isinstance(cached, CachedLabeler)
        assert isinstance(cached.inner, RekognitionLabeler)
        assert cached.namespace == "RekognitionLabeler"

    def test_default_device_needs_cuda(self, monkeypatch):
        """A host array goes to the embedder's device: "cuda" by default,
        which raises without a card."""

        class NoDevice:
            spec = type("spec", (), {"dim": 8})

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        zs = ZeroShotLabeler(["a"], np.ones((1, 8), np.float32), NoDevice())
        with pytest.raises(RuntimeError, match="CUDA"):
            zs.labels_from_embeddings(np.ones((2, 8), np.float32), 1, 0.0)
