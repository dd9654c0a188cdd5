"""The port's CLIP text tower (``imageclust_tpu_torch/models/text.py``)
against the JAX package's Flax tower on the same weights: the transformer
under both pooling conventions, the hashing tokenizer, the HF state-dict
loader and config inference, ``TextEncoder.encode`` and the BPE adoption
rules.

Weights cross over by converting Flax variables
(``text_state_dict_from_flax``) or by loading one seeded HF-named state
dict into both packages. Tolerance: float32 allclose at rtol = atol = 1e-5.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.models import text as jax_text
from imageclust_tpu.models import tokenizer as jax_tokmod
from imageclust_tpu_torch.models import text
from imageclust_tpu_torch.models import tokenizer as tokmod
from imageclust_tpu_torch.models.convert import text_state_dict_from_flax

torch.set_num_threads(1)

_KW = dict(vocab=512, width=64, depth=2, heads=2, proj_dim=32, context=16)
_TOL = dict(rtol=1e-5, atol=1e-5)
MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("o", "</w>"),
          ("hell", "o</w>"), ("w", "o"), ("r", "l"), ("d", "</w>")]


def _cfgs(**kw):
    kw = {**_KW, **kw}
    return jax_text.TextConfig(**kw), text.TextConfig(**kw)


def _flax_variables(cfg, seed=0):
    """Flax init with every bias, LayerNorm scale and shift perturbed."""
    model = jax_text.TextTransformer(cfg)
    v = model.init(jax.random.PRNGKey(seed),
                   jnp.zeros((1, cfg.context), jnp.int32))
    rng = np.random.default_rng(seed + 1)
    return jax.tree.map(
        lambda a: (np.asarray(a) + rng.normal(0, 0.05, a.shape)).astype(
            np.float32), v)


def _port_tower(cfg, variables):
    m = text.TextTransformer(cfg)
    m.load_state_dict(text_state_dict_from_flax(variables))
    return m.eval()


def _hf_state_dict(cfg, seed=0, projection=True):
    """A seeded HF CLIPTextModel(+projection) state dict (numpy)."""
    rng = np.random.default_rng(seed)
    w, pre = cfg.width, "text_model."

    def normal(*shape, s=0.05):
        return rng.normal(0, s, shape).astype(np.float32)

    sd = {pre + "embeddings.token_embedding.weight": normal(cfg.vocab, w),
          pre + "embeddings.position_embedding.weight": normal(cfg.context,
                                                               w)}
    for i in range(cfg.depth):
        hf = f"{pre}encoder.layers.{i}"
        for name in ("layer_norm1", "layer_norm2"):
            sd[f"{hf}.{name}.weight"] = 1 + normal(w)
            sd[f"{hf}.{name}.bias"] = normal(w)
        for name, (o, n) in (("self_attn.q_proj", (w, w)),
                             ("self_attn.k_proj", (w, w)),
                             ("self_attn.v_proj", (w, w)),
                             ("self_attn.out_proj", (w, w)),
                             ("mlp.fc1", (4 * w, w)),
                             ("mlp.fc2", (w, 4 * w))):
            sd[f"{hf}.{name}.weight"] = normal(o, n, s=n ** -0.5)
            sd[f"{hf}.{name}.bias"] = normal(o)
    sd[pre + "final_layer_norm.weight"] = 1 + normal(w)
    sd[pre + "final_layer_norm.bias"] = normal(w)
    if projection:
        sd["text_projection.weight"] = normal(cfg.proj_dim, w, s=w ** -0.5)
    return sd


def _tokens(cfg, n=6, seed=0, eot=None):
    rng = np.random.default_rng(seed)
    toks = np.zeros((n, cfg.context), np.int32)
    for r in range(n):
        length = int(rng.integers(2, cfg.context + 1))
        toks[r, :length] = rng.integers(3, cfg.vocab - 1, length)
        toks[r, 0] = 1
        toks[r, length - 1] = cfg.vocab - 1 if eot is None else eot
    return toks


class TestTower:
    @pytest.mark.parametrize("eot_id", [None, 2])
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_flax(self, eot_id, seed):
        jcfg, pcfg = _cfgs(eot_id=eot_id)
        variables = _flax_variables(jcfg, seed)
        toks = _tokens(jcfg, seed=seed, eot=eot_id)
        want = np.asarray(jax_text.TextTransformer(jcfg).apply(
            variables, jnp.asarray(toks)))
        got = _port_tower(pcfg, variables)(torch.from_numpy(toks))
        np.testing.assert_allclose(got.detach().numpy(), want, **_TOL)

    def test_causal_attention_matches_jax(self):
        rng = np.random.default_rng(3)
        q, k, v = (rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
                   for _ in range(3))
        mask = jnp.tril(jnp.ones((7, 7), bool))[None, None]
        want = np.asarray(jax.nn.dot_product_attention(q, k, v, mask=mask))
        got = text.causal_attention(*(torch.from_numpy(a) for a in (q, k, v)))
        np.testing.assert_allclose(got.numpy(), want, **_TOL)

    def test_no_eot_pools_position_zero(self):
        jcfg, pcfg = _cfgs(eot_id=2)
        variables = _flax_variables(jcfg)
        toks = _tokens(jcfg, eot=5)  # no id 2 anywhere
        want = np.asarray(jax_text.TextTransformer(jcfg).apply(
            variables, jnp.asarray(toks)))
        got = _port_tower(pcfg, variables)(torch.from_numpy(toks))
        np.testing.assert_allclose(got.detach().numpy(), want, **_TOL)

    def test_full_width_shapes(self):
        """CLIP ViT-B/32's text tower: every parameter shape equals the
        Flax tower's (no forward pass)."""
        jcfg, pcfg = jax_text.TextConfig(), text.TextConfig()
        shapes = jax.eval_shape(
            jax_text.TextTransformer(jcfg).init, jax.random.PRNGKey(0),
            jnp.zeros((1, 77), jnp.int32))
        flax = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        with torch.device("meta"):
            tower = text.TextTransformer(pcfg)
        got = {k: tuple(v.shape) for k, v in tower.state_dict().items()}
        want = {k: tuple(v.shape)
                for k, v in text_state_dict_from_flax(flax).items()}
        assert got == want
        assert got["token_embed.weight"] == (49408, 512)
        assert got["pos_embed"] == (1, 77, 512)
        assert got["block11.mlp_up.weight"] == (2048, 512)
        assert got["projection.weight"] == (512, 512)
        assert sum(int(np.prod(s)) for s in got.values()) == 63_428_096

    def test_convert_rejects_bad_tree(self):
        jcfg, _ = _cfgs()
        variables = _flax_variables(jcfg)
        variables["params"]["block0"]["q"]["kernel"] = np.zeros((3, 3))
        with pytest.raises(ValueError, match="block0.q.weight"):
            text_state_dict_from_flax(variables)
        with pytest.raises(ValueError, match="not a text tower"):
            text_state_dict_from_flax({"params": {}})


class TestHashTokenize:
    @pytest.mark.parametrize("s", ["Red Running Shoes", "", "  a  b  ",
                                   "HELLO world", " ".join(["w"] * 100),
                                   "café 中文"])
    @pytest.mark.parametrize("vocab,context", [(1000, 16), (16384, 77),
                                               (49408, 8)])
    def test_bit_equal(self, s, vocab, context):
        got = text.hash_tokenize(s, vocab, context)
        want = jax_text.hash_tokenize(s, vocab, context)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


class TestHfLoader:
    @pytest.mark.parametrize("projection", [True, False])
    def test_config_inferred_equal(self, projection):
        sd = _hf_state_dict(_cfgs()[1], projection=projection)
        got = text.text_config_from_state_dict(sd)
        want = jax_text.text_config_from_state_dict(sd)
        assert dataclasses_equal(got, want)
        tsd = {k: torch.from_numpy(v) for k, v in sd.items()}
        assert dataclasses_equal(text.text_config_from_state_dict(tsd), want)

    def test_loader_matches_jax(self):
        jcfg, pcfg = _cfgs()
        sd = _hf_state_dict(pcfg)
        init = jax_text.TextTransformer(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
        jvars = jax_text.load_clip_text_torch(sd, jcfg, init)
        got = text.load_clip_text_state_dict(sd, pcfg)
        want = text_state_dict_from_flax(jax.tree.map(np.asarray, jvars))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k].numpy())

    @pytest.mark.parametrize("fmt", ["pt", "npz"])
    @pytest.mark.parametrize("projection", [True, False])
    def test_from_checkpoint_matches_jax(self, tmp_path, fmt, projection,
                                         monkeypatch):
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)
        jcfg, pcfg = _cfgs(heads=1)  # the heads width // 64 infers
        sd = _hf_state_dict(pcfg, projection=projection)
        path = str(tmp_path / f"text.{fmt}")
        if fmt == "npz":
            np.savez(path, **sd)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
        jenc = jax_text.TextEncoder.from_checkpoint(path)
        penc = text.TextEncoder.from_checkpoint(path, device="cpu")
        assert penc.weights_loaded and penc.tokenizer is None
        assert dataclasses_equal(penc.cfg, jenc.cfg)
        state = penc.model.state_dict()
        want = text_state_dict_from_flax(
            jax.tree.map(np.asarray, jenc.variables))
        for k in want:
            if k == "projection.weight" and not projection:
                continue  # each package keeps its own seeded projection
            np.testing.assert_array_equal(state[k].numpy(), want[k].numpy())
        texts = ["a photo of a cat", "three red shoes", ""]
        if projection:
            np.testing.assert_allclose(penc.encode(texts),
                                       jenc.encode(texts), **_TOL)
        else:
            seeded = text.TextTransformer(penc.cfg).init_random(0)
            torch.testing.assert_close(state["projection.weight"],
                                       seeded.projection.weight)

    @pytest.mark.parametrize("key,value", [
        ("text_model.final_layer_norm.weight", np.zeros(7, np.float32)),
        ("text_model.encoder.layers.1.mlp.fc1.weight",
         np.zeros((3, 64), np.float32)),
        ("text_projection.weight", np.zeros((32, 63), np.float32))])
    def test_mismatch_rejected(self, key, value):
        jcfg, pcfg = _cfgs()
        sd = _hf_state_dict(pcfg)
        sd[key] = value
        init = jax_text.TextTransformer(jcfg).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32))
        with pytest.raises(ValueError):
            jax_text.load_clip_text_torch(sd, jcfg, init)
        with pytest.raises(ValueError, match=key.replace("text_model.", "")):
            text.load_clip_text_state_dict(sd, pcfg)

    def test_missing_rejected(self):
        _, pcfg = _cfgs()
        sd = _hf_state_dict(pcfg)
        del sd["text_model.encoder.layers.0.self_attn.v_proj.bias"]
        with pytest.raises(ValueError, match="v_proj.bias: missing"):
            text.load_clip_text_state_dict(sd, pcfg)

    def test_encoder_rejects_partial_state(self):
        _, pcfg = _cfgs(eot_id=2)
        state = text.TextTransformer(pcfg).init_random(0).state_dict()
        del state["block1.ln2.bias"]
        with pytest.raises(ValueError, match="block1.ln2.bias"):
            text.TextEncoder(pcfg, state_dict=state, device="cpu")


def dataclasses_equal(a, b) -> bool:
    return all(getattr(a, f) == getattr(b, f)
               for f in a.__dataclass_fields__)


class TestEncoder:
    @pytest.fixture(scope="class")
    def pair(self):
        jcfg, pcfg = _cfgs(eot_id=2)
        variables = _flax_variables(jcfg, 4)
        jenc = jax_text.TextEncoder(jcfg, variables=variables)
        penc = text.TextEncoder(
            pcfg, state_dict=text_state_dict_from_flax(variables),
            device="cpu")
        return jenc, penc

    @pytest.mark.parametrize("n", [0, 1, 3, 300])
    def test_encode_matches_jax(self, pair, n):
        jenc, penc = pair
        rng = np.random.default_rng(n)
        words = ["red", "shoe", "Cat", "a", "photo", "of", "sky", "x"]
        texts = [" ".join(rng.choice(words, rng.integers(0, 6)))
                 for _ in range(n)]
        got = penc.encode(texts)
        assert got.shape == (n, 32) and got.dtype == np.float32
        np.testing.assert_allclose(got, jenc.encode(texts), **_TOL)

    def test_order_and_batching(self, pair):
        _, penc = pair
        texts = [f"label {i}" for i in range(300)]
        full = penc.encode(texts)
        np.testing.assert_allclose(penc.encode(texts[255:258]),
                                   full[255:258], **_TOL)

    def test_default_tower(self, monkeypatch, tmp_path):
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)
        monkeypatch.setattr(tokmod, "default_bpe_path",
                            lambda: str(tmp_path / "absent.txt"))
        enc = text.TextEncoder(device="cpu")
        assert enc.cfg == text.TextConfig(width=256, depth=4, heads=4,
                                          proj_dim=512, vocab=16384,
                                          eot_id=2)
        out = enc.encode(["shoes", "a red hat", "shoes"])
        np.testing.assert_array_equal(out[0], out[2])
        again = text.TextEncoder(device="cpu").encode(["shoes"])
        np.testing.assert_allclose(out[:1], again, **_TOL)  # seeded init

    def test_default_device_needs_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            text.TextEncoder(_cfgs(eot_id=2)[1])


def _merges_file(tmp_path):
    p = tmp_path / "merges.txt"
    p.write_text("#version: test\n"
                 + "\n".join(f"{a} {b}" for a, b in MERGES))
    return str(p)


class TestBpeAdoption:
    """The JAX TextEncoder's rules (text.py:221-254): a merges file is
    adopted when given or found, except that with weights only an explicit
    ``bpe_path`` or IMAGECLUST_BPE_PATH adopts it."""

    def test_uses_bpe_when_given(self, tmp_path):
        path = _merges_file(tmp_path)
        jcfg, pcfg = _cfgs(vocab=0)
        jenc = jax_text.TextEncoder(cfg=jcfg, bpe_path=path)
        penc = text.TextEncoder(cfg=pcfg, bpe_path=path, device="cpu")
        assert penc.tokenizer is not None and penc.cfg.eot_id is None
        assert penc.cfg.vocab == jenc.cfg.vocab == 512 + len(MERGES) + 2
        for t in ("hello world", "xyz"):
            np.testing.assert_array_equal(penc.tokenize(t), jenc.tokenize(t))
        out = penc.encode(["hello world", "xyz"])
        assert out.shape == (2, 32) and np.isfinite(out).all()

    def test_falls_back_to_hashing(self, tmp_path, monkeypatch):
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)
        enc = text.TextEncoder(bpe_path=str(tmp_path / "absent.txt"),
                               device="cpu")
        assert enc.tokenizer is None and enc.cfg.eot_id == 2

    def test_env_opt_in_with_weights(self, tmp_path, monkeypatch):
        path = _merges_file(tmp_path)
        _, pcfg = _cfgs(vocab=0)
        donor = text.TextEncoder(cfg=pcfg, bpe_path=path, device="cpu")
        monkeypatch.setenv("IMAGECLUST_BPE_PATH", path)
        enc = text.TextEncoder(cfg=pcfg, state_dict=donor.model.state_dict(),
                               device="cpu")
        assert enc.tokenizer is not None
        assert enc.cfg.vocab == donor.cfg.vocab

    def test_conventional_file_not_adopted_with_weights(self, tmp_path,
                                                        monkeypatch):
        path = _merges_file(tmp_path)
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)
        monkeypatch.setattr(tokmod, "default_bpe_path",
                            lambda: str(tmp_path / "absent.txt"))
        donor = text.TextEncoder(device="cpu")
        assert donor.tokenizer is None
        monkeypatch.setattr(tokmod, "default_bpe_path", lambda: path)
        enc = text.TextEncoder(state_dict=donor.model.state_dict(),
                               device="cpu")
        assert enc.tokenizer is None and enc.cfg.vocab == donor.cfg.vocab
        adopted = text.TextEncoder(device="cpu")  # no weights: adopted
        assert adopted.tokenizer is not None

    def test_checkpoint_vocab_mismatch_falls_back(self, tmp_path,
                                                  monkeypatch, caplog):
        """A merges file whose vocabulary does not fit the checkpoint's
        token table: both packages warn and keep the hashing tokenizer."""
        path = _merges_file(tmp_path)
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)
        monkeypatch.setattr(jax_tokmod, "default_bpe_path", lambda: path)
        monkeypatch.setattr(tokmod, "default_bpe_path", lambda: path)
        _, pcfg = _cfgs(heads=1)
        ckpt = str(tmp_path / "text.npz")
        np.savez(ckpt, **_hf_state_dict(pcfg))
        with caplog.at_level(logging.WARNING):
            jenc = jax_text.TextEncoder.from_checkpoint(ckpt)
            penc = text.TextEncoder.from_checkpoint(ckpt, device="cpu")
        assert jenc.tokenizer is None and penc.tokenizer is None
        assert penc.cfg.vocab == 512
        msgs = [r.getMessage() for r in caplog.records
                if r.name == "imageclust_tpu_torch.models.text"]
        assert any("vocabulary size" in m for m in msgs)
        assert any("HASHING tokenizer" in m for m in msgs)
        np.testing.assert_allclose(penc.encode(["a cat"]),
                                   jenc.encode(["a cat"]), **_TOL)

    def test_env_merges_of_another_vocab_fall_back(self, tmp_path,
                                                   monkeypatch, caplog):
        """IMAGECLUST_BPE_PATH naming a merges file of another vocabulary:
        the port warns and keeps the hashing tokenizer. (The JAX package's
        fallback re-adopts the file from the environment and fails at
        apply time, ROADMAP.md queue 3.)"""
        path = _merges_file(tmp_path)
        monkeypatch.setenv("IMAGECLUST_BPE_PATH", path)
        _, pcfg = _cfgs(heads=1)
        ckpt = str(tmp_path / "text.npz")
        np.savez(ckpt, **_hf_state_dict(pcfg))
        with caplog.at_level(logging.WARNING):
            enc = text.TextEncoder.from_checkpoint(ckpt, device="cpu")
        assert enc.tokenizer is None and enc.cfg.eot_id == 2
        assert any("vocabulary size 522" in r.getMessage()
                   for r in caplog.records)
        assert np.isfinite(enc.encode(["a cat"])).all()
        with pytest.raises(ValueError, match="vocabulary size"):
            text.TextEncoder(pcfg, state_dict=enc.model.state_dict(),
                             bpe_path=path, device="cpu")
