"""The port's ViT/SigLIP towers (``imageclust_tpu_torch/models/vit.py``)
against the JAX package's Flax towers on the same weights, the HF CLIP
loader, the registry and the ViT slice end to end.

Weights cross over by converting Flax variables (models/convert.py) or by
loading one synthetic HF state dict into both packages. Tolerances: float32
compute and norms allclose at rtol = atol = 1e-4 (the frameworks reduce the
matmuls and LayerNorm variances in different orders; Flax uses
E[x²] - E[x]²); bfloat16 compute and norms per-row cosine >= 0.99 (bf16
rounds at other points).
"""

import logging

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.config import AppConfig as JaxAppConfig
from imageclust_tpu.config import EmbedConfig as JaxEmbedConfig
from imageclust_tpu.config import LabelConfig as JaxLabelConfig
from imageclust_tpu.config import NamingConfig as JaxNamingConfig
from imageclust_tpu.models import vit as jax_vit
from imageclust_tpu.models.registry import create_embedder as jax_create
from imageclust_tpu.models.registry import list_models as jax_list_models
from imageclust_tpu.pipeline import Pipeline as JaxPipeline
from imageclust_tpu.types import UploadedImage as JaxUpload
from imageclust_tpu_torch import cli
from imageclust_tpu_torch.config import (
    AppConfig,
    EmbedConfig,
    LabelConfig,
    NamingConfig,
)
from imageclust_tpu_torch.models import create_embedder, list_models
from imageclust_tpu_torch.models import vit
from imageclust_tpu_torch.models.convert import vit_state_dict_from_flax
from imageclust_tpu_torch.pipeline import Pipeline
from imageclust_tpu_torch.types import UploadedImage

from helpers import color_group_images

torch.set_num_threads(1)

_CLIP = vit.ViTConfig(patch=8, width=32, depth=2, heads=4, proj_dim=16,
                      image_size=32)
_SIGLIP = vit.ViTConfig(patch=8, width=32, depth=2, heads=4, proj_dim=32,
                        image_size=32, use_class_token=False,
                        quick_gelu=False, mean=(0.5, 0.5, 0.5),
                        std=(0.5, 0.5, 0.5))
_STYLES = {"clip": _CLIP, "siglip": _SIGLIP}
# the port's ViTConfig fields that the JAX package's lacks, and the towers
# only the port has
_PORT_FIELDS = ("mlp_dim", "gelu_approx", "ln_eps", "map_head", "projection")
_PORT_TOWERS = ("siglip_so400m_384",)


def _jax_cfg(cfg):
    """The JAX package's ViTConfig with the port config's JAX fields."""
    return jax_vit.ViTConfig(**{f: getattr(cfg, f) for f in
                                jax_vit.ViTConfig.__dataclass_fields__})


def _flax_variables(cfg, seed=0):
    """Flax init with every bias, LayerNorm scale and shift perturbed (the
    init's zeros and ones would leave them untested)."""
    model = jax_vit.VisionTransformer(
        _jax_cfg(cfg), dtype=jnp.float32)
    x = jnp.zeros((1, 3, cfg.image_size, cfg.image_size), jnp.float32)
    v = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed), x))
    rng = np.random.default_rng(seed)

    def perturb(tree):
        out = {}
        for key, t in tree.items():
            if isinstance(t, dict):
                out[key] = perturb(t)
            elif key in ("scale", "bias"):
                base = 1.0 if key == "scale" else 0.0
                out[key] = (base + rng.uniform(-0.1, 0.1, t.shape)).astype(
                    np.float32)
            else:
                out[key] = t
        return out

    return {"params": perturb(v["params"])}


def _images(cfg, b=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (b, cfg.image_size, cfg.image_size, 3)).astype(np.float32)


def _flax_apply(cfg, variables, x, dtype):
    dt = jnp.dtype(dtype)
    model = jax_vit.VisionTransformer(_jax_cfg(cfg), dtype=dt, norm_dtype=dt)
    emb, feat = model.apply(variables, jnp.asarray(x), return_features=True)
    return np.asarray(emb, np.float32), np.asarray(feat, np.float32)


def _port(cfg, state_dict, dtype):
    model = vit.VisionTransformer(cfg, dtype=dtype, norm_dtype=dtype)
    model.load_state_dict(state_dict)
    return model.eval()


def _port_apply(model, x):
    with torch.inference_mode():
        emb, feat = model(torch.from_numpy(x), return_features=True)
    return emb.float().numpy(), feat.float().numpy()


def _cosine_min(a, b):
    return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                    * np.linalg.norm(b, axis=1))).min())


def _assert_close(got, want, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert _cosine_min(got, want) >= 0.99


class TestTower:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("style", ["clip", "siglip"])
    def test_matches_flax(self, style, dtype):
        cfg = _STYLES[style]
        v = _flax_variables(cfg, seed=1)
        x = _images(cfg)
        want_emb, want_feat = _flax_apply(cfg, v, x, dtype)
        model = _port(cfg, vit_state_dict_from_flax(v, cfg), dtype)
        got_emb, got_feat = _port_apply(model, x)
        assert got_emb.shape == (3, cfg.proj_dim)
        assert got_feat.shape == (3, cfg.width)
        _assert_close(got_emb, want_emb, dtype)
        _assert_close(got_feat, want_feat, dtype)

    def test_nchw_input_matches_nhwc(self):
        v = _flax_variables(_CLIP)
        model = _port(_CLIP, vit_state_dict_from_flax(v, _CLIP), "float32")
        x = _images(_CLIP)
        with torch.inference_mode():
            a = model(torch.from_numpy(x))
            b = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        assert torch.equal(a, b)

    def test_siglip_has_patch_bias_and_no_class_token(self):
        sd = vit.VisionTransformer(_SIGLIP).state_dict()
        assert "patch.bias" in sd and "class_token" not in sd
        assert "ln_pre.weight" not in sd
        sd = vit.VisionTransformer(_CLIP).state_dict()
        assert "patch.bias" not in sd and "class_token" in sd

    def test_seeded_random_init(self):
        a = vit.VisionTransformer(_CLIP).init_random(3).state_dict()
        b = vit.VisionTransformer(_CLIP).init_random(3).state_dict()
        c = vit.VisionTransformer(_CLIP).init_random(4).state_dict()
        assert all(torch.equal(a[k], b[k]) for k in a)
        assert not torch.equal(a["block0.q.weight"], c["block0.q.weight"])
        assert torch.all(a["block0.ln1.weight"] == 1)
        assert torch.all(a["block0.q.bias"] == 0)
        # lecun normal: variance 1 / fan_in; normal(0.02) for the tables
        big = vit.VisionTransformer(vit.ViTConfig(
            patch=8, width=256, depth=1, heads=4, proj_dim=8,
            image_size=32)).init_random(0).state_dict()
        assert abs(float(big["block0.mlp_up.weight"].std()) - 256 ** -0.5) \
            < 0.1 * 256 ** -0.5
        assert abs(float(big["pos_embed"].std()) - 0.02) < 0.002

    def test_converter_reports_every_problem(self):
        v = _flax_variables(_CLIP)
        v["params"]["block0"]["q"]["kernel"] = np.zeros((3, 3), np.float32)
        del v["params"]["ln_post"]
        v["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        with pytest.raises(ValueError) as err:
            vit_state_dict_from_flax(v, _CLIP)
        msg = str(err.value)
        assert "block0.q.weight: shape" in msg
        assert "ln_post.weight: missing" in msg
        assert "extra.weight: unexpected" in msg


@pytest.mark.parametrize("name", sorted(jax_vit.VIT_CONFIGS))
def test_full_width_structure(name):
    """Every full-width tower of the JAX package: the port's config has
    its fields and values, the port's own fields at their defaults, and the
    Flax parameter shapes (jax.eval_shape, no compute) map one to one onto
    the port's state_dict (meta device)."""
    jcfg = jax_vit.VIT_CONFIGS[name]
    port = vit.VIT_CONFIGS[name]
    assert {f: getattr(port, f) for f in jcfg.__dict__} == jcfg.__dict__
    assert set(port.__dict__) - set(jcfg.__dict__) == set(_PORT_FIELDS)
    default = vit.ViTConfig(patch=1, width=1, depth=1, heads=1, proj_dim=1)
    assert all(getattr(port, f) == getattr(default, f) for f in _PORT_FIELDS)
    model = jax_vit.VisionTransformer(jcfg)
    x = jax.ShapeDtypeStruct((1, 3, jcfg.image_size, jcfg.image_size),
                             jnp.float32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), x)["params"]
    want = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]:
        names = [p.key for p in path]
        shape = tuple(leaf.shape)
        if names[-1] == "kernel":
            shape = ((shape[3], shape[2], shape[0], shape[1])
                     if len(shape) == 4 else shape[::-1])
            names[-1] = "weight"
        elif names[-1] == "scale":
            names[-1] = "weight"
        want[".".join(names)] = shape
    with torch.device("meta"):
        port = vit.VisionTransformer(vit.VIT_CONFIGS[name])
    got = {k: tuple(t.shape) for k, t in port.state_dict().items()}
    assert got == want


def _hf_state_dict(cfg, variables, as_torch=False, projection=True):
    """A HF CLIPVisionModel-shaped state dict from Flax params (the layout
    of tests/test_models.py's round trip)."""
    p = variables["params"]
    sd = {
        "vision_model.embeddings.patch_embedding.weight":
            np.transpose(p["patch"]["kernel"], (3, 2, 0, 1)),
        "vision_model.embeddings.position_embedding.weight":
            p["pos_embed"][0],
        "vision_model.post_layernorm.weight": p["ln_post"]["scale"],
        "vision_model.post_layernorm.bias": p["ln_post"]["bias"],
    }
    if cfg.use_class_token:
        sd["vision_model.embeddings.class_embedding"] = \
            p["class_token"].reshape(-1)
        sd["vision_model.pre_layrnorm.weight"] = p["ln_pre"]["scale"]
        sd["vision_model.pre_layrnorm.bias"] = p["ln_pre"]["bias"]
    else:
        sd["vision_model.embeddings.patch_embedding.bias"] = \
            p["patch"]["bias"]
    if projection:
        sd["visual_projection.weight"] = p["projection"]["kernel"].T
    for i in range(cfg.depth):
        blk = p[f"block{i}"]
        hf = f"vision_model.encoder.layers.{i}"
        for ours, theirs in (("ln1", "layer_norm1"), ("ln2", "layer_norm2")):
            sd[f"{hf}.{theirs}.weight"] = blk[ours]["scale"]
            sd[f"{hf}.{theirs}.bias"] = blk[ours]["bias"]
        for ours, theirs in [("q", "self_attn.q_proj"),
                             ("k", "self_attn.k_proj"),
                             ("v", "self_attn.v_proj"),
                             ("proj", "self_attn.out_proj"),
                             ("mlp_up", "mlp.fc1"), ("mlp_down", "mlp.fc2")]:
            sd[f"{hf}.{theirs}.weight"] = blk[ours]["kernel"].T
            sd[f"{hf}.{theirs}.bias"] = blk[ours]["bias"]
    sd = {k: np.ascontiguousarray(v, np.float32) for k, v in sd.items()}
    if as_torch:
        sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    return sd


class TestClipLoader:
    @pytest.mark.parametrize("as_torch", [False, True])
    def test_hf_round_trip_matches_jax_loader(self, as_torch):
        cfg = _CLIP
        v = _flax_variables(cfg, seed=2)
        sd = _hf_state_dict(cfg, v, as_torch=as_torch)
        jax_loaded = jax_vit.load_clip_vision_torch(
            {k: np.asarray(t) for k, t in sd.items()},
            _jax_cfg(cfg), dict(v))
        x = _images(cfg, seed=4)
        want, _ = _flax_apply(cfg, jax_loaded, x, "float32")
        port_sd = vit.load_clip_vision_state_dict(sd, cfg)
        got, _ = _port_apply(_port(cfg, port_sd, "float32"), x)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        # the same tensors as the Flax conversion, name for name
        flax_sd = vit_state_dict_from_flax(v, cfg)
        assert set(port_sd) == set(flax_sd)
        assert all(torch.equal(port_sd[k], flax_sd[k]) for k in port_sd)

    def test_missing_projection_keeps_the_towers_own(self):
        v = _flax_variables(_CLIP, seed=3)
        sd = vit.load_clip_vision_state_dict(
            _hf_state_dict(_CLIP, v, projection=False), _CLIP)
        assert "projection.weight" not in sd
        model = vit.VisionTransformer(_CLIP).init_random(0)
        own = model.projection.weight.clone()
        model.load_state_dict(sd, strict=False)
        assert torch.equal(model.projection.weight, own)

    def test_siglip_style_needs_patch_bias(self):
        v = _flax_variables(_SIGLIP, seed=5)
        sd = _hf_state_dict(_SIGLIP, v)
        x = _images(_SIGLIP)
        got, _ = _port_apply(
            _port(_SIGLIP, vit.load_clip_vision_state_dict(sd, _SIGLIP),
                  "float32"), x)
        want, _ = _flax_apply(_SIGLIP, v, x, "float32")
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        del sd["vision_model.embeddings.patch_embedding.bias"]
        with pytest.raises(ValueError, match="patch_embedding.bias: missing"):
            vit.load_clip_vision_state_dict(sd, _SIGLIP)

    def test_rejects_shape_mismatch(self):
        """tests/test_models.py's rejection, and a full report."""
        with pytest.raises(ValueError, match="patch_embedding.weight"):
            vit.load_clip_vision_state_dict(
                {"vision_model.embeddings.patch_embedding.weight":
                 np.zeros((9, 9), np.float32)}, _CLIP)
        sd = _hf_state_dict(_CLIP, _flax_variables(_CLIP))
        sd["vision_model.encoder.layers.1.mlp.fc1.weight"] = np.zeros(
            (4, 4), np.float32)
        with pytest.raises(ValueError, match=r"fc1.weight: \(4, 4\)"):
            vit.load_clip_vision_state_dict(sd, _CLIP)


@pytest.fixture()
def tiny_towers(monkeypatch):
    """Every ViT name of both packages mapped to a tiny tower of its own
    style (class token, GELU, normalisation and input size kept; the
    port's own towers keep their head and an MLP that is not 4 x width)."""
    for name, c in list(vit.VIT_CONFIGS.items()):
        tiny = dict(c.__dict__, width=32, depth=2, heads=4,
                    image_size=c.patch * 4)
        if c.mlp_dim:
            tiny["mlp_dim"] = 88
        if not c.projection:
            tiny["proj_dim"] = 32
        monkeypatch.setitem(vit.VIT_CONFIGS, name, vit.ViTConfig(**tiny))
        if name not in _PORT_TOWERS:
            monkeypatch.setitem(jax_vit.VIT_CONFIGS, name,
                                _jax_cfg(vit.ViTConfig(**tiny)))


class TestRegistry:
    def test_list_models_matches_jax(self):
        """The JAX package's names in its order, then the port's own."""
        ours = [m for m in list_models() if m not in _PORT_TOWERS]
        assert ours == jax_list_models()
        assert list_models() == jax_list_models() + list(_PORT_TOWERS)
        assert len(jax_list_models()) == 6 and len(list_models()) == 7

    @pytest.mark.parametrize("name", sorted(vit.VIT_CONFIGS))
    def test_builds_and_embeds_every_tower(self, tiny_towers, name):
        cfg = vit.VIT_CONFIGS[name]
        emb = create_embedder(EmbedConfig(model=name, batch_size=4),
                              device="cpu")
        assert emb.spec.input_size == cfg.image_size
        assert emb.spec.dim == cfg.proj_dim
        assert emb.tag == f"{name}:logits:torch-randominit-0"
        assert not emb.weights_loaded
        u8 = np.random.default_rng(0).integers(
            0, 256, (5, cfg.image_size, cfg.image_size, 3)).astype(np.uint8)
        out = emb.embed(u8)
        assert out.shape == (5, cfg.proj_dim) and np.isfinite(out).all()

    @pytest.mark.parametrize("name", ["vit_b32", "siglip_so400m"])
    def test_int8_vit_not_ported(self, tiny_towers, name):
        """int8 PTQ is ported (it raised here before): the tower is a
        QuantViT tagged with the JAX package's quantize suffix."""
        from imageclust_tpu_torch.models.quantize_vit import QuantViT

        cfg = vit.VIT_CONFIGS[name]
        emb = create_embedder(EmbedConfig(model=name, quantize="int8",
                                          batch_size=4), device="cpu")
        assert isinstance(emb.model, QuantViT)
        assert emb.tag == f"{name}:logits:int8-absmax:torch-randominit-0"
        u8 = np.random.default_rng(0).integers(
            0, 256, (5, cfg.image_size, cfg.image_size, 3)).astype(np.uint8)
        out = emb.embed(u8)
        assert out.shape == (5, cfg.proj_dim) and np.isfinite(out).all()

    @pytest.mark.parametrize("ext", [".npz", ".pt", ".bin"])
    def test_loads_hf_checkpoint(self, tiny_towers, tmp_path, ext):
        cfg = vit.VIT_CONFIGS["vit_b32"]
        v = _flax_variables(cfg, seed=6)
        sd = _hf_state_dict(cfg, v)
        path = str(tmp_path / f"clip{ext}")
        if ext == ".npz":
            np.savez(path, **sd)
        else:
            torch.save({k: torch.from_numpy(t) for k, t in sd.items()}, path)
        ecfg = EmbedConfig(model="vit_b32", onnx_path=path, dtype="float32",
                           norm_dtype="float32")
        emb = create_embedder(ecfg, device="cpu")
        assert emb.weights_loaded
        assert emb.tag.startswith("vit_b32:logits:torch-")
        assert "randominit" not in emb.tag
        want = _port(cfg, vit_state_dict_from_flax(v, cfg), "float32")
        assert all(torch.equal(t, want.state_dict()[k])
                   for k, t in emb.model.state_dict().items())

    def test_default_onnx_path_is_skipped_quietly(self, tiny_towers,
                                                   caplog):
        with caplog.at_level(logging.WARNING):
            emb = create_embedder(EmbedConfig(model="vit_b32"), device="cpu")
        assert not emb.weights_loaded
        assert not [r for r in caplog.records if "ViT" in r.getMessage()]

    @pytest.mark.parametrize("fname,make", [("missing.pt", False),
                                            ("clip.safetensors", True)])
    def test_unloadable_path_warns(self, tiny_towers, tmp_path, caplog,
                                   fname, make):
        path = tmp_path / fname
        if make:
            path.write_bytes(b"\0" * 16)
        with caplog.at_level(logging.WARNING):
            emb = create_embedder(EmbedConfig(model="vit_b32",
                                              onnx_path=str(path)),
                                  device="cpu")
        assert not emb.weights_loaded
        assert any("not loaded" in r.getMessage() for r in caplog.records)

    def test_orbax_checkpoint_not_ported(self, tiny_towers, tmp_path):
        """``embed.checkpoint_path`` loads no ViT weights, as in the JAX
        package (registry.py:499-520): the tower is the seeded init, and
        the cache tag is the JAX tag's ``ckpt-`` fingerprint under the
        port's ``torch-`` prefix."""
        from imageclust_tpu_torch.utils.checkpoint import save_variables

        ck = str(tmp_path / "ckpt")
        save_variables(ck, {"a": np.zeros(1, np.float32)})
        cfg = dict(model="vit_b32", checkpoint_path=ck, batch_size=4)
        emb = create_embedder(EmbedConfig(**cfg), device="cpu")
        plain = create_embedder(EmbedConfig(model="vit_b32", batch_size=4),
                                device="cpu")
        jemb = jax_create(JaxEmbedConfig(**cfg, cache=False))
        assert not emb.weights_loaded and not jemb.weights_loaded
        for k, v in plain.model.state_dict().items():
            assert torch.equal(emb.model.state_dict()[k], v), k
        assert ":ckpt-" in jemb.tag
        assert emb.tag == jemb.tag.replace(":ckpt-", ":torch-ckpt-")


def _jax_and_port_embedders(name, batch=8):
    """JAX and port embedders of tower ``name`` (float32) on the same
    variables: the JAX random init, converted into the port."""
    jcfg = JaxEmbedConfig(model=name, dtype="float32", norm_dtype="float32",
                          batch_size=batch, cache=False)
    jax_emb = jax_create(jcfg)
    port_emb = create_embedder(
        EmbedConfig(model=name, dtype="float32", norm_dtype="float32",
                    batch_size=batch, cache=False),
        device="cpu", variables=jax.tree.map(np.asarray, jax_emb.variables))
    return jax_emb, port_emb


class TestEmbedderParity:
    @pytest.mark.parametrize("name", ["vit_b32", "siglip_so400m"])
    def test_embed_matches_jax(self, tiny_towers, name):
        jax_emb, port_emb = _jax_and_port_embedders(name)
        assert port_emb.tag.startswith(f"{name}:logits:flax-")
        size = vit.VIT_CONFIGS[name].image_size
        rng = np.random.default_rng(7)
        u8 = rng.integers(0, 256, (5, size, size, 3)).astype(np.uint8)
        np.testing.assert_allclose(port_emb.embed(u8), jax_emb.embed(u8),
                                   rtol=1e-4, atol=1e-4)
        # not at the input size: the device resize first
        odd = rng.integers(0, 256, (3, 40, 56, 3)).astype(np.uint8)
        np.testing.assert_allclose(port_emb.embed(odd), jax_emb.embed(odd),
                                   rtol=1e-4, atol=1e-4)


class TestEmbedBlob:
    """``Embedder.embed_blob`` on a normalised (N, 3, S, S) blob against the
    JAX ``Embedder.embed_blob`` on the same variables: f32 allclose at
    1e-4, bf16 per-row cosine >= 0.99."""

    @pytest.mark.parametrize("name", ["vit_b32", "siglip_so400m"])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_matches_jax(self, tiny_towers, name, dtype):
        jax_emb = jax_create(JaxEmbedConfig(
            model=name, dtype=dtype, norm_dtype=dtype, batch_size=8,
            cache=False))
        port_emb = create_embedder(
            EmbedConfig(model=name, dtype=dtype, norm_dtype=dtype,
                        batch_size=8, cache=False),
            device="cpu",
            variables=jax.tree.map(np.asarray, jax_emb.variables))
        size = vit.VIT_CONFIGS[name].image_size
        blob = np.random.default_rng(9).standard_normal(
            (5, 3, size, size)).astype(np.float32)
        got = port_emb.embed_blob(blob)
        want = np.asarray(jax_emb.embed_blob(blob), np.float32)
        assert got.dtype == np.float32 and got.shape == want.shape
        _assert_close(got, want, dtype)


def test_pipeline_slice_matches_jax(tiny_towers, tmp_path):
    """The ViT slice end to end: ``embed.model=vit_b32`` (a tiny tower under
    that name) through both pipelines on 24 colour-block images. The
    embeddings agree to the float32 tolerance and the partitions are
    equal."""
    rng = np.random.default_rng(8)
    names, blobs = color_group_images(rng, n_groups=4, per_group=6)
    jax_emb, port_emb = _jax_and_port_embedders("vit_b32")
    imgs = np.stack([cv2.imdecode(np.frombuffer(b, np.uint8),
                                  cv2.IMREAD_COLOR) for b in blobs])
    np.testing.assert_allclose(port_emb.embed(imgs), jax_emb.embed(imgs),
                               rtol=1e-4, atol=1e-4)
    jcfg = JaxAppConfig(embed=JaxEmbedConfig(model="vit_b32", cache=False),
                        labels=JaxLabelConfig(backend="fake"),
                        naming=JaxNamingConfig(services=("fake",),
                                               retries=1))
    pcfg = AppConfig(embed=EmbedConfig(model="vit_b32", cache=False),
                     labels=LabelConfig(backend="fake"),
                     naming=NamingConfig(services=("fake",), retries=1))
    want = JaxPipeline(jcfg, embedder=jax_emb).run(
        [JaxUpload(n, b) for n, b in zip(names, blobs)],
        str(tmp_path / "jax"), min_size=3, max_size=6)
    got = Pipeline(pcfg, device="cpu", embedder=port_emb).run(
        [UploadedImage(n, b) for n, b in zip(names, blobs)],
        str(tmp_path / "port"), min_size=3, max_size=6)

    def view(res):
        return ({k: d.images for k, d in res.clusters.items()},
                sorted(res.dropped))

    assert view(got) == view(want)
    assert len(got.clusters) >= 4


class TestCli:
    def test_model_flag_accepts_every_tower(self):
        parser = cli.build_parser()
        for name in list_models():
            args = parser.parse_args(["run", "--images", "d", "--model",
                                      name])
            assert cli._build_config(args).embed.model == name
        with pytest.raises(SystemExit):
            parser.parse_args(["run", "--images", "d", "--model", "nope"])

    def test_help_lists_every_tower(self, capsys):
        with pytest.raises(SystemExit):
            cli.build_parser().parse_args(["run", "--help"])
        out = capsys.readouterr().out
        assert all(name in out for name in list_models())

    def test_cli_run_vit(self, tiny_towers, tmp_path, capsys):
        import json

        rng = np.random.default_rng(9)
        names, blobs = color_group_images(rng, n_groups=3, per_group=4)
        img_dir = tmp_path / "images"
        img_dir.mkdir()
        for n, b in zip(names, blobs):
            (img_dir / n).write_bytes(b)
        rc = cli.main(["run", "--images", str(img_dir), "--device", "cpu",
                       "--model", "vit_b32", "--labeler", "fake",
                       "--namers", "fake", "--out", str(tmp_path / "w")])
        assert rc == 0
        result = json.loads(capsys.readouterr().out)
        placed = [m for c in result["clusters"].values() for m in c["images"]]
        assert sorted(placed + result["dropped"]) == sorted(names)
