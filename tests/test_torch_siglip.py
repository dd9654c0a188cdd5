"""The port's published SigLIP So400m/14@384 vision tower
(``siglip_so400m_384``: ``models/vit.py``'s ``ViTConfig`` fields for the
MLP width, the tanh GELU, the LayerNorm epsilon, the attention-pooling
head and no projection) against the plain reference
``tests/plain_siglip.py`` on seeded HF-named weights, at tiny widths on
the CPU; the head against ``torch.nn.MultiheadAttention``; the published
sizes on the meta device; the HF loader; the int8 tower; the CPU dispatch
above 128 tokens.

Tolerances: float32 within 1e-5 relative (the port and the reference sum
in other orders: the port's patch projection is one matrix product, the
reference's a convolution); bfloat16 compute per-row cosine >= 0.999; the
int8 tower against the float tower the int8 ViT tests' > 0.995.
"""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

import plain_siglip
from imageclust_tpu_torch.config import EmbedConfig
from imageclust_tpu_torch.models import create_embedder, vit
from imageclust_tpu_torch.models.quantize_vit import QuantViT
from imageclust_tpu_torch.ops import attention as at

torch.set_num_threads(1)

NAME = "siglip_so400m_384"
# (patch, image, width, heads, MLP): 40 px leaves 4 rows and columns past
# the last 6-px patch, and head dims 12 and 24 are not powers of two
SHAPES = {"crop_dh12": (6, 40, 48, 4, 88), "exact_dh24": (8, 32, 48, 2, 100)}


def _cfg(patch, image, width, heads, mlp, depth=2):
    return vit.ViTConfig(**dict(vit.VIT_CONFIGS[NAME].__dict__, patch=patch,
                                width=width, depth=depth, heads=heads,
                                proj_dim=width, image_size=image,
                                mlp_dim=mlp))


def _weights(cfg, seed=0):
    return plain_siglip.random_weights(
        cfg.width, cfg.depth, cfg.heads, cfg.mlp_width, cfg.patch,
        (cfg.image_size // cfg.patch) ** 2, seed=seed)


def _images(cfg, n=5, seed=3):
    return torch.randint(0, 256, (n, cfg.image_size, cfg.image_size, 3),
                         dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(seed))


def _rel(got, want):
    return float(((got - want).norm(dim=1) / want.norm(dim=1)).max())


@pytest.fixture()
def tiny(monkeypatch):
    """``siglip_so400m_384`` cut to the first of SHAPES."""
    cfg = _cfg(*SHAPES["crop_dh12"])
    monkeypatch.setitem(vit.VIT_CONFIGS, NAME, cfg)
    return cfg


def test_published_config():
    c = vit.VIT_CONFIGS[NAME]
    assert (c.patch, c.width, c.depth, c.heads, c.image_size) == (
        14, 1152, 27, 16, 384)
    assert (c.mlp_width, c.gelu_approx, c.ln_eps) == (4304, "tanh", 1e-6)
    assert c.map_head and not c.projection and not c.use_class_token
    assert not c.quick_gelu and c.embed_dim == 1152
    assert c.mean == c.std == (0.5, 0.5, 0.5)
    # the JAX package's SigLIP-style tower stays as it was
    old = vit.VIT_CONFIGS["siglip_so400m"]
    assert (old.mlp_width, old.gelu_approx, old.ln_eps) == (
        4608, "none", 1e-5)
    assert not old.map_head and old.projection and old.image_size == 224


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_float32_matches_plain_reference(shape):
    cfg = _cfg(*SHAPES[shape])
    w = _weights(cfg, seed=1)
    model = vit.VisionTransformer(cfg, dtype="float32", norm_dtype="float32")
    model.load_state_dict(vit.load_siglip_vision_state_dict(w, cfg))
    images = _images(cfg)
    x = (images.flip(-1).float() / 255.0 - 0.5) / 0.5
    with torch.inference_mode():
        emb, feat = model.eval()(x, return_features=True)
    want = plain_siglip.embed(w, images, cfg.heads)
    assert emb.shape == (5, cfg.width) and torch.equal(emb, feat)
    assert _rel(emb, want) < 1e-5


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_bfloat16_matches_plain_reference(shape):
    cfg = _cfg(*SHAPES[shape])
    w = _weights(cfg, seed=2)
    model = vit.VisionTransformer(cfg, dtype="bfloat16",
                                  norm_dtype="bfloat16")
    model.load_state_dict(vit.load_siglip_vision_state_dict(w, cfg))
    images = _images(cfg, seed=4)
    x = (images.flip(-1).float() / 255.0 - 0.5) / 0.5
    with torch.inference_mode():
        got = model.eval()(x)
    assert got.dtype == torch.float32
    cos = torch.nn.functional.cosine_similarity(
        got, plain_siglip.embed(w, images, cfg.heads), dim=1)
    assert float(cos.min()) >= 0.999


def test_map_head_matches_multihead_attention():
    """The head is ``nn.MultiheadAttention`` on the probe, then
    ``h + mlp(layernorm(h))``, with the same weights (float32)."""
    cfg = _cfg(*SHAPES["crop_dh12"])
    w = _weights(cfg, seed=5)
    sd = vit.load_siglip_vision_state_dict(w, cfg)
    head = vit.MAPHead(cfg)
    head.load_state_dict({k[5:]: v for k, v in sd.items()
                          if k.startswith("head.")})
    h = "vision_model.head."
    mha = torch.nn.MultiheadAttention(cfg.width, cfg.heads, batch_first=True)
    mha.load_state_dict({
        "in_proj_weight": w[f"{h}attention.in_proj_weight"],
        "in_proj_bias": w[f"{h}attention.in_proj_bias"],
        "out_proj.weight": w[f"{h}attention.out_proj.weight"],
        "out_proj.bias": w[f"{h}attention.out_proj.bias"]})
    x = torch.randn((3, 50, cfg.width), generator=torch.Generator()
                    .manual_seed(6))
    with torch.inference_mode():
        got = head(x, torch.float32)
        a = mha(w[f"{h}probe"].expand(3, 1, cfg.width), x, x,
                need_weights=False)[0]
        z = torch.nn.functional.layer_norm(
            a, (cfg.width,), w[f"{h}layernorm.weight"],
            w[f"{h}layernorm.bias"], cfg.ln_eps)
        z = torch.nn.functional.linear(
            torch.nn.functional.gelu(torch.nn.functional.linear(
                z, w[f"{h}mlp.fc1.weight"], w[f"{h}mlp.fc1.bias"]),
                approximate="tanh"),
            w[f"{h}mlp.fc2.weight"], w[f"{h}mlp.fc2.bias"])
        want = (a + z)[:, 0]
    assert _rel(got, want) < 1e-5


def test_published_sizes_on_meta():
    """428,225,600 parameters, and 670,346,449,920 FLOPs an image (a
    multiply-add 2) counted on the port's tower and on the plain reference
    at the published widths."""
    cfg = vit.VIT_CONFIGS[NAME]
    with torch.device("meta"):
        model = vit.VisionTransformer(cfg)
        x = torch.empty(1, cfg.image_size, cfg.image_size, 3)
    w = _weights_meta(cfg)
    assert sum(p.numel() for p in model.parameters()) == 428_225_600
    assert sum(t.numel() for t in w.values()) == 428_225_600
    # under inference mode, as ``cli bench --embed-only`` counts
    with FlopCounterMode(display=False) as port, torch.inference_mode():
        out = model(x)
    with FlopCounterMode(display=False) as ref, torch.no_grad():
        plain_siglip.forward(w, x.permute(0, 3, 1, 2), cfg.heads)
    assert out.shape == (1, 1152)
    assert port.get_total_flops() == ref.get_total_flops() \
        == 670_346_449_920


def _weights_meta(cfg):
    """The HF names and shapes of the published tower, on the meta device
    (from the loader's own map, without building numbers)."""
    with torch.device("meta"):
        sd = vit.VisionTransformer(cfg).state_dict()
    out = {}
    for ours, theirs, third in vit._hf_pairs(cfg):
        shape = tuple(sd[ours].shape)
        if third is not None:
            shape = (3 * shape[0], *shape[1:])
        elif ours == "pos_embed":
            shape = shape[1:]
        out["vision_model." + theirs] = torch.empty(shape, device="meta")
    return out


def test_cpu_dispatch_above_128_tokens_is_the_twin(monkeypatch):
    def refuse(*_):
        raise AssertionError("the fused path on a CPU tensor")

    monkeypatch.setattr(at, "long_seq_attention", refuse)
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn((2, 200, 3, 24), generator=gen) for _ in range(3))
    assert torch.equal(at.attention(q, k, v),
                       at.short_seq_attention_plain(q, k, v))


class TestRegistry:
    def test_builds_through_create_embedder(self, tiny):
        emb = create_embedder(EmbedConfig(model=NAME, batch_size=4),
                              device="cpu")
        assert emb.spec.dim == tiny.width and emb.spec.input_size == 40
        assert emb.spec.mean == emb.spec.std == (0.5, 0.5, 0.5)
        assert emb.tag == f"{NAME}:logits:torch-randominit-0"
        out = emb.embed(_images(tiny).numpy())
        assert out.shape == (5, tiny.width) and np.isfinite(out).all()

    def test_default_batch(self):
        from imageclust_tpu_torch.models.registry import DEFAULT_BATCH

        assert DEFAULT_BATCH[NAME] == 128

    @pytest.mark.parametrize("ext", [".npz", ".pt", ".bin"])
    def test_loads_hf_checkpoint(self, tiny, tmp_path, ext):
        """``embed.onnx_path`` names an HF ``SiglipVisionModel`` file: the
        tower gives the plain reference's embeddings (float32)."""
        w = _weights(tiny, seed=8)
        w["text_model.embeddings.token_embedding.weight"] = torch.zeros(4, 4)
        path = str(tmp_path / f"siglip{ext}")
        if ext == ".npz":
            np.savez(path, **{k: t.numpy() for k, t in w.items()})
        else:
            torch.save(w, path)
        emb = create_embedder(EmbedConfig(
            model=NAME, onnx_path=path, dtype="float32",
            norm_dtype="float32", batch_size=8), device="cpu")
        assert emb.weights_loaded and "randominit" not in emb.tag
        images = _images(tiny, seed=9)
        got = torch.from_numpy(emb.embed(images.numpy()))
        assert _rel(got, plain_siglip.embed(w, images, tiny.heads)) < 1e-5

    def test_loader_lists_every_problem(self, tiny):
        w = _weights(tiny)
        h = "vision_model.head."
        del w[f"{h}probe"]
        w[f"{h}attention.in_proj_weight"] = torch.zeros(5, tiny.width)
        w["vision_model.encoder.layers.1.mlp.fc1.weight"] = torch.zeros(4, 4)
        with pytest.raises(ValueError) as err:
            vit.load_siglip_vision_state_dict(w, tiny)
        msg = str(err.value)
        assert msg.startswith("SigLIP vision state dict")
        assert "head.probe: missing" in msg
        assert "in_proj_weight: (5, 48) is not three (48, 48)" in msg
        assert "fc1.weight: (4, 4)" in msg
        with pytest.raises(ValueError, match="attention-pooling head"):
            vit.load_siglip_vision_state_dict(
                w, vit.VIT_CONFIGS["siglip_so400m"])

    def test_int8_tower_against_the_float_tower(self, tiny):
        emb = create_embedder(EmbedConfig(model=NAME, quantize="int8",
                                          batch_size=8), device="cpu")
        ref = create_embedder(EmbedConfig(model=NAME, dtype="float32",
                                          norm_dtype="float32",
                                          batch_size=8), device="cpu")
        assert isinstance(emb.model, QuantViT)
        assert emb.tag == f"{NAME}:logits:int8-absmax:torch-randominit-0"
        assert emb.model.block0.mlp_up.kernel_q.shape == (88, tiny.width)
        assert not hasattr(emb.model, "projection")
        images = _images(tiny, n=6, seed=10).numpy()
        got, want = emb.embed(images), ref.embed(images)
        cos = (got * want).sum(1) / (np.linalg.norm(got, axis=1)
                                     * np.linalg.norm(want, axis=1))
        assert got.shape == (6, tiny.width) and cos.min() > 0.995
        assert not np.allclose(got, want, rtol=1e-7, atol=1e-9)


def test_profiler_ranges():
    """Under a ``torch.profiler`` trace each block's attention is a
    ``vit/attention`` range and the head a ``vit/head`` range; without one
    no range opens."""
    import contextlib

    from torch.profiler import ProfilerActivity, profile

    from imageclust_tpu_torch.utils.metrics import traced

    cfg = _cfg(*SHAPES["crop_dh12"])
    model = vit.VisionTransformer(cfg).init_random(0).eval()
    x = torch.randn((2, cfg.image_size, cfg.image_size, 3))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.inference_mode():
            model(x)
    names = [e.name for e in prof.events()]
    assert names.count("vit/attention") == cfg.depth
    assert names.count("vit/head") == 1
    assert isinstance(traced("vit/head"), contextlib.nullcontext)
