"""The int8 ViT/SigLIP towers (models/quantize_vit.py) against the JAX
package's (models/quantize_vit.py), at JAX's test sizes (``SMALL`` and
``SMALL_SIGLIP`` of tests/test_quantize_vit.py).

* The port's own calibration: every encoder Dense's ``kernel_q``,
  ``w_scale`` and ``bias`` equal JAX's bit for bit, ``act_scale`` at rtol
  1e-5 (two float32 calibration forwards).
* With the JAX qparams carried across, the tower agrees with
  ``vit_quant_apply``: per-row cosine >= 0.99999 with float32 activations
  and >= 0.999 with bf16 (NHWC and NCHW inputs).
* The JAX package's own gates on the port's towers: int8 against float32
  > 0.995, int8 differs from float32, p999 below absmax.
* Attention goes through the towers' dispatch (K5 on the card, its twin
  here), once per encoder block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.models.quantize_vit import quantize_vit as jax_quantize
from imageclust_tpu.models.quantize_vit import vit_quant_apply
from imageclust_tpu.models.vit import ViTConfig as JaxViTConfig
from imageclust_tpu.models.vit import VisionTransformer as FlaxViT
from imageclust_tpu_torch.config import EmbedConfig
from imageclust_tpu_torch.models import create_embedder
from imageclust_tpu_torch.models import quantize_vit as qv
from imageclust_tpu_torch.models.convert import (
    quant_vit_state_dict_from_jax,
    vit_state_dict_from_flax,
)
from imageclust_tpu_torch.models.quantize_vit import QuantViT, quantize_vit
from imageclust_tpu_torch.models.vit import ViTConfig, VisionTransformer

torch.set_num_threads(1)

SMALL = dict(patch=8, width=64, depth=3, heads=2, proj_dim=16,
             image_size=32)
SMALL_SIGLIP = dict(patch=8, width=64, depth=2, heads=2, proj_dim=16,
                    image_size=32, use_class_token=False, quick_gelu=False,
                    mean=(0.5, 0.5, 0.5), std=(0.5, 0.5, 0.5))
COS_F32 = 0.99999
COS_BF16 = 0.999


def _cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = (a * b).sum(axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return num / np.maximum(den, 1e-12)


@pytest.fixture(scope="module", params=[SMALL, SMALL_SIGLIP],
                ids=["clip", "siglip"])
def tower(request):
    """(port config, JAX config, Flax variables as numpy, calibration and
    test batches, JAX qparams per statistic)."""
    jcfg = JaxViTConfig(**request.param)
    cfg = ViTConfig(**request.param)
    model = FlaxViT(jcfg, dtype=jnp.float32, norm_dtype=jnp.float32)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0),
        jnp.zeros((1, 3, cfg.image_size, cfg.image_size), jnp.float32)))
    rng = np.random.default_rng(0)
    s = cfg.image_size
    calib = rng.normal(size=(4, s, s, 3)).astype(np.float32)
    test = rng.normal(size=(6, s, s, 3)).astype(np.float32)
    q = {m: jax.tree.map(np.asarray,
                         jax_quantize(v, jcfg, calib, calib_method=m))
         for m in ("absmax", "p999")}
    return cfg, jcfg, v, calib, test, q


def _float_tower(cfg, v):
    m = VisionTransformer(cfg, dtype="float32", norm_dtype="float32")
    m.load_state_dict(vit_state_dict_from_flax(v, cfg))
    return m


def _run(m, x):
    with torch.inference_mode():
        return m(torch.from_numpy(np.ascontiguousarray(x))).numpy()


class TestCalibration:
    @pytest.mark.parametrize("method", ["absmax", "p999"])
    def test_qparams_equal_jax(self, tower, method):
        cfg, _, v, calib, _, q = tower
        mine = quantize_vit(_float_tower(cfg, v), calib,
                            calib_method=method).state_dict()
        for i in range(cfg.depth):
            for name in ("q", "k", "v", "proj", "mlp_up", "mlp_down"):
                p = q[method][f"block{i}"][name]
                k = f"block{i}.{name}"
                assert mine[f"{k}.kernel_q"].dtype == torch.int8
                np.testing.assert_array_equal(mine[f"{k}.kernel_q"].numpy(),
                                              p["kernel_q"].T)
                for leaf in ("w_scale", "bias"):
                    np.testing.assert_array_equal(
                        mine[f"{k}.{leaf}"].numpy(), p[leaf])
                np.testing.assert_allclose(
                    float(mine[f"{k}.act_scale"]), float(p["act_scale"]),
                    rtol=1e-5)
        want = quant_vit_state_dict_from_jax(q[method], cfg)
        assert mine.keys() == want.keys()
        for k, t in want.items():  # the float parts carried as they are
            if ".kernel_q" not in k and not k.endswith(
                    ("w_scale", "act_scale")) and ".bias" not in k:
                assert torch.equal(mine[k], t), k

    def test_unknown_method_rejected(self, tower):
        cfg, _, v, calib, _, _ = tower
        with pytest.raises(ValueError, match="calib_method"):
            quantize_vit(_float_tower(cfg, v), calib, calib_method="minmax")


class TestTowerAgainstJax:
    @pytest.mark.parametrize("act,floor", [("float32", COS_F32),
                                           ("bfloat16", COS_BF16)])
    @pytest.mark.parametrize("layout", ["nhwc", "nchw"])
    def test_matches_vit_quant_apply(self, tower, act, floor, layout):
        cfg, jcfg, _, _, test, q = tower
        x = test.transpose(0, 3, 1, 2) if layout == "nchw" else test
        want = np.asarray(vit_quant_apply(q["absmax"], jnp.asarray(x), jcfg,
                                          act_dtype=jnp.dtype(act)))
        m = QuantViT(cfg, act)
        m.load_state_dict(quant_vit_state_dict_from_jax(q["absmax"], cfg))
        got = _run(m, x)
        assert got.shape == (len(x), cfg.proj_dim)
        assert _cosine(got, want).min() >= floor


class TestAgainstFloatTower:
    def test_matches_f32_tower(self, tower):
        cfg, _, v, calib, test, _ = tower
        f32 = _float_tower(cfg, v)
        got = _run(quantize_vit(f32, calib, act_dtype="float32"), test)
        want = _run(f32, test)
        assert _cosine(got, want).min() > 0.995
        assert not np.allclose(got, want, rtol=1e-7, atol=1e-9)

    def test_p999_below_absmax(self, tower):
        cfg, _, v, calib, _, _ = tower
        f32 = _float_tower(cfg, v)
        qa = quantize_vit(f32, calib, calib_method="absmax")
        qp = quantize_vit(f32, calib, calib_method="p999")
        assert float(qp.block0.q.act_scale) < float(qa.block0.q.act_scale)
        # q, k and v read one LayerNorm output: one scale
        assert float(qa.block0.q.act_scale) == float(qa.block0.k.act_scale)

    def test_attention_through_the_dispatch(self, tower, monkeypatch):
        cfg, _, v, calib, test, _ = tower
        q = quantize_vit(_float_tower(cfg, v), calib)
        calls = []
        real = qv.attention

        def counting(a, b, c):
            calls.append(tuple(a.shape))
            return real(a, b, c)

        monkeypatch.setattr(qv, "attention", counting)
        _run(q, test)
        t = (cfg.image_size // cfg.patch) ** 2 + cfg.use_class_token
        hd = cfg.width // cfg.heads
        assert calls == [(len(test), t, cfg.heads, hd)] * cfg.depth


class TestRegistry:
    def test_create_embedder_vit_b32_int8(self):
        emb = create_embedder(EmbedConfig(
            model="vit_b32", quantize="int8", batch_size=4, onnx_path=""),
            device="cpu")
        assert isinstance(emb.model, QuantViT)
        assert emb.tag == "vit_b32:logits:int8-absmax:torch-randominit-0"
        imgs = np.random.default_rng(1).integers(
            0, 255, (4, 224, 224, 3), np.uint8)
        out = emb.embed(imgs)
        assert out.shape == (4, 512) and np.isfinite(out).all()

    def test_calibrates_after_variables_load(self, tower, monkeypatch):
        """``variables=`` loads first, then the registry calibrates on its
        synthetic batch, normalised with the tower's mean/std: the JAX
        package's qparams for the same weights and batch."""
        from imageclust_tpu.models.registry import _calib_batch
        from imageclust_tpu_torch.models import vit

        cfg, jcfg, v, _, _, _ = tower
        monkeypatch.setitem(vit.VIT_CONFIGS, "vit_b32", cfg)
        emb = create_embedder(EmbedConfig(model="vit_b32", quantize="int8",
                                          batch_size=4),
                              device="cpu", variables=v)
        calib = _calib_batch(cfg.image_size, False).astype(
            np.float32)[..., ::-1] / 255.0
        calib = ((calib - np.asarray(cfg.mean, np.float32))
                 / np.asarray(cfg.std, np.float32))
        want = quant_vit_state_dict_from_jax(
            jax.tree.map(np.asarray, jax_quantize(v, jcfg, calib)), cfg)
        mine = emb.model.state_dict()
        for k, t in want.items():
            if k.endswith("act_scale"):
                np.testing.assert_allclose(float(mine[k]), float(t),
                                           rtol=1e-5)
            else:
                assert torch.equal(mine[k], t), k
        assert ":int8-absmax:flax-" in emb.tag
