"""The port's ResNet50 against the JAX package's Flax tower, on the same
weights (Flax variables converted with models/convert.py).

float32: logits and pooled features allclose (rtol/atol 1e-4: the two
frameworks reduce the convolutions in different orders). bfloat16 compute
and norms: per-row cosine >= 0.99 (bf16 rounds at other points).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu.models.resnet50 import fold_bn_variables as flax_fold
from imageclust_tpu_torch.models.convert import resnet50_state_dict_from_flax
from imageclust_tpu_torch.models.resnet50 import ResNet50V1, fold_bn_variables

torch.set_num_threads(1)

_SMALL = (1, 1, 1, 1)


def _flax_variables(stage_layers, num_classes=10, seed=0):
    """Flax init with randomised BatchNorm statistics (the init's 0/1 stats
    would leave the normalisation untested)."""
    model = FlaxResNet(dtype=jnp.float32, stage_layers=stage_layers,
                       num_classes=num_classes)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, 32, 32))))
    rng = np.random.default_rng(seed)

    def stats(tree):
        if "mean" in tree:
            return {"mean": rng.uniform(-0.05, 0.05, tree["mean"].shape)
                    .astype(np.float32),
                    "var": rng.uniform(0.5, 1.5, tree["var"].shape)
                    .astype(np.float32)}
        return {k: stats(t) for k, t in tree.items()}

    def affine(tree):
        out = {}
        for k, t in tree.items():
            if isinstance(t, dict):
                out[k] = affine(t)
            elif k in ("scale", "bias") and t.ndim == 1:
                base = 1.0 if k == "scale" else 0.0
                out[k] = (base + rng.uniform(-0.1, 0.1, t.shape)).astype(
                    np.float32)
            else:
                out[k] = t
        return out

    return {"params": affine(v["params"]),
            "batch_stats": stats(v["batch_stats"])}


def _images(rng, b, size):
    u8 = rng.integers(0, 256, (b, size, size, 3)).astype(np.uint8)
    blob = (u8[..., ::-1].astype(np.float32) / 255.0).transpose(0, 3, 1, 2)
    return u8, np.ascontiguousarray(blob)


def _flax(v, x, dtype="float32", stem_mode="standard", stage_layers=_SMALL,
          fold=False):
    dt = jnp.dtype(dtype)
    model = FlaxResNet(dtype=dt, norm_dtype=dt, stage_layers=stage_layers,
                       num_classes=10, stem_mode=stem_mode, fold_bn=fold)
    logits, pooled = model.apply(v, jnp.asarray(x), return_features=True)
    return np.asarray(logits, np.float32), np.asarray(pooled, np.float32)


def _torch(v, x, dtype="float32", stem_mode="standard", stage_layers=_SMALL):
    model = ResNet50V1(num_classes=10, dtype=dtype, norm_dtype=dtype,
                       stage_layers=stage_layers, stem_mode=stem_mode,
                       fold_bn="batch_stats" not in v)
    model.load_state_dict(resnet50_state_dict_from_flax(v))
    with torch.inference_mode():
        logits, pooled = model(torch.from_numpy(x), return_features=True)
    return logits.float().numpy(), pooled.float().numpy()


def _cosine(a, b):
    return (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)


class TestFloat32Parity:
    @pytest.mark.parametrize("size", [32, 64])
    def test_standard_stem_allclose(self, rng, size):
        v = _flax_variables(_SMALL)
        _, blob = _images(rng, 3, size)
        for got, want in zip(_torch(v, blob), _flax(v, blob)):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("size", [32, 64])
    def test_s2d_stem_allclose(self, rng, size):
        v = _flax_variables(_SMALL)
        u8, _ = _images(rng, 2, size)
        for got, want in zip(_torch(v, u8, stem_mode="s2d_raw"),
                             _flax(v, u8, stem_mode="s2d_raw")):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_s2d_equals_standard_stem(self, rng):
        v = _flax_variables(_SMALL)
        u8, blob = _images(rng, 2, 64)
        for a, b in zip(_torch(v, u8, stem_mode="s2d_raw"), _torch(v, blob)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    def test_nhwc_float_input(self, rng):
        v = _flax_variables(_SMALL)
        _, blob = _images(rng, 2, 32)
        nhwc = np.ascontiguousarray(blob.transpose(0, 2, 3, 1))
        for a, b in zip(_torch(v, nhwc), _flax(v, nhwc)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)

    def test_folded_matches_unfolded(self, rng):
        v = _flax_variables(_SMALL)
        _, blob = _images(rng, 2, 64)
        folded = jax.tree.map(np.asarray, flax_fold(v))
        ref = _torch(v, blob)
        for a, b in zip(_torch(folded, blob), ref):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        for a, b in zip(_torch(folded, blob), _flax(folded, blob, fold=True)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        # the port's own fold of the same weights
        model = ResNet50V1(num_classes=10, dtype="float32",
                           stage_layers=_SMALL)
        model.load_state_dict(resnet50_state_dict_from_flax(v))
        with torch.inference_mode():
            got = fold_bn_variables(model)(torch.from_numpy(blob)).numpy()
        np.testing.assert_allclose(got, ref[0], rtol=1e-4, atol=1e-4)

    def test_full_depth(self, rng):
        v = _flax_variables((3, 4, 6, 3))
        _, blob = _images(rng, 2, 64)
        for got, want in zip(_torch(v, blob, stage_layers=(3, 4, 6, 3)),
                             _flax(v, blob, stage_layers=(3, 4, 6, 3))):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


class TestBFloat16:
    @pytest.mark.parametrize("stem_mode", ["standard", "s2d_raw"])
    def test_cosine(self, rng, stem_mode):
        v = _flax_variables(_SMALL)
        u8, blob = _images(rng, 4, 64)
        x = u8 if stem_mode == "s2d_raw" else blob
        got = _torch(v, x, dtype="bfloat16", stem_mode=stem_mode)
        want = _flax(v, x, dtype="bfloat16", stem_mode=stem_mode)
        for g, w in zip(got, want):
            assert _cosine(g, w).min() >= 0.99

    def test_output_dtypes(self, rng):
        model = ResNet50V1(num_classes=10, dtype="bfloat16",
                           norm_dtype="bfloat16", stage_layers=_SMALL)
        model.init_random(0)
        u8, _ = _images(rng, 2, 32)
        with torch.inference_mode():
            logits, pooled = model(torch.from_numpy(u8), return_features=True,
                                   stem_mode="s2d_raw")
        assert logits.dtype == pooled.dtype == torch.float32
        assert torch.isfinite(logits).all()


class TestConverter:
    def test_rejects_misshaped_tensor(self):
        v = _flax_variables(_SMALL)
        v["params"]["stage2_block0"]["conv1"]["kernel"] = np.zeros(
            (3, 3, 128, 7), np.float32)
        with pytest.raises(ValueError, match="stage2_block0.conv1.weight"):
            resnet50_state_dict_from_flax(v)

    def test_rejects_missing_and_extra(self):
        v = _flax_variables(_SMALL)
        del v["batch_stats"]["bn0"]
        v["params"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
        with pytest.raises(ValueError) as err:
            resnet50_state_dict_from_flax(v)
        assert "bn0.running_mean: missing" in str(err.value)
        assert "extra.weight: unexpected" in str(err.value)

    def test_layout_mapping(self):
        v = _flax_variables(_SMALL)
        sd = resnet50_state_dict_from_flax(v)
        k = v["params"]["conv0"]["kernel"]  # HWIO
        np.testing.assert_array_equal(sd["conv0.weight"].numpy(),
                                      k.transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(sd["dense0.weight"].numpy(),
                                      v["params"]["dense0"]["kernel"].T)
        np.testing.assert_array_equal(
            sd["bn0.running_var"].numpy(), v["batch_stats"]["bn0"]["var"])


class TestRandomInit:
    def test_seeded_and_lecun_scaled(self):
        a = ResNet50V1(num_classes=10, stage_layers=_SMALL).init_random(3)
        b = ResNet50V1(num_classes=10, stage_layers=_SMALL).init_random(3)
        c = ResNet50V1(num_classes=10, stage_layers=_SMALL).init_random(4)
        assert torch.equal(a.conv0.weight, b.conv0.weight)
        assert not torch.equal(a.conv0.weight, c.conv0.weight)
        w = a.stage3_block0.conv1.weight.detach()
        fan_in = w[0].numel()
        assert abs(float(w.std()) - fan_in ** -0.5) < 0.1 * fan_in ** -0.5
        assert float(w.abs().max()) <= 2 * fan_in ** -0.5 / 0.8796 + 1e-6


class TestEmbedBlob:
    """``Embedder.embed_blob`` on a preprocessed (N, 3, S, S) blob against
    the JAX ``Embedder.embed_blob`` on the same Flax variables (small
    stages): f32 allclose at 1e-4, bf16 per-row cosine >= 0.99."""

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("pooled", [False, True])
    def test_matches_jax(self, rng, dtype, pooled):
        from imageclust_tpu.models.registry import Embedder as JaxEmbedder
        from imageclust_tpu.models.registry import EmbedderSpec as JaxSpec
        from imageclust_tpu_torch.models.registry import (
            Embedder,
            EmbedderSpec,
        )

        v = _flax_variables(_SMALL)
        dt = jnp.dtype(dtype)
        flax_model = FlaxResNet(dtype=dt, norm_dtype=dt, stage_layers=_SMALL,
                                num_classes=10)

        def apply_fn(variables, x):
            logits, feats = flax_model.apply(variables, x,
                                             return_features=True)
            return feats if pooled else logits

        spec = dict(name="resnet50", input_size=64,
                    dim=2048 if pooled else 10, scale=1 / 255.0,
                    mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0),
                    bgr_input=True)
        jax_emb = JaxEmbedder(JaxSpec(**spec), apply_fn, v, batch_size=8)
        port_emb = Embedder(
            EmbedderSpec(**spec),
            ResNet50V1(num_classes=10, dtype=dtype, norm_dtype=dtype,
                       stage_layers=_SMALL),
            batch_size=8, device=torch.device("cpu"), pooled=pooled)
        port_emb.load_flax_variables(v)
        _, blob = _images(rng, 5, 64)
        got = port_emb.embed_blob(blob)
        want = np.asarray(jax_emb.embed_blob(blob), np.float32)
        assert got.dtype == np.float32 and got.shape == want.shape
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        else:
            assert _cosine(got, want).min() >= 0.99
