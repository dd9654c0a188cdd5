"""The int8 products (ops/int8.py) and the int8 ResNet50 tower
(models/quantize.py) against the JAX package's (models/quantize.py).

* int32 accumulators: ``int8_mm`` and ``int8_conv2d`` equal XLA's
  ``dot_general`` / ``conv_general_dilated`` with
  ``preferred_element_type=int32`` exactly on the same int8 operands.
* The port's own calibration: ``kernel_q``, ``w_scale`` and ``bias`` equal
  JAX's bit for bit (both quantize the same BN-folded float32 kernels in
  float64); ``act_scale`` at rtol 1e-5 (the calibration forwards are two
  float32 convolution stacks, reduced in different orders).
* Whole towers with the JAX qparams carried across: per-row cosine of
  pooled features and logits >= 0.99999 with float32 activations and
  >= 0.999 with bf16 (bf16 rounds at other points, and a requantized
  element near a .5 boundary may land one step apart).
* The JAX package's own int8-vs-f32 gates (tests/test_quantize.py), on
  the port's towers.

The tower is JAX's test tower: every block, 64x64 inputs, 32 classes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.models.quantize import _conv as jax_conv
from imageclust_tpu.models.quantize import quant_apply
from imageclust_tpu.models.quantize import quantize_resnet50 as jax_quantize
from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu_torch.config import EmbedConfig
from imageclust_tpu_torch.models import create_embedder
from imageclust_tpu_torch.models.convert import (
    quant_resnet50_state_dict_from_jax,
    resnet50_state_dict_from_flax,
)
from imageclust_tpu_torch.models.quantize import (
    QuantResNet50,
    quantile,
    quantize_resnet50,
)
from imageclust_tpu_torch.models.resnet50 import ResNet50V1
from imageclust_tpu_torch.ops.int8 import int8_conv2d, int8_mm

torch.set_num_threads(1)

CLASSES = 32
COS_F32 = 0.99999
COS_BF16 = 0.999


def _cosine(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    num = (a * b).sum(axis=1)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return num / np.maximum(den, 1e-12)


@pytest.fixture(scope="module")
def tower():
    """JAX's test tower (tests/test_quantize.py): variables as numpy, the
    calibration and test batches, the JAX qparams for both statistics."""
    model = FlaxResNet(num_classes=CLASSES, dtype=jnp.float32,
                       norm_dtype=jnp.float32)
    rng = np.random.default_rng(0)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 3, 64, 64), jnp.float32)))
    calib = rng.random((4, 64, 64, 3), np.float32)
    test = rng.random((6, 64, 64, 3), np.float32)
    q = {m: jax.tree.map(np.asarray, jax_quantize(v, calib, calib_method=m))
         for m in ("absmax", "p999")}
    return v, calib, test, q


def _float_tower(v):
    m = ResNet50V1(num_classes=CLASSES, dtype="float32",
                   norm_dtype="float32")
    m.load_state_dict(resnet50_state_dict_from_flax(v))
    return m


def _port_q(q, act="float32"):
    m = QuantResNet50(CLASSES, act_dtype=act)
    m.load_state_dict(quant_resnet50_state_dict_from_jax(q))
    return m


def _run(m, x):
    with torch.inference_mode():
        logits, pooled = m(torch.from_numpy(np.ascontiguousarray(x)),
                           return_features=True)
    return logits.numpy(), pooled.numpy()


class TestInt8Products:
    @pytest.mark.parametrize("m,k,n", [(1, 8, 8), (5, 3, 7), (16, 64, 24),
                                       (17, 33, 9), (50, 768, 96)])
    def test_mm_equals_dot_general(self, m, k, n):
        rng = np.random.default_rng(m * k + n)
        a = rng.integers(-127, 128, (m, k)).astype(np.int8)
        b = rng.integers(-127, 128, (k, n)).astype(np.int8)
        want = np.asarray(jax.lax.dot_general(
            jnp.asarray(a), jnp.asarray(b), (((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32))
        got = int8_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the towers' layout: the transpose of a contiguous (n, k) weight
        got_t = int8_mm(torch.from_numpy(a),
                        torch.from_numpy(np.ascontiguousarray(b.T)).t())
        np.testing.assert_array_equal(got_t.numpy(), want)

    @pytest.mark.parametrize("k,stride,pad", [(1, 1, 0), (1, 2, 0),
                                              (3, 1, 1), (3, 2, 1),
                                              (3, 2, 0), (7, 2, 3)])
    @pytest.mark.parametrize("hw", [(9, 7), (8, 8)])
    def test_conv_equals_xla(self, k, stride, pad, hw):
        rng = np.random.default_rng(k * 10 + stride + pad)
        x = rng.integers(-127, 128, (2, *hw, 12)).astype(np.int8)
        w = rng.integers(-127, 128, (k, k, 12, 20)).astype(np.int8)
        want = np.asarray(jax_conv(jnp.asarray(x), jnp.asarray(w), stride,
                                   pad, out_dtype=jnp.int32))
        got = int8_conv2d(torch.from_numpy(x),
                          torch.from_numpy(w.transpose(3, 0, 1, 2).copy()),
                          stride, pad)
        assert got.dtype == torch.int32 and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)

    def test_rejects_float_operands(self):
        a = torch.zeros(4, 8)
        with pytest.raises(TypeError, match="int8"):
            int8_mm(a, a.t())


class TestQuantile:
    @pytest.mark.parametrize("n", [1, 2, 7, 1000, 262_145])
    def test_equals_numpy(self, n):
        x = np.abs(np.random.default_rng(n).standard_normal(n)).astype(
            np.float32)
        got = quantile(torch.from_numpy(x), 0.999)
        np.testing.assert_allclose(got, np.quantile(x, 0.999), rtol=1e-6)
        # XLA's CPU contracts the interpolation into an FMA: a last bit
        np.testing.assert_allclose(
            got, float(jnp.quantile(jnp.asarray(x), 0.999)), rtol=1e-6)

    def test_above_torch_quantile_limit(self):
        """A 32-image calibration sample's stage-1 activations hold more
        than 2^24 values, which torch.quantile refuses."""
        x = torch.from_numpy(np.random.default_rng(1).random(
            (1 << 24) + 5, dtype=np.float32))
        with pytest.raises(RuntimeError):
            torch.quantile(x, 0.999)
        np.testing.assert_allclose(quantile(x, 0.999),
                                   np.quantile(x.numpy(), 0.999), rtol=1e-6)


class TestCalibration:
    @pytest.mark.parametrize("method", ["absmax", "p999"])
    def test_qparams_equal_jax(self, tower, method):
        v, calib, _, q = tower
        mine = quantize_resnet50(_float_tower(v), calib,
                                 calib_method=method).state_dict()
        n = 0
        for blk, convs in q[method].items():
            if not blk.startswith("stage"):
                continue
            for conv, p in convs.items():
                k = f"{blk}.{conv}"
                assert mine[f"{k}.kernel_q"].dtype == torch.int8
                np.testing.assert_array_equal(
                    mine[f"{k}.kernel_q"].numpy(),
                    p["kernel_q"].transpose(3, 0, 1, 2))
                for leaf in ("w_scale", "bias"):
                    np.testing.assert_array_equal(
                        mine[f"{k}.{leaf}"].numpy(), p[leaf])
                np.testing.assert_allclose(
                    float(mine[f"{k}.act_scale"]), float(p["act_scale"]),
                    rtol=1e-5)
                n += 1
        assert n == 16 * 3 + 4  # 16 blocks x 3 convs + 4 projections
        want_sd = quant_resnet50_state_dict_from_jax(q[method])
        for key in ("conv0.weight", "conv0.bias", "dense0.weight",
                    "dense0.bias"):
            assert torch.equal(mine[key], want_sd[key])

    def test_unknown_method_rejected(self, tower):
        v, calib, _, _ = tower
        with pytest.raises(ValueError, match="calib_method"):
            quantize_resnet50(_float_tower(v), calib, calib_method="kl")


class TestTowerAgainstJax:
    @pytest.mark.parametrize("act,floor", [("float32", COS_F32),
                                           ("bfloat16", COS_BF16)])
    @pytest.mark.parametrize("layout", ["nhwc", "nchw", "uint8"])
    def test_matches_quant_apply(self, tower, act, floor, layout):
        _, _, test, q = tower
        x = test
        if layout == "nchw":
            x = test.transpose(0, 3, 1, 2)
        elif layout == "uint8":  # raw BGR through the s2d stem
            x = np.random.default_rng(3).integers(
                0, 256, (4, 64, 64, 3)).astype(np.uint8)
        dt = jnp.dtype(act)
        lj, pj = jax.jit(lambda q_, x_: quant_apply(q_, x_, act_dtype=dt))(
            q["absmax"], jnp.asarray(x))
        lp, pp = _run(_port_q(q["absmax"], act), x)
        assert lp.shape == (len(x), CLASSES) and pp.shape == (len(x), 2048)
        assert _cosine(pp, pj).min() >= floor
        assert _cosine(lp, lj).min() >= floor


class TestAgainstFloatTower:
    """The JAX package's structural gates (tests/test_quantize.py), on the
    port's int8 tower against the port's float32 tower."""

    def test_matches_f32_tower(self, tower):
        v, calib, test, _ = tower
        f32 = _float_tower(v)
        lq, pq = _run(quantize_resnet50(f32, calib), test)
        lf, pf = _run(f32, test)
        assert _cosine(pq, pf).min() > 0.995
        assert _cosine(lq, lf).min() > 0.99
        assert not np.allclose(pq, pf)  # it really quantizes

    def test_p999_calibration(self, tower):
        v, calib, test, _ = tower
        f32 = _float_tower(v)
        qp = quantize_resnet50(f32, calib, calib_method="p999")
        qa = quantize_resnet50(f32, calib, calib_method="absmax")
        assert _cosine(_run(qp, test)[1], _run(f32, test)[1]).min() > 0.99
        blk = "stage2_block0"
        assert float(getattr(qp, blk).conv1.act_scale) <= float(
            getattr(qa, blk).conv1.act_scale)

    def test_s2d_raw_stem_matches_normalized_path(self, tower):
        v, calib, _, _ = tower
        q = quantize_resnet50(_float_tower(v), calib, act_dtype="float32")
        u8 = np.random.default_rng(3).integers(
            0, 256, (4, 64, 64, 3)).astype(np.uint8)
        normed = u8.astype(np.float32)[..., ::-1] / 255.0
        np.testing.assert_allclose(_run(q, u8)[1], _run(q, normed)[1],
                                   rtol=2e-3, atol=2e-3)

    def test_nchw_input_accepted(self, tower):
        v, calib, test, _ = tower
        q = quantize_resnet50(_float_tower(v), calib)
        np.testing.assert_allclose(_run(q, test)[1],
                                   _run(q, test.transpose(0, 3, 1, 2))[1],
                                   rtol=1e-5, atol=1e-5)


class TestRegistry:
    @pytest.mark.parametrize("s2d", [True, False])
    def test_create_embedder_int8(self, s2d):
        emb = create_embedder(EmbedConfig(
            model="resnet50", quantize="int8", batch_size=4,
            output="pooled", onnx_path="", s2d_stem=s2d), device="cpu")
        assert isinstance(emb.model, QuantResNet50)
        assert emb.model.stem_mode == ("s2d_raw" if s2d else "standard")
        assert emb.tag == "resnet50:pooled:int8-absmax:torch-randominit-0"
        imgs = np.random.default_rng(1).integers(
            0, 255, (4, 224, 224, 3), np.uint8)
        out = emb.embed(imgs)
        assert out.shape == (4, 2048) and np.isfinite(out).all()

    def test_calibrates_after_variables_load(self, tower):
        """``variables=`` loads first, then the registry calibrates on
        its synthetic batch: the JAX package's qparams for the same weights
        and batch (``quantize_resnet50`` on ``_calib_batch``)."""
        from imageclust_tpu.models.registry import _calib_batch

        v, _, _, _ = tower
        emb = create_embedder(
            EmbedConfig(num_classes=CLASSES, quantize="int8",
                        calib_method="p999", batch_size=4, onnx_path=""),
            device="cpu", variables=v)
        calib = _calib_batch(224, False).astype(np.float32)[..., ::-1] / 255.0
        q = jax.tree.map(np.asarray,
                         jax_quantize(v, calib, calib_method="p999"))
        mine = emb.model.state_dict()
        want = quant_resnet50_state_dict_from_jax(q)
        for k, t in want.items():
            if k.endswith("act_scale"):
                np.testing.assert_allclose(float(mine[k]), float(t),
                                           rtol=1e-5)
            else:
                assert torch.equal(mine[k], t), k
        assert ":int8-p999:flax-" in emb.tag

    def test_unknown_mode_rejected(self):
        with pytest.raises(ValueError, match="quantize"):
            create_embedder(EmbedConfig(quantize="fp4"), device="cpu")
