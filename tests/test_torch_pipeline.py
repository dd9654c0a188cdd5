"""The port's Pipeline (device="cpu") against the JAX Pipeline on the same
images and the same tower weights, plus the port's ingest without cv2/PIL.

Both pipelines run a float32 ResNet50 (s2d stem, one block per stage to
keep the CPU run short) whose Flax variables are converted into the port,
with the fake labeler and namer; the clusters (keys, member lists in order)
and the dropped list must be identical.
"""

import json
import os
import sys

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.config import AppConfig as JaxAppConfig
from imageclust_tpu.config import LabelConfig as JaxLabelConfig
from imageclust_tpu.config import NamingConfig as JaxNamingConfig
from imageclust_tpu.models.registry import Embedder as JaxEmbedder
from imageclust_tpu.models.registry import EmbedderSpec as JaxSpec
from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu.pipeline import Pipeline as JaxPipeline
from imageclust_tpu.types import UploadedImage as JaxUpload
from imageclust_tpu_torch import cli
from imageclust_tpu_torch.cluster import ConstraintError
from imageclust_tpu_torch.config import (
    AppConfig,
    ClusterConfig,
    EmbedConfig,
    LabelConfig,
    NamingConfig,
)
from imageclust_tpu_torch.data import loader
from imageclust_tpu_torch.models.registry import (
    Embedder,
    EmbedderSpec,
    create_embedder,
)
from imageclust_tpu_torch.models.resnet50 import ResNet50V1
from imageclust_tpu_torch.pipeline import Pipeline
from imageclust_tpu_torch.types import UploadedImage

from helpers import color_group_images

torch.set_num_threads(2)

_LAYERS = (1, 1, 1, 1)
_DIM = 64


@pytest.fixture(scope="module")
def towers():
    """(JAX embedder, port embedder) on the same float32 weights."""
    flax_model = FlaxResNet(dtype=jnp.float32, norm_dtype=jnp.float32,
                            stage_layers=_LAYERS, num_classes=_DIM)
    raw_model = FlaxResNet(dtype=jnp.float32, norm_dtype=jnp.float32,
                           stage_layers=_LAYERS, num_classes=_DIM,
                           stem_mode="s2d_raw")
    variables = flax_model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 3, 224, 224)))
    spec = dict(name="resnet50", input_size=224, dim=_DIM, scale=1 / 255.0,
                mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), bgr_input=True)
    jax_emb = JaxEmbedder(
        JaxSpec(**spec), lambda v, x: flax_model.apply(v, x), variables,
        batch_size=16, tag="jax-test",
        raw_apply_fn=lambda v, u8: raw_model.apply(v, u8))
    port_emb = Embedder(
        EmbedderSpec(**spec),
        ResNet50V1(num_classes=_DIM, dtype="float32", norm_dtype="float32",
                   stage_layers=_LAYERS, stem_mode="s2d_raw"),
        batch_size=16, device=torch.device("cpu"), tag="torch-test")
    port_emb.load_flax_variables(jax.tree.map(np.asarray, variables))
    return jax_emb, port_emb


def _configs(**cluster):
    return (
        JaxAppConfig(labels=JaxLabelConfig(backend="fake"),
                     naming=JaxNamingConfig(services=("fake",), retries=1)),
        AppConfig(labels=LabelConfig(backend="fake"),
                  naming=NamingConfig(services=("fake",), retries=1),
                  cluster=ClusterConfig(**cluster)),
    )


def _result_view(result):
    return ({k: (v.images, v.labels, v.title) for k, v in
             result.clusters.items()}, result.dropped)


class TestParityWithJax:
    @pytest.mark.parametrize("groups,per", [(3, 4), (4, 5)])
    def test_run_identical_clusters(self, towers, rng, tmp_path, groups, per):
        jax_emb, port_emb = towers
        names, blobs = color_group_images(rng, n_groups=groups,
                                          per_group=per)
        jcfg, pcfg = _configs()
        want = JaxPipeline(jcfg, embedder=jax_emb).run(
            [JaxUpload(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run(
            [UploadedImage(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "port"), min_size=3, max_size=6)
        assert _result_view(got) == _result_view(want)
        assert set(got.to_dict()) == set(want.to_dict())
        assert os.path.exists(got.html_path)
        assert got.metrics.counters["images"] == len(names)

    def test_run_paths_identical_clusters(self, towers, rng, tmp_path):
        jax_emb, port_emb = towers
        names, blobs = color_group_images(rng, n_groups=3, per_group=4)
        paths = []
        for n, b in zip(names, blobs):
            (tmp_path / n).write_bytes(b)
            paths.append(str(tmp_path / n))
        jcfg, pcfg = _configs()
        want = JaxPipeline(jcfg, embedder=jax_emb).run_paths(
            paths, str(tmp_path / "jax"))
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run_paths(
            paths, str(tmp_path / "port"))
        assert _result_view(got) == _result_view(want)

    def test_embeddings_close(self, towers, rng):
        jax_emb, port_emb = towers
        u8 = rng.integers(0, 256, (5, 224, 224, 3)).astype(np.uint8)
        np.testing.assert_allclose(port_emb.embed(u8), jax_emb.embed(u8),
                                   rtol=1e-4, atol=1e-4)
        # the resize path (not at the input size) takes the device resize
        small = rng.integers(0, 256, (3, 40, 56, 3)).astype(np.uint8)
        np.testing.assert_allclose(port_emb.embed(small),
                                   jax_emb.embed(small), rtol=1e-4, atol=1e-4)


class TestErrors:
    @pytest.fixture()
    def pipeline(self, towers):
        return Pipeline(_configs()[1], device="cpu", embedder=towers[1])

    def test_no_images_raises(self, pipeline, tmp_path):
        with pytest.raises(ValueError, match="no images"):
            pipeline.run([], str(tmp_path))
        with pytest.raises(ValueError, match="no images"):
            pipeline.run_paths([], str(tmp_path))

    def test_invalid_bounds_raise(self, pipeline, rng, tmp_path):
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)
        uploads = [UploadedImage(n, b) for n, b in zip(names, blobs)]
        with pytest.raises(ValueError, match="invalid cluster size"):
            pipeline.run(uploads, str(tmp_path), min_size=5, max_size=2)

    def test_infeasible_constraints_raise(self, pipeline, rng, tmp_path):
        names, blobs = color_group_images(rng, n_groups=1, per_group=2)
        uploads = [UploadedImage(n, b) for n, b in zip(names, blobs)]
        with pytest.raises(ConstraintError):
            pipeline.run(uploads, str(tmp_path), min_size=3, max_size=6)

    def test_corrupt_image_fails_run(self, pipeline, rng, tmp_path):
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)
        uploads = [UploadedImage(n, b) for n, b in zip(names, blobs)]
        uploads.append(UploadedImage("bad.png", b"not an image"))
        with pytest.raises(loader.DecodeError):
            pipeline.run(uploads, str(tmp_path), min_size=3, max_size=6)

    def test_scale_path_not_ported(self, towers, rng, tmp_path):
        pcfg = _configs(exact_limit=4)[1]
        pipeline = Pipeline(pcfg, device="cpu", embedder=towers[1])
        names, blobs = color_group_images(rng, n_groups=1, per_group=5)
        with pytest.raises(NotImplementedError, match="exact_limit"):
            pipeline.run([UploadedImage(n, b) for n, b in zip(names, blobs)],
                         str(tmp_path))

    @pytest.mark.parametrize("fusion,exc", [("text", NotImplementedError),
                                            ("typo", ValueError)])
    def test_fusion_modes(self, towers, rng, tmp_path, fusion, exc):
        cfg = _configs()[1]
        cfg = cfg.replace(labels=LabelConfig(backend="fake", fusion=fusion))
        pipeline = Pipeline(cfg, device="cpu", embedder=towers[1])
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)
        with pytest.raises(exc):
            pipeline.run([UploadedImage(n, b) for n, b in zip(names, blobs)],
                         str(tmp_path))

    def test_default_device_needs_cuda(self, towers, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            Pipeline(_configs()[1], embedder=towers[1])
        with pytest.raises(RuntimeError, match="CUDA"):
            create_embedder(EmbedConfig())

    @pytest.mark.parametrize("cfg,exc", [
        (EmbedConfig(model="vit_b32"), NotImplementedError),
        (EmbedConfig(quantize="int8"), NotImplementedError),
        (EmbedConfig(model="nope"), ValueError),
        (EmbedConfig(quantize="fp4"), ValueError)])
    def test_unported_towers_raise(self, cfg, exc):
        with pytest.raises(exc):
            create_embedder(cfg, device="cpu")

    @pytest.mark.parametrize("backend", ["rekognition", "zero_shot"])
    def test_unported_labelers_raise(self, towers, backend):
        from imageclust_tpu_torch.labels import create_labeler

        with pytest.raises(NotImplementedError, match="not ported"):
            create_labeler(LabelConfig(backend=backend))

    def test_unported_namers_raise(self):
        from imageclust_tpu_torch.naming import create_naming_service

        with pytest.raises(NotImplementedError, match="not ported"):
            create_naming_service(NamingConfig(services=("claude_haiku",)))


class TestEmbedder:
    def test_random_init_tag_differs_from_jax(self):
        from imageclust_tpu.models.registry import _weights_tag as jax_tag
        from imageclust_tpu_torch.models.registry import _weights_tag

        cfg = EmbedConfig(onnx_path="")
        assert _weights_tag(cfg, 0) != jax_tag(cfg, 0)
        assert "torch-randominit-0" in _weights_tag(cfg, 0)

    def test_pow2_padding_and_batching(self, towers, rng):
        _, emb = towers
        u8 = rng.integers(0, 256, (21, 224, 224, 3)).astype(np.uint8)
        full = emb.embed(u8)
        assert full.shape == (21, _DIM) and full.dtype == np.float32
        np.testing.assert_allclose(emb.embed(u8[:5]), full[:5], rtol=1e-5,
                                   atol=1e-5)
        dev = emb.embed_device(u8[:3])
        assert isinstance(dev, torch.Tensor) and dev.shape == (3, _DIM)


def _bmp_top_down(img):
    ok, enc = cv2.imencode(".bmp", img)
    data = bytearray(enc.tobytes())
    h = img.shape[0]
    data[22:26] = (-h).to_bytes(4, "little", signed=True)
    off = int.from_bytes(data[10:14], "little")
    stride = (img.shape[1] * 3 + 3) & ~3
    rows = [bytes(data[off + r * stride: off + (r + 1) * stride])
            for r in range(h)]
    data[off:off + h * stride] = b"".join(reversed(rows))
    return bytes(data)


class TestNumpyDecoder:
    @pytest.mark.parametrize("ext", [".bmp", ".ppm"])
    @pytest.mark.parametrize("h,w", [(1, 1), (3, 5), (31, 17), (224, 224)])
    def test_matches_cv2(self, rng, ext, h, w):
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        ok, enc = cv2.imencode(ext, img)
        data = enc.tobytes()
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(loader.numpy_decode_bgr(data), want)

    def test_top_down_bmp(self, rng):
        img = rng.integers(0, 256, (6, 7, 3)).astype(np.uint8)
        data = _bmp_top_down(img)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(loader.numpy_decode_bgr(data), want)
        np.testing.assert_array_equal(want, img)

    def test_ppm_with_comment(self, rng):
        img = rng.integers(0, 256, (4, 3, 3)).astype(np.uint8)
        data = b"P6\n# made by a test\n3 4\n255\n" + img[:, :, ::-1].tobytes()
        np.testing.assert_array_equal(loader.numpy_decode_bgr(data), img)

    @pytest.mark.parametrize("data", [
        b"", b"not an image", b"BM" + b"\0" * 60, b"P6\n3 4\n65535\n",
        b"P6\n3 4\n255\n\0\0"])
    def test_rejects_other_or_malformed(self, data):
        assert loader.numpy_decode_bgr(data) is None

    def test_png_is_not_numpy_decodable(self, rng):
        img = rng.integers(0, 256, (4, 4, 3)).astype(np.uint8)
        ok, enc = cv2.imencode(".png", img)
        assert loader.numpy_decode_bgr(enc.tobytes()) is None


class TestDecodeWithoutCv2OrPil:
    @pytest.fixture(autouse=True)
    def _no_codecs(self, monkeypatch):
        monkeypatch.setitem(sys.modules, "cv2", None)
        monkeypatch.setitem(sys.modules, "PIL", None)

    def test_bmp_at_size(self, rng):
        img = rng.integers(0, 256, (224, 224, 3)).astype(np.uint8)
        ok, enc = cv2.imencode(".bmp", img)
        out = loader.decode_images([enc.tobytes()] * 2, size=224, workers=1)
        np.testing.assert_array_equal(out[1], img)

    def test_resize_through_native_library(self, rng, monkeypatch):
        from imageclust_tpu_torch.data import native

        if not native.available():
            pytest.fail("native/libicnative.so is built by tests/conftest.py")
        img = rng.integers(0, 256, (256, 300, 3)).astype(np.uint8)
        ok, enc = cv2.imencode(".ppm", img)
        got = loader.decode_images([enc.tobytes()], size=224, workers=1)[0]
        want = cv2.resize(img, (224, 224), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_array_equal(got, want)

    def test_resize_without_native_library_raises(self, rng, monkeypatch):
        from imageclust_tpu_torch.data import native

        monkeypatch.setattr(native, "_load", lambda: None)
        img = rng.integers(0, 256, (100, 100, 3)).astype(np.uint8)
        ok, enc = cv2.imencode(".bmp", img)
        with pytest.raises(loader.DecodeError, match="resize"):
            loader.decode_images([enc.tobytes()], size=224, workers=1)

    def test_other_formats_raise(self, rng):
        img = rng.integers(0, 256, (8, 8, 3)).astype(np.uint8)
        ok, enc = cv2.imencode(".png", img)
        with pytest.raises(loader.DecodeError):
            loader.decode_images([enc.tobytes()], size=224, workers=1)


class TestCli:
    def test_run_prints_result_json(self, rng, tmp_path, capsys):
        names, blobs = color_group_images(rng, n_groups=3, per_group=3,
                                          size=16)
        for n, b in zip(names, blobs):
            img = cv2.imdecode(np.frombuffer(b, np.uint8), cv2.IMREAD_COLOR)
            ok, enc = cv2.imencode(".bmp", img)
            (tmp_path / n.replace(".png", ".bmp")).write_bytes(enc.tobytes())
        rc = cli.main(["run", "--images", str(tmp_path), "--device", "cpu",
                       "--out", str(tmp_path / "work"),
                       "--set", "embed.dtype=float32",
                       "--set", "embed.norm_dtype=float32",
                       "--set", "embed.batch_size=8", "--labeler", "fake"])
        assert rc == 0
        out = json.loads(capsys.readouterr().out)
        placed = [m for c in out["clusters"].values() for m in c["images"]]
        assert sorted(placed + out["dropped"]) == sorted(
            n.replace(".png", ".bmp") for n in names)
        assert out["metrics"]["counters"]["merges"] == 9 - 2

    def test_run_rejects_missing_dir(self, tmp_path):
        assert cli.main(["run", "--images", str(tmp_path / "nope"),
                         "--device", "cpu"]) == 2

    def test_default_device_is_cuda(self):
        args = cli.build_parser().parse_args(["serve"])
        assert args.device == "cuda"
