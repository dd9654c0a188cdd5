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
from imageclust_tpu.config import ClusterConfig as JaxClusterConfig
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
        """Above exact_limit with ``scale_engine="chain"`` (the name is from
        before the chain engine was ported, when this refused): ``run``
        gives the JAX pipeline's clusters, labels and titles."""
        jax_emb, port_emb = towers
        names, blobs = color_group_images(rng, n_groups=4, per_group=5)
        jcfg = JaxAppConfig(
            labels=JaxLabelConfig(backend="fake"),
            naming=JaxNamingConfig(services=("fake",), retries=1),
            cluster=JaxClusterConfig(exact_limit=4, scale_engine="chain"))
        pcfg = _configs(exact_limit=4, scale_engine="chain")[1]
        want = JaxPipeline(jcfg, embedder=jax_emb).run(
            [JaxUpload(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run(
            [UploadedImage(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "port"), min_size=3, max_size=6)
        assert _result_view(got) == _result_view(want)
        assert got.metrics.counters["merges"] > 0

    @pytest.mark.parametrize("feature_dtype", ["bfloat16", "int8"])
    def test_scale_path_runs_at_residency(self, towers, rng, tmp_path,
                                          feature_dtype):
        """bf16/int8 residency above exact_limit (refused before it was
        ported): the upload streams into the residency dtype, the fake
        labels fuse onto it, no image is lost and sizes stay in bounds."""
        pcfg = _configs(exact_limit=4, bucket_size=8,
                        feature_dtype=feature_dtype)[1]
        pipeline = Pipeline(pcfg, device="cpu", embedder=towers[1])
        names, blobs = color_group_images(rng, n_groups=4, per_group=5)
        res = pipeline.run([UploadedImage(n, b) for n, b in zip(names, blobs)],
                           str(tmp_path))
        placed = [m for d in res.clusters.values() for m in d.images]
        assert sorted(placed + res.dropped) == sorted(names)
        assert all(3 <= len(d.images) <= 6 for d in res.clusters.values())

    def test_scale_path_runs(self, towers, rng, tmp_path):
        """A job above exact_limit takes the streamed big-job branch and
        the bucketed engine, and loses no image."""
        pcfg = _configs(exact_limit=4, bucket_size=8)[1]
        pipeline = Pipeline(pcfg, device="cpu", embedder=towers[1])
        names, blobs = color_group_images(rng, n_groups=4, per_group=5)
        res = pipeline.run([UploadedImage(n, b) for n, b in zip(names, blobs)],
                           str(tmp_path))
        placed = [m for d in res.clusters.values() for m in d.images]
        assert sorted(placed + res.dropped) == sorted(names)
        assert all(3 <= len(d.images) <= 6 for d in res.clusters.values())
        assert "decode" not in res.metrics.stages  # streamed ingest

    @pytest.mark.parametrize("fusion", ["text", "typo"])
    def test_fusion_modes(self, towers, rng, tmp_path, fusion):
        """``labels.fusion="text"`` runs (the text tower's dense block of
        the fake labels); an unknown mode raises before any work."""
        cfg = _configs()[1]
        cfg = cfg.replace(labels=LabelConfig(backend="fake", fusion=fusion))
        pipeline = Pipeline(cfg, device="cpu", embedder=towers[1])
        names, blobs = color_group_images(rng, n_groups=1, per_group=3)
        uploads = [UploadedImage(n, b) for n, b in zip(names, blobs)]
        if fusion == "typo":
            with pytest.raises(ValueError, match="labels.fusion"):
                pipeline.run(uploads, str(tmp_path))
            return
        res = pipeline.run(uploads, str(tmp_path))
        assert sorted(m for d in res.clusters.values()
                      for m in d.images) == sorted(names)
        assert pipeline._text_encoder.cfg.proj_dim == 512

    def test_default_device_needs_cuda(self, towers, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            Pipeline(_configs()[1], embedder=towers[1])
        with pytest.raises(RuntimeError, match="CUDA"):
            create_embedder(EmbedConfig())

    @pytest.mark.parametrize("cfg,exc", [
        (EmbedConfig(model="vit_b32", quantize="int8",
                     checkpoint_path="ckpt"), None),
        (EmbedConfig(quantize="int8", checkpoint_path="ckpt"), None),
        (EmbedConfig(model="nope"), ValueError),
        (EmbedConfig(quantize="fp4"), ValueError)])
    def test_unported_towers_raise(self, cfg, exc, tmp_path, monkeypatch):
        """Unknown towers and modes raise. An int8 tower with an Orbax
        ``checkpoint_path`` builds (small towers patched into the
        registry): a ResNet50 restores the checkpoint, which a tuned head
        of 16 classes shows, and calibrates on it; a ViT loads no weights
        from it, as in the JAX package."""
        if exc is not None:
            with pytest.raises(exc):
                create_embedder(cfg, device="cpu")
            return
        import dataclasses

        from imageclust_tpu_torch.models import registry, vit
        from imageclust_tpu_torch.models.convert import (
            resnet50_flax_from_state_dict,
        )
        from imageclust_tpu_torch.utils.checkpoint import save_variables

        class Small(ResNet50V1):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, stage_layers=_LAYERS, **kwargs)

        monkeypatch.setattr(registry, "ResNet50V1", Small)
        c = vit.VIT_CONFIGS["vit_b32"]
        monkeypatch.setitem(vit.VIT_CONFIGS, "vit_b32", vit.ViTConfig(
            **dict(c.__dict__, width=32, depth=2, heads=4,
                   image_size=c.patch * 4)))
        tuned = Small(num_classes=16).init_random(5)
        ck = str(tmp_path / cfg.checkpoint_path)
        save_variables(ck, resnet50_flax_from_state_dict(tuned))
        emb = create_embedder(dataclasses.replace(
            cfg, checkpoint_path=ck, num_classes=16), device="cpu")
        assert ":int8-" in emb.tag and ":torch-ckpt-" in emb.tag
        assert emb.weights_loaded == (cfg.model == "resnet50")
        if cfg.model == "resnet50":
            assert torch.equal(emb.model.dense0.weight,
                               tuned.dense0.weight)
        u8 = np.random.default_rng(0).integers(
            0, 256, (3, emb.spec.input_size, emb.spec.input_size, 3),
            np.uint8)
        out = emb.embed(u8)
        assert out.shape == (3, emb.spec.dim) and np.isfinite(out).all()

    @pytest.mark.parametrize("backend", ["rekognition"])
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

    @pytest.mark.parametrize("stream", [False, True])
    def test_run_lists_the_jax_clis_files(self, tmp_path, monkeypatch,
                                          stream):
        """``cli run`` takes the files the JAX CLI takes: PPMs (which the
        port's loader can decode) are not among them."""
        import imageclust_tpu.pipeline as jax_pipeline
        from imageclust_tpu import cli as jax_cli
        from imageclust_tpu_torch import pipeline as port_pipeline

        for name in ("a.bmp", "b.ppm", "c.PNG", "d.jpg", "e.txt", "f.webp",
                     "g.PPM", "h.jpeg", "i.gif"):
            (tmp_path / name).write_bytes(b"x")
        seen = []

        class Stop(Exception):
            pass

        class Recorder:
            def __init__(self, *args, **kwargs):
                pass

            def run(self, uploads, *args, **kwargs):
                seen.append(sorted(u.filename for u in uploads))
                raise Stop

            def run_paths(self, paths, *args, **kwargs):
                seen.append(sorted(os.path.basename(p) for p in paths))
                raise Stop

        monkeypatch.setenv("IMAGECLUST_JAX_CACHE", "off")
        monkeypatch.setattr(jax_pipeline, "Pipeline", Recorder)
        monkeypatch.setattr(port_pipeline, "Pipeline", Recorder)
        args = ["run", "--images", str(tmp_path), "--out",
                str(tmp_path / "work")] + (["--stream"] if stream else [])
        for main, extra in ((jax_cli.main, []),
                            (cli.main, ["--device", "cpu"])):
            with pytest.raises(Stop):
                main(args + extra)
        assert seen[0] == seen[1] == ["a.bmp", "c.PNG", "d.jpg", "f.webp",
                                      "h.jpeg", "i.gif"]

    def test_run_rejects_missing_dir(self, tmp_path):
        assert cli.main(["run", "--images", str(tmp_path / "nope"),
                         "--device", "cpu"]) == 2

    def test_default_device_is_cuda(self):
        args = cli.build_parser().parse_args(["serve"])
        assert args.device == "cuda"


# -- zero-shot labels and text fusion (the text side) ------------------------

_BANK_NAMES = ("c0", "c1", "c2", "c3")


def _hf_text_checkpoint(path, proj_dim=16, width=32, vocab=200, seed=7):
    """A seeded HF CLIPTextModel(+projection) state dict in an .npz, for
    the fusion tower of both packages (inferred heads: width // 64 -> 1)."""
    rng = np.random.default_rng(seed)
    pre = "text_model."

    def normal(*shape, s=0.05):
        return rng.normal(0, s, shape).astype(np.float32)

    sd = {pre + "embeddings.token_embedding.weight": normal(vocab, width),
          pre + "embeddings.position_embedding.weight": normal(77, width)}
    hf = f"{pre}encoder.layers.0"
    for name in ("layer_norm1", "layer_norm2"):
        sd[f"{hf}.{name}.weight"] = 1 + normal(width)
        sd[f"{hf}.{name}.bias"] = normal(width)
    for name, (o, n) in (("self_attn.q_proj", (width, width)),
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


@pytest.fixture(scope="module")
def vit_towers():
    """(JAX embedder, port embedder): a tiny float32 CLIP-style ViT at the
    colour images' own size (64 px), on the same weights."""
    from imageclust_tpu.models import vit as jax_vit
    from imageclust_tpu_torch.models import vit
    from imageclust_tpu_torch.models.convert import vit_state_dict_from_flax

    kw = dict(patch=16, width=32, depth=2, heads=4, proj_dim=16,
              image_size=64)
    model = jax_vit.VisionTransformer(jax_vit.ViTConfig(**kw),
                                      dtype=jnp.float32,
                                      norm_dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 3, 64, 64), jnp.float32)))
    cfg = vit.ViTConfig(**kw)
    spec = dict(name="vit_b32", input_size=64, dim=16, scale=1 / 255.0,
                mean=cfg.mean, std=cfg.std, bgr_input=True)
    jax_emb = JaxEmbedder(JaxSpec(**spec), lambda v, x: model.apply(v, x),
                          variables, batch_size=8, tag="jax-vit")
    tower = vit.VisionTransformer(cfg, dtype="float32", norm_dtype="float32")
    tower.load_state_dict(vit_state_dict_from_flax(variables, cfg))
    port_emb = Embedder(EmbedderSpec(**spec), tower, batch_size=8,
                        device=torch.device("cpu"), tag="torch-vit")
    return jax_emb, port_emb


@pytest.fixture(scope="module")
def text_side(vit_towers, tmp_path_factory):
    """(bank .npz, text checkpoint .npz): the bank's prototypes are the JAX
    tower's mean embeddings of four of the colour groups."""
    jax_emb, _ = vit_towers
    root = tmp_path_factory.mktemp("text_side")
    names, blobs = color_group_images(np.random.default_rng(99), n_groups=4,
                                      per_group=3)
    imgs = np.stack([cv2.imdecode(np.frombuffer(b, np.uint8),
                                  cv2.IMREAD_COLOR) for b in blobs])
    emb = jax_emb.embed(imgs).reshape(4, 3, -1).mean(axis=1)
    bank = str(root / "bank.npz")
    np.savez(bank, names=np.array(_BANK_NAMES), vectors=emb)
    return bank, _hf_text_checkpoint(root / "text.npz")


@pytest.fixture()
def jax_kmeans_init(monkeypatch):
    """Seed the port's k-means with the JAX package's random rows."""
    from imageclust_tpu_torch.cluster import sharded

    def init(x, k, seed):
        idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                x.shape[0])[:k])
        return x[torch.from_numpy(idx.copy()).to(x.device)].float()

    monkeypatch.setattr(sharded, "_kmeans_init", init)


def _zero_shot_configs(text_side, fusion, weight=1.0, **cluster):
    from imageclust_tpu.config import ClusterConfig as JaxClusterConfig

    labels = dict(backend="zero_shot", fusion=fusion, fusion_weight=weight,
                  text_checkpoint_path=text_side[1])
    naming = dict(services=("fake",), retries=1)
    return (JaxAppConfig(labels=JaxLabelConfig(**labels),
                         naming=JaxNamingConfig(**naming),
                         cluster=JaxClusterConfig(**cluster)),
            AppConfig(labels=LabelConfig(**labels),
                      naming=NamingConfig(**naming),
                      cluster=ClusterConfig(**cluster)))


def _labelled_partition(result):
    return ({frozenset(d.images): d.labels
             for d in result.clusters.values()}, sorted(result.dropped))


_FUSIONS = [("onehot", 1.0), ("text", 1.0), ("text", 40.0)]


class TestZeroShotParity:
    """Both packages with ``labels.backend=zero_shot`` (the .npz bank via
    IMAGECLUST_LABEL_BANK) and ``fusion`` onehot or text (the .npz text
    checkpoint), through ``run`` below ``exact_limit``, ``run_stream`` and
    a job above a lowered ``exact_limit``: equal partitions and labels."""

    @pytest.fixture(autouse=True)
    def _bank_env(self, text_side, monkeypatch):
        monkeypatch.setenv("IMAGECLUST_LABEL_BANK", text_side[0])
        monkeypatch.delenv("IMAGECLUST_BPE_PATH", raising=False)

    @pytest.mark.parametrize("fusion,weight", _FUSIONS)
    def test_run_matches_jax(self, vit_towers, text_side, rng, tmp_path, fusion,
                             weight):
        jax_emb, port_emb = vit_towers
        names, blobs = color_group_images(rng, n_groups=5, per_group=4)
        jcfg, pcfg = _zero_shot_configs(text_side, fusion, weight)
        want = JaxPipeline(jcfg, embedder=jax_emb).run(
            [JaxUpload(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "jax"), min_size=3, max_size=6)
        pipe = Pipeline(pcfg, device="cpu", embedder=port_emb)
        got = pipe.run([UploadedImage(n, b) for n, b in zip(names, blobs)],
                       str(tmp_path / "port"), min_size=3, max_size=6)
        assert _labelled_partition(got) == _labelled_partition(want)
        counters = got.metrics.counters
        assert counters["unique_labels"] == want.metrics.counters[
            "unique_labels"] >= 2
        assert {"label", "fuse"} <= set(got.metrics.stages)
        assert "label_cache_hits" not in counters  # no per-image labeler
        if fusion == "text":
            assert pipe._text_encoder.weights_loaded

    @pytest.mark.parametrize("fusion,weight", _FUSIONS)
    def test_run_stream_matches_jax(self, vit_towers, text_side, rng, tmp_path,
                                    jax_kmeans_init, fusion, weight):
        from imageclust_tpu.data.loader import decode_images

        jax_emb, port_emb = vit_towers
        _, blobs = color_group_images(rng, n_groups=6, per_group=4)
        imgs = decode_images(blobs, size=64)
        cuts = (0, 8, 16, 24)
        jcfg, pcfg = _zero_shot_configs(text_side, fusion, weight,
                                        exact_limit=4, bucket_size=8)
        want = JaxPipeline(jcfg, embedder=jax_emb).run_stream(
            (imgs[a:b] for a, b in zip(cuts, cuts[1:])), 24,
            str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run_stream(
            (imgs[a:b] for a, b in zip(cuts, cuts[1:])), 24,
            str(tmp_path / "port"), min_size=3, max_size=6)
        assert _labelled_partition(got) == _labelled_partition(want)
        assert got.metrics.counters["unique_labels"] >= 2
        assert {"embed", "label", "fuse", "cluster"} <= set(
            got.metrics.stages)

    @pytest.mark.parametrize("fusion,weight", _FUSIONS)
    @pytest.mark.parametrize("feature_dtype", ["float32", "int8"])
    def test_big_job_matches_jax(self, vit_towers, text_side, rng, tmp_path,
                                 jax_kmeans_init, fusion, weight,
                                 feature_dtype):
        jax_emb, port_emb = vit_towers
        names, blobs = color_group_images(rng, n_groups=6, per_group=4)
        jcfg, pcfg = _zero_shot_configs(text_side, fusion, weight,
                                        exact_limit=4, bucket_size=8,
                                        feature_dtype=feature_dtype)
        want = JaxPipeline(jcfg, embedder=jax_emb).run(
            [JaxUpload(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run(
            [UploadedImage(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "port"), min_size=3, max_size=6)
        assert _labelled_partition(got) == _labelled_partition(want)
        assert "decode" not in got.metrics.stages  # the streamed branch
        assert got.metrics.counters["unique_labels"] >= 2

    def test_labels_fire_per_group(self, vit_towers, text_side, rng, tmp_path):
        """The bank's prototypes come from four of the groups: each of
        those groups' images carries its own label first."""
        _, port_emb = vit_towers
        names, blobs = color_group_images(rng, n_groups=4, per_group=3)
        pcfg = _zero_shot_configs(text_side, "onehot")[1]
        res = Pipeline(pcfg, device="cpu", embedder=port_emb).run(
            [UploadedImage(n, b) for n, b in zip(names, blobs)],
            str(tmp_path))
        pure = 0
        for d in res.clusters.values():
            groups = {int(m.split("_")[0][1:]) for m in d.images}
            if len(groups) == 1:
                pure += 1
                assert d.labels.split(", ")[0] == _BANK_NAMES[groups.pop()]
        assert pure >= 2


class TestCliBank:
    @pytest.fixture()
    def label_dirs(self, tmp_path):
        rng = np.random.default_rng(3)
        root = tmp_path / "labels"
        for label, base in (("blue", (220, 30, 30)), ("green", (30, 220, 30)),
                            ("red", (30, 30, 220))):
            (root / label).mkdir(parents=True)
            for i in range(3):
                img = np.full((64, 64, 3), base, np.uint8)
                img = img + rng.integers(0, 20, img.shape).astype(np.uint8)
                ok, enc = cv2.imencode(".bmp", img)
                (root / label / f"{i}.bmp").write_bytes(enc.tobytes())
        (root / "empty").mkdir()
        (root / "stray.bmp").write_bytes(b"x")
        return root

    def test_bank_matches_jax(self, vit_towers, label_dirs, tmp_path,
                              monkeypatch, capsys):
        import imageclust_tpu.models as jax_models
        import imageclust_tpu_torch.models as port_models
        from imageclust_tpu import cli as jax_cli

        jax_emb, port_emb = vit_towers
        monkeypatch.setenv("IMAGECLUST_JAX_CACHE", "off")
        monkeypatch.setattr(jax_models, "create_embedder",
                            lambda *a, **k: jax_emb)
        seen = {}

        def port_create(cfg, device=None, **kw):
            seen["device"] = device
            return port_emb

        monkeypatch.setattr(port_models, "create_embedder", port_create)
        outs = {p: str(tmp_path / f"{p}.npz") for p in ("jax", "port")}
        assert jax_cli.main(["bank", "--images", str(label_dirs), "--out",
                             outs["jax"]]) == 0
        assert cli.main(["bank", "--images", str(label_dirs), "--out",
                         outs["port"], "--device", "cpu"]) == 0
        assert seen["device"] == "cpu"
        assert "wrote 3 label prototypes" in capsys.readouterr().out
        with np.load(outs["jax"]) as want, np.load(outs["port"]) as got:
            assert list(got["names"]) == list(want["names"]) == [
                "blue", "green", "red"]
            assert got["vectors"].dtype == want["vectors"].dtype
            np.testing.assert_allclose(got["vectors"], want["vectors"],
                                       rtol=1e-4, atol=1e-4)
        # the bank loads into the port's labeler as written
        monkeypatch.setenv("IMAGECLUST_LABEL_BANK", outs["port"])
        from imageclust_tpu_torch.labels.zero_shot import ZeroShotLabeler

        assert ZeroShotLabeler.default(port_emb).names == [
            "blue", "green", "red"]

    def test_bank_without_labels_fails(self, vit_towers, tmp_path,
                                       monkeypatch, capsys):
        import imageclust_tpu_torch.models as port_models

        monkeypatch.setattr(port_models, "create_embedder",
                            lambda *a, **k: vit_towers[1])
        (tmp_path / "nothing").mkdir()
        assert cli.main(["bank", "--images", str(tmp_path / "nothing"),
                         "--device", "cpu"]) == 2
        assert "no label subdirectories" in capsys.readouterr().err

    def test_bank_defaults(self):
        args = cli.build_parser().parse_args(["bank", "--images", "d"])
        assert args.out == "label_bank.npz" and args.device == "cuda"
