"""The port's scale path against the JAX package: streamed ingest
(``run_paths`` above ``exact_limit``), ``run_stream``, the streamed embed
and the CLI's switch to streaming.

Both pipelines run the same float32 ResNet50 (one block per stage, Flax
variables converted into the port) and the bucketed engine with the port's
k-means seeded from the JAX package's ``jax.random`` indices. The towers
agree to about 1e-4, so clusters are compared as sets of members (colour
groups are far apart; the order of merges inside a group may differ).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.config import AppConfig as JaxAppConfig
from imageclust_tpu.config import ClusterConfig as JaxClusterConfig
from imageclust_tpu.config import LabelConfig as JaxLabelConfig
from imageclust_tpu.config import NamingConfig as JaxNamingConfig
from imageclust_tpu.data.loader import decode_images
from imageclust_tpu.models.registry import Embedder as JaxEmbedder
from imageclust_tpu.models.registry import EmbedderSpec as JaxSpec
from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu.pipeline import Pipeline as JaxPipeline
from imageclust_tpu_torch import cli
from imageclust_tpu_torch import pipeline as tpipeline
from imageclust_tpu_torch.cluster import sharded as tsh
from imageclust_tpu_torch.config import (
    AppConfig,
    ClusterConfig,
    LabelConfig,
    NamingConfig,
)
from imageclust_tpu_torch.models.registry import Embedder, EmbedderSpec
from imageclust_tpu_torch.models.resnet50 import ResNet50V1
from imageclust_tpu_torch.pipeline import Pipeline

from helpers import color_group_images

torch.set_num_threads(1)

_LAYERS = (1, 1, 1, 1)
_DIM = 32
_BIG = dict(exact_limit=4, bucket_size=8)  # 24 images -> 4 buckets


@pytest.fixture(scope="module")
def towers():
    """(JAX embedder, port embedder) on the same float32 weights."""
    flax_model = FlaxResNet(dtype=jnp.float32, norm_dtype=jnp.float32,
                            stage_layers=_LAYERS, num_classes=_DIM)
    raw_model = FlaxResNet(dtype=jnp.float32, norm_dtype=jnp.float32,
                           stage_layers=_LAYERS, num_classes=_DIM,
                           stem_mode="s2d_raw")
    variables = flax_model.init(jax.random.PRNGKey(1),
                                jnp.zeros((1, 3, 224, 224)))
    spec = dict(name="resnet50", input_size=224, dim=_DIM, scale=1 / 255.0,
                mean=(0.0, 0.0, 0.0), std=(1.0, 1.0, 1.0), bgr_input=True)
    jax_emb = JaxEmbedder(
        JaxSpec(**spec), lambda v, x: flax_model.apply(v, x), variables,
        batch_size=8, tag="jax-test",
        raw_apply_fn=lambda v, u8: raw_model.apply(v, u8))
    port_emb = Embedder(
        EmbedderSpec(**spec),
        ResNet50V1(num_classes=_DIM, dtype="float32", norm_dtype="float32",
                   stage_layers=_LAYERS, stem_mode="s2d_raw"),
        batch_size=8, device=torch.device("cpu"), tag="torch-test")
    port_emb.load_flax_variables(jax.tree.map(np.asarray, variables))
    return jax_emb, port_emb


@pytest.fixture()
def jax_init(monkeypatch):
    def init(x, k, seed):
        idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                x.shape[0])[:k])
        return x[torch.from_numpy(idx.copy()).to(x.device)].float()

    monkeypatch.setattr(tsh, "_kmeans_init", init)


def _configs(labels="fake", **cluster):
    return (
        JaxAppConfig(labels=JaxLabelConfig(backend=labels),
                     naming=JaxNamingConfig(services=("fake",), retries=1),
                     cluster=JaxClusterConfig(**cluster)),
        AppConfig(labels=LabelConfig(backend=labels),
                  naming=NamingConfig(services=("fake",), retries=1),
                  cluster=ClusterConfig(**cluster)),
    )


def _partition(result):
    return ({frozenset(d.images) for d in result.clusters.values()},
            sorted(result.dropped))


def _image_dir(rng, tmp_path, groups=6, per=4):
    names, blobs = color_group_images(rng, n_groups=groups, per_group=per)
    src = tmp_path / "imgs"
    src.mkdir()
    paths = []
    for n, b in zip(names, blobs):
        (src / n).write_bytes(b)
        paths.append(str(src / n))
    return names, blobs, paths


class TestStreamedPipeline:
    def test_run_paths_above_exact_limit_matches_jax(self, towers, rng,
                                                     tmp_path, jax_init):
        jax_emb, port_emb = towers
        names, _, paths = _image_dir(rng, tmp_path)
        jcfg, pcfg = _configs(**_BIG)
        want = JaxPipeline(jcfg, embedder=jax_emb).run_paths(
            paths, str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run_paths(
            paths, str(tmp_path / "port"), min_size=3, max_size=6)
        assert _partition(got) == _partition(want)
        placed = [m for d in got.clusters.values() for m in d.images]
        assert sorted(placed + got.dropped) == sorted(names)
        for d in got.clusters.values():
            assert 3 <= len(d.images) <= 6 and d.labels  # labels streamed
        assert got.metrics.counters["merges"] > 0
        assert "embed" in got.metrics.stages
        assert "decode" not in got.metrics.stages  # inside the stream

    def test_run_stream_host_chunks_matches_jax(self, towers, rng, tmp_path,
                                                jax_init):
        jax_emb, port_emb = towers
        _, blobs = color_group_images(rng, n_groups=6, per_group=4)
        imgs = decode_images(blobs, size=224)
        cuts = (0, 8, 15, 23, 24)  # ragged chunks, none above batch_size
        chunks = lambda: (imgs[a:b] for a, b in zip(cuts, cuts[1:]))  # noqa
        jcfg, pcfg = _configs(labels="none", **_BIG)
        want = JaxPipeline(jcfg, embedder=jax_emb).run_stream(
            chunks(), 24, str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run_stream(
            chunks(), 24, str(tmp_path / "port"), min_size=3, max_size=6)
        assert _partition(got) == _partition(want)
        assert got.metrics.counters["images"] == 24
        assert set(got.metrics.stages) >= {"embed", "cluster", "name",
                                           "report"}

    def test_run_stream_single_bucket_and_names(self, towers, rng,
                                                tmp_path):
        _, blobs = color_group_images(rng, n_groups=3, per_group=4)
        imgs = decode_images(blobs, size=224)
        _, pcfg = _configs(labels="none", exact_limit=4)
        res = Pipeline(pcfg, device="cpu", embedder=towers[1]).run_stream(
            [imgs[:8], imgs[8:]], 12, str(tmp_path),
            name_fn=lambda i: f"x{i}.jpg",
            min_size=3, max_size=6)
        placed = [m for d in res.clusters.values() for m in d.images]
        assert sorted(placed + res.dropped) == sorted(
            f"x{i}.jpg" for i in range(12))

    @pytest.mark.parametrize("backend,exc", [("rekognition", ValueError),
                                             ("fake", ValueError)])
    def test_run_stream_label_backends(self, towers, tmp_path, backend,
                                       exc):
        _, pcfg = _configs(labels=backend)
        with pytest.raises(exc):
            Pipeline(pcfg, device="cpu", embedder=towers[1]).run_stream(
                [], 4, str(tmp_path))

    @pytest.mark.parametrize("cluster,exc", [
        (dict(feature_dtype="fp8"), ValueError),
        (dict(scale_engine="typo"), ValueError)])
    def test_unported_scale_modes_raise(self, towers, rng, tmp_path,
                                        cluster, exc):
        _, _, paths = _image_dir(rng, tmp_path, groups=2, per=3)
        _, pcfg = _configs(exact_limit=4, **cluster)
        with pytest.raises(exc):
            Pipeline(pcfg, device="cpu", embedder=towers[1]).run_paths(
                paths, str(tmp_path / "w"))

    @pytest.mark.parametrize("feature_dtype", ["bfloat16", "int8"])
    def test_run_paths_residency_matches_jax(self, towers, rng, tmp_path,
                                             jax_init, feature_dtype):
        """The streamed ingest into bf16/int8 residency (refused before it
        was ported): the fake labeler's block fuses onto the residency
        grid (divided by the int8 stream scale) and the partition is the
        JAX package's."""
        jax_emb, port_emb = towers
        names, _, paths = _image_dir(rng, tmp_path)
        jcfg, pcfg = _configs(feature_dtype=feature_dtype, **_BIG)
        want = JaxPipeline(jcfg, embedder=jax_emb).run_paths(
            paths, str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run_paths(
            paths, str(tmp_path / "port"), min_size=3, max_size=6)
        assert _partition(got) == _partition(want)
        placed = [m for d in got.clusters.values() for m in d.images]
        assert sorted(placed + got.dropped) == sorted(names)

    @pytest.mark.parametrize("feature_dtype", ["bfloat16", "int8"])
    def test_run_stream_residency_matches_jax(self, towers, rng, tmp_path,
                                              jax_init, feature_dtype):
        jax_emb, port_emb = towers
        _, blobs = color_group_images(rng, n_groups=6, per_group=4)
        imgs = decode_images(blobs, size=224)
        chunks = lambda: (imgs[a:a + 8] for a in range(0, 24, 8))  # noqa
        jcfg, pcfg = _configs(labels="none", feature_dtype=feature_dtype,
                              **_BIG)
        want = JaxPipeline(jcfg, embedder=jax_emb).run_stream(
            chunks(), 24, str(tmp_path / "jax"), min_size=3, max_size=6)
        got = Pipeline(pcfg, device="cpu", embedder=port_emb).run_stream(
            chunks(), 24, str(tmp_path / "port"), min_size=3, max_size=6)
        assert _partition(got) == _partition(want)


class TestChainEngine:
    """``cluster.scale_engine="chain"`` above ``exact_limit`` (refused until
    the chain engine was ported): every entry point gives the JAX
    pipeline's clusters on the same images, compared as sets of members as
    in the rest of this file."""

    @pytest.mark.parametrize("entry", ["run", "run_paths", "run_stream"])
    def test_entry_points_match_jax(self, towers, rng, tmp_path, entry):
        jax_emb, port_emb = towers
        names, blobs, paths = _image_dir(rng, tmp_path)
        jcfg, pcfg = _configs(labels="none" if entry == "run_stream"
                              else "fake", exact_limit=4,
                              scale_engine="chain")
        jp = JaxPipeline(jcfg, embedder=jax_emb)
        pp = Pipeline(pcfg, device="cpu", embedder=port_emb)
        if entry == "run":
            from imageclust_tpu.types import UploadedImage as JaxUpload
            from imageclust_tpu_torch.types import UploadedImage

            want = jp.run([JaxUpload(n, b) for n, b in zip(names, blobs)],
                          str(tmp_path / "jax"))
            got = pp.run([UploadedImage(n, b) for n, b in zip(names, blobs)],
                         str(tmp_path / "port"))
        elif entry == "run_paths":
            want = jp.run_paths(paths, str(tmp_path / "jax"))
            got = pp.run_paths(paths, str(tmp_path / "port"))
        else:
            imgs = decode_images(blobs, size=224)
            chunks = lambda: (imgs[a:a + 8] for a in range(0, 24, 8))  # noqa
            want = jp.run_stream(chunks(), 24, str(tmp_path / "jax"))
            got = pp.run_stream(chunks(), 24, str(tmp_path / "port"))
        assert _partition(got) == _partition(want)
        assert set(got.clusters) == set(want.clusters)
        placed = [m for d in got.clusters.values() for m in d.images]
        assert len(placed) + len(got.dropped) == 24
        assert got.metrics.counters["merges"] > 0

    def test_cli_run_matches_jax(self, towers, rng, tmp_path, monkeypatch,
                                 capsys):
        jax_emb, port_emb = towers
        _, _, paths = _image_dir(rng, tmp_path)

        class TinyTower(Pipeline):
            def __init__(self, config, device=None):
                super().__init__(config, device=device, embedder=port_emb)

        monkeypatch.setattr(tpipeline, "Pipeline", TinyTower)
        rc = cli.main(["run", "--images", str(tmp_path / "imgs"),
                       "--device", "cpu", "--out", str(tmp_path / "w"),
                       "--labeler", "fake", "--namers", "fake",
                       "--set", "cluster.exact_limit=4",
                       "--set", "cluster.scale_engine=chain"])
        assert rc == 0
        got = json.loads(capsys.readouterr().out)
        jcfg, _ = _configs(exact_limit=4, scale_engine="chain")
        want = JaxPipeline(jcfg, embedder=jax_emb).run_paths(
            sorted(paths), str(tmp_path / "jax")).to_dict()
        assert {frozenset(v["images"]) for v in got["clusters"].values()} \
            == {frozenset(v["images"]) for v in want["clusters"].values()}
        assert got["dropped"] == want["dropped"]

    def test_server_matches_jax(self, towers, rng, tmp_path):
        import threading
        import urllib.request
        import uuid

        from imageclust_tpu.types import UploadedImage as JaxUpload
        from imageclust_tpu_torch.service.app import create_server
        from imageclust_tpu_torch.service.jobs import JobStore

        jax_emb, port_emb = towers
        names, blobs = color_group_images(rng, n_groups=6, per_group=4)
        jcfg, pcfg = _configs(exact_limit=4, scale_engine="chain")
        server = create_server(
            pcfg, Pipeline(pcfg, device="cpu", embedder=port_emb),
            JobStore(str(tmp_path / "port")), host="127.0.0.1", port=0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        try:
            bnd = uuid.uuid4().hex
            body = b"".join(
                f'--{bnd}\r\nContent-Disposition: form-data; name="images"; '
                f'filename="{n}"\r\nContent-Type: image/png\r\n\r\n'
                .encode() + b + b"\r\n" for n, b in zip(names, blobs))
            body += f"--{bnd}--\r\n".encode()
            req = urllib.request.Request(
                f"http://127.0.0.1:{server.server_address[1]}/api/cluster",
                data=body, method="POST", headers={
                    "Content-Type": f"multipart/form-data; boundary={bnd}"})
            with urllib.request.urlopen(req, timeout=120) as r:
                got = json.loads(r.read())
        finally:
            server.shutdown()
            server.server_close()
            server.service.wait_background(30)
            thread.join(30)
        want = JaxPipeline(jcfg, embedder=jax_emb).run(
            [JaxUpload(n, b) for n, b in zip(names, blobs)],
            str(tmp_path / "jax"))
        assert {frozenset(v["images"]) for v in got["clusters"].values()} \
            == {frozenset(d.images) for d in want.clusters.values()}
        assert got["dropped"] == want.dropped


class TestEmbedStream:
    def test_matches_embed_preallocated_and_list(self, towers, rng):
        _, emb = towers
        u8 = rng.integers(0, 256, (13, 224, 224, 3)).astype(np.uint8)
        want = emb.embed(u8)
        parts = [u8[i:i + 5] for i in range(0, 13, 5)]
        got_list = emb.embed_stream(iter(parts))
        got_buf = emb.embed_stream(iter(parts), total=13)
        for got in (got_list, got_buf):
            assert got.shape == (13, _DIM) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                       atol=1e-4)
        tensor_chunks = [torch.from_numpy(p) for p in parts]
        np.testing.assert_array_equal(
            emb.embed_stream(iter(tensor_chunks), total=13).numpy(),
            got_buf.numpy())

    def test_rejects_bad_streams(self, towers):
        _, emb = towers
        with pytest.raises(ValueError, match="stream chunk"):
            emb.embed_stream([np.zeros((9, 224, 224, 3), np.uint8)])
        two = [np.zeros((2, 224, 224, 3), np.uint8)]
        with pytest.raises(ValueError, match="expected total"):
            emb.embed_stream(iter(two), total=3)
        with pytest.raises(ValueError, match="more than total"):
            emb.embed_stream(iter(two), total=1)
        with pytest.raises(ValueError, match="residency"):
            emb.embed_stream_quantized(iter(two), out_dtype=torch.float16)

    @pytest.mark.parametrize("total", [None, 13])
    def test_quantized_stream_matches_jax(self, towers, rng, total):
        """bf16: a per-chunk rounding; int8: the grid with the scale taken
        from the FIRST chunk (absmax * 1.25 / 127), later chunks clipped.
        The towers agree to ~1e-4, so the port is held bit for bit to the
        rule applied to its own f32 stream and to the JAX stream within a
        grid step."""
        jax_emb, emb = towers
        u8 = rng.integers(0, 256, (13, 224, 224, 3)).astype(np.uint8)
        parts = [u8[i:i + 5] for i in range(0, 13, 5)]
        f32 = emb.embed_stream(iter(parts)).numpy()
        q, scale = emb.embed_stream_quantized(
            iter(parts), out_dtype=torch.int8, total=total)
        want_scale = max(float(np.abs(f32[:5]).max()) * 1.25 / 127.0, 1e-30)
        assert scale == want_scale and q.dtype == torch.int8
        np.testing.assert_array_equal(
            q.numpy(), np.clip(np.round(f32 / np.float32(scale)), -127,
                               127).astype(np.int8))
        jq, jscale = jax_emb.embed_stream_quantized(
            iter(parts), out_dtype=jnp.int8, total=total)
        np.testing.assert_allclose(scale, jscale, rtol=1e-4)
        assert np.abs(q.numpy().astype(int)
                      - np.asarray(jq).astype(int)).max() <= 1
        b, bscale = emb.embed_stream_quantized(
            iter(parts), out_dtype=torch.bfloat16, total=total)
        assert bscale == 1.0 and b.dtype == torch.bfloat16
        assert torch.equal(b, torch.from_numpy(f32).to(torch.bfloat16))
        jb, _ = jax_emb.embed_stream_quantized(
            iter(parts), out_dtype=jnp.bfloat16, total=total)
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(jb.astype(jnp.float32)),
                                   rtol=1e-2, atol=1e-2)

    @pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
    def test_fuse_big_matches_jax(self, rng, dtype):
        """The label block in the residency dtype, on the int8 grid divided
        by the stream scale and rounded; an all-zero rounding warns."""
        emb = rng.integers(-100, 100, (6, 4))
        labels = (rng.random((6, 3)) < 0.5).astype(np.float32) * 0.7
        jdt = {"bfloat16": jnp.bfloat16, "int8": jnp.int8}[dtype]
        tdt = {"bfloat16": torch.bfloat16, "int8": torch.int8}[dtype]
        je = jnp.asarray(emb).astype(jdt)
        te = torch.from_numpy(emb).to(tdt)
        for scale in (0.3, 100.0):
            want = JaxPipeline._fuse_big(None, je, labels, scale)
            got = Pipeline._fuse_big(None, te, labels, scale)
            assert got.dtype == tdt
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))


class TestCliStreaming:
    @pytest.fixture()
    def calls(self, monkeypatch):
        seen = []

        class FakePipeline:
            def __init__(self, config, device=None):
                self.config = config

            def _result(self):
                class R:
                    html_path = "x.html"

                    def to_dict(self):
                        return {"clusters": {}}
                return R()

            def run(self, uploads, *a, **k):
                seen.append(("run", len(uploads)))
                return self._result()

            def run_paths(self, paths, *a, **k):
                seen.append(("run_paths", len(paths)))
                return self._result()

        monkeypatch.setattr(tpipeline, "Pipeline", FakePipeline)
        return seen

    @pytest.mark.parametrize("extra,want", [
        ([], "run"),
        (["--stream"], "run_paths"),
        (["--set", "cluster.exact_limit=4"], "run_paths")])
    def test_switches_to_run_paths_above_exact_limit(self, rng, tmp_path,
                                                     calls, extra, want):
        _, _, _ = _image_dir(rng, tmp_path, groups=2, per=3)
        rc = cli.main(["run", "--images", str(tmp_path / "imgs"),
                       "--device", "cpu", "--out", str(tmp_path / "w"),
                       *extra])
        assert rc == 0
        assert calls == [(want, 6)]
