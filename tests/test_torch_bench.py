"""The port's benchmark harness (``imageclust_tpu_torch/bench.py``) against
the JAX package's (the root ``bench.py``), on the CPU.

The feature synthesis mirrors tests/test_bench.py's cases; cluster-only
runs both harnesses on the same seeded features and must give the same
metric, unit, cluster count and dropped count; every other mode keeps
bench.py's metric names and JSON contract. ``vs_baseline`` is null where
bench.py divides by the JAX package's TPU north star."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from imageclust_tpu_torch import bench, cli

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench as jax_bench  # noqa: E402  (the root bench.py)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def two_threads():
    """This file's engines and towers run on two threads. pytest-xdist's
    loadfile schedule runs it after tests/test_naming.py (it has fewer
    cases), whose wall-clock test the suite's one thread is for."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture()
def short_resnet50(monkeypatch):
    """ResNet50 at full width with one block a stage: the modes' JSON
    contracts do not need the tower's depth."""
    from imageclust_tpu_torch.models import registry

    class Short(registry.ResNet50V1):
        def __init__(self, *a, **k):
            super().__init__(*a, stage_layers=(1, 1, 1, 1), **k)

    monkeypatch.setattr(registry, "ResNet50V1", Short)


def _one_line(capsys) -> dict:
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1, out
    return json.loads(out[0])


class TestSynthFeatures:
    def test_one_shot_path(self):
        x = bench._synth_features(512, 16, torch.float32, device="cpu")
        assert x.shape == (512, 16) and x.dtype == torch.float32
        assert abs(float(x.mean())) < 0.1 and abs(float(x.std()) - 1) < 0.1

    @pytest.mark.parametrize("n", [96, 100])  # a whole number of blocks,
    def test_block_path_fills_every_row(self, n):  # and a clamped tail
        x = bench._synth_features(n, 30, torch.float32, one_shot_elems=0,
                                  block_elems=32 * 30, device="cpu")
        assert x.shape == (n, 30)
        assert not bool(torch.all(x == 0, dim=1).any()), "unfilled row"
        assert abs(float(x.mean())) < 0.1
        assert abs(float(x.std()) - 1) < 0.15

    def test_block_path_bf16(self):
        x = bench._synth_features(64, 8, torch.bfloat16, one_shot_elems=0,
                                  block_elems=16 * 8, device="cpu")
        assert x.dtype == torch.bfloat16 and x.shape == (64, 8)
        assert not bool(torch.all(x.float() == 0, dim=1).any())

    def test_int8_on_the_grid(self):
        x = bench._synth_features(2048, 32, torch.int8, device="cpu")
        assert x.dtype == torch.int8 and x.shape == (2048, 32)
        assert int(x.min()) >= -127 and int(x.max()) <= 127
        # N(0, 1) * 127 / 3.5, rounded: clipping at 3.5 sigma barely moves it
        assert abs(float(x.float().std()) - 127 / 3.5) < 1.0
        assert abs(float(x.float().mean())) < 0.5


@pytest.mark.parametrize("engine, n", [("auto", 600), ("bucketed", 5000),
                                       ("chain", 600)])
def test_cluster_only_matches_jax(monkeypatch, engine, n):
    """The port's k-means starts from the JAX package's rows (it draws its
    own from a ``torch.Generator``), as in tests/test_torch_sharded.py."""
    import jax
    import jax.numpy as jnp

    from imageclust_tpu_torch.cluster import sharded

    def jax_rows(x, k, seed):
        idx = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed),
                                                x.shape[0])[:k])
        return x[torch.from_numpy(idx.copy())].to(torch.float32)

    monkeypatch.setattr(sharded, "_kmeans_init", jax_rows)
    d = 16
    x = np.random.default_rng(7).normal(size=(n, d)).astype(np.float32)
    monkeypatch.setattr(jax_bench, "_synth_features",
                        lambda *a, **k: jnp.asarray(x))
    monkeypatch.setattr(bench, "_synth_features",
                        lambda *a, **k: torch.from_numpy(x.copy()))
    want = jax_bench.bench_cluster_only(n, d, 256, engine)
    got = bench.bench_cluster_only(n, d, 256, engine, device="cpu")
    assert got["metric"] == want["metric"] == f"ward_cluster_{n}_items"
    assert got["unit"] == want["unit"] == "s"
    assert got["vs_baseline"] is None
    assert set(got["detail"]) == set(want["detail"]) | {"device"}
    assert got["detail"]["device"] == "cpu"
    for key in ("n_clusters", "dropped", "d", "engine", "feature_dtype"):
        assert got["detail"][key] == want["detail"][key], key


def _conv_dense_macs(model) -> int:
    """Multiply-adds of every convolution (weight elements times output
    pixels, at 224 x 224 through the standard stem) and the dense layer."""
    from imageclust_tpu_torch.models.resnet50 import _Conv

    macs = []
    hooks = [m.register_forward_hook(
        lambda mod, inp, out: macs.append(mod.weight.numel()
                                          * out.shape[2] * out.shape[3]))
        for m in model.modules() if isinstance(m, _Conv)]
    try:
        with torch.inference_mode():
            model(torch.zeros(1, 224, 224, 3), stem_mode="standard")
    finally:
        for h in hooks:
            h.remove()
    return sum(macs) + model.dense0.weight.numel()


def test_embed_only_contract_and_flops(monkeypatch):
    from imageclust_tpu_torch.models import registry

    built = []
    real = registry.create_embedder

    def spy(*a, **k):
        built.append(real(*a, **k))
        return built[-1]

    monkeypatch.setattr(bench, "create_embedder", spy)
    result = bench.bench_embed_only("resnet50", 8, 16, device="cpu")
    assert result["metric"] == "embed_img_per_s[resnet50 b8]"
    assert result["unit"] == "img/s/chip"
    assert result["value"] > 0
    detail = result["detail"]
    assert detail["model"] == "resnet50" and detail["device"] == "cpu"
    # the card's rates and peak share are no CPU numbers
    assert "pct_peak" not in detail and "tf_per_s" not in detail
    want = 2 * _conv_dense_macs(built[0].model) / 1e9
    # the s2d stem's 4x4 kernel over 12 channels does 192 multiply-adds an
    # output where the 7x7 stem over 3 does 147: 0.9 % of the tower
    assert detail["gflops_per_img"] == pytest.approx(want, rel=0.01)


def test_flops_count_int8_gemms_and_k5_launches(monkeypatch):
    """``torch._int_mm`` counts as a matmul; each K5 launch during the
    count (a ctypes call the counter cannot see) adds 4 * B * T^2 * width."""
    from imageclust_tpu_torch.models.vit import VIT_CONFIGS
    from imageclust_tpu_torch.ops import attention

    monkeypatch.setattr(attention, "launches", attention.launches)
    a = torch.ones(32, 64, dtype=torch.int8)
    b = torch.ones(64, 16, dtype=torch.int8)
    launch = []

    class Tower:
        spec = type("spec", (), {"name": "vit_b32"})

        def _forward(self, batch):
            attention.launches += len(launch)
            return torch._int_mm(a, b)

    assert bench._flops_per_batch(Tower(), a) == 2 * 32 * 64 * 16
    launch.append(1)
    vc = VIT_CONFIGS["vit_b32"]
    t = (vc.image_size // vc.patch) ** 2 + 1
    assert bench._flops_per_batch(Tower(), a) == (
        2 * 32 * 64 * 16 + 4 * 32 * t * t * vc.width)


def test_e2e_one_line_and_sizes(monkeypatch, capsys, short_resnet50):
    results = []
    real = bench.constrained_ward_bucketed

    def spy(feats, **kw):
        results.append((feats.shape, real(feats, **kw)))
        return results[-1][1]

    monkeypatch.setattr(bench, "constrained_ward_bucketed", spy)
    assert bench.main(["--n", "16", "--batch", "8", "--bucket", "8",
                       "--device", "cpu"]) == 0
    line = _one_line(capsys)
    assert line["metric"] == "e2e_embed+ward_0k_images"
    assert line["unit"] == "s" and line["value"] > 0
    assert line["vs_baseline"] is None
    assert len(results) == 2  # the untimed pass, then the timed one
    shape, res = results[-1]
    assert tuple(shape) == (16, 1000)
    assert not res.dropped
    assert all(3 <= len(m) <= 6 for m in res.cluster_map.values())


def test_e2e_stream_one_line_and_report(monkeypatch, capsys, tmp_path,
                                        short_resnet50):
    from imageclust_tpu_torch.pipeline import Pipeline

    jobs = []
    real = Pipeline.run_stream

    def spy(self, *a, **k):
        jobs.append(real(self, *a, **k))
        return jobs[-1]

    monkeypatch.setattr(Pipeline, "run_stream", spy)
    assert bench.main(["--e2e-stream", "--n", "32", "--batch", "8",
                       "--work-dir", str(tmp_path), "--device", "cpu"]) == 0
    line = _one_line(capsys)
    assert line["metric"] == "e2e_stream_0k_images[resnet50 float32]"
    assert line["unit"] == "s" and line["vs_baseline"] is None
    (job,) = jobs
    assert (tmp_path / "clusters.html").exists()
    assert job.html_path == str(tmp_path / "clusters.html")
    sizes = [len(c.images) for c in job.clusters.values()]
    assert not job.dropped and sum(sizes) == 32
    assert all(3 <= s <= 6 for s in sizes)


def test_decode_contract():
    result = bench.bench_decode(16, 2, device="cpu")
    assert result["metric"] == "host_decode_16_jpegs"
    assert result["unit"] == "s"
    assert result["vs_baseline"] > 0
    assert set(result["detail"]) == {"images_per_sec", "device"}


def test_without_cv2_names_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="cv2"):
        bench.bench_decode(16, 2, device="cpu")


def test_quality_contract():
    result = bench.bench_quality(600, 16, 1.0, "", 8, device="cpu")
    assert result["metric"] == "quality_nonparity_min_ari[n600 d16 sep1.0]"
    assert result["unit"] == "ari_vs_f32_parity"
    detail = result["detail"]
    assert set(detail) == {"worst_mode", "seed_yardstick_ari", "modes",
                           "device"}
    assert set(detail["modes"]) == {"residency_bfloat16", "residency_int8",
                                    "fusion_text"}
    assert result["value"] == detail["modes"][detail["worst_mode"]]["ari"]
    assert result["vs_baseline"] == round(
        result["value"] / max(detail["seed_yardstick_ari"], 1e-9), 3)


def test_cli_bench_on_cpu(capsys):
    assert cli.main(["bench", "--device", "cpu", "--cluster-only",
                     "--n", "600", "--d", "16"]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last)["metric"] == "ward_cluster_600_items"


def test_cli_bench_default_device_needs_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["bench", "--cluster-only", "--n", "600", "--d", "16"])
    assert capsys.readouterr().out == ""
