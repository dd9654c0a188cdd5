"""The port's fine-tuning driver (models/finetune.py, ``cli train``) against
the JAX package's (tests/test_finetune.py's cases on a one-block-per-stage
ResNet50 at 32 x 32, on the CPU), and checkpoints crossing between the
packages: the JAX ``restore_variables`` reads what the port writes, a
``_state`` saved by either package resumes in the other, and a pipeline
serves a JAX-written ``embed.checkpoint_path``.

Cross-package resume: JAX trains one epoch, then JAX and the port each
resume that ``_state`` to epoch 2; their final losses agree within rtol
1e-2 (bfloat16 towers, the same batches in the same order). It runs at
lr 1e-4: in Adam's first steps each parameter moves by about lr times the
sign of its gradient, so at the default 1e-3 the bfloat16 noise in small
gradient components (tests/test_torch_train.py) swings the memorising
loss by more than 1 %. Served
checkpoint: per-row cosine >= 0.99 of the bfloat16 pooled embeddings, as
in test_torch_resnet50.py.
"""

import json
import logging
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu.config import AppConfig as JaxAppConfig
from imageclust_tpu.config import EmbedConfig as JaxEmbedConfig
from imageclust_tpu.config import LabelConfig as JaxLabelConfig
from imageclust_tpu.config import NamingConfig as JaxNamingConfig
from imageclust_tpu.models import finetune as jax_finetune
from imageclust_tpu.models import resnet50 as jax_resnet50
from imageclust_tpu.pipeline import Pipeline as JaxPipeline
from imageclust_tpu.types import UploadedImage as JaxUpload
from imageclust_tpu.utils.checkpoint import restore_variables as jax_restore
from imageclust_tpu.utils.checkpoint import save_variables as jax_save
from imageclust_tpu_torch import cli
from imageclust_tpu_torch.config import (
    AppConfig,
    EmbedConfig,
    LabelConfig,
    NamingConfig,
)
from imageclust_tpu_torch.models import finetune, registry
from imageclust_tpu_torch.models.convert import resnet50_flax_from_state_dict
from imageclust_tpu_torch.models.resnet50 import ResNet50V1
from imageclust_tpu_torch.pipeline import Pipeline
from imageclust_tpu_torch.types import UploadedImage

from helpers import color_group_images, encode_png

torch.set_num_threads(2)

_SMALL = dict(stage_layers=(1, 1, 1, 1), input_size=32)


@pytest.fixture()
def labeled_dir(rng, tmp_path):
    root = tmp_path / "data"
    for label, base in [("red", (0, 0, 220)), ("green", (0, 220, 0))]:
        d = root / label
        d.mkdir(parents=True)
        for i in range(6):
            img = np.full((40, 40, 3), base, np.uint8)
            img += rng.integers(0, 30, img.shape).astype(np.uint8)
            (d / f"{i}.png").write_bytes(encode_png(img))
    return str(root)


@pytest.fixture()
def noise_dir(tmp_path):
    """Eight classes of seeded noise images: the labels carry no signal,
    so the loss falls by memorising, not by a colour any step finds."""
    rng = np.random.default_rng(7)
    root = tmp_path / "noise"
    for label in "abcdefgh":
        d = root / label
        d.mkdir(parents=True)
        for i in range(4):
            img = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
            (d / f"{i}.png").write_bytes(encode_png(img))
    return str(root)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree)


def _epochs(caplog, logger="imageclust_tpu_torch.models.finetune"):
    return [r.epoch_stats for r in caplog.records
            if r.name == logger and hasattr(r, "epoch_stats")]


class TestLoadLabeledDir:
    def test_equals_jax(self, labeled_dir):
        got = finetune.load_labeled_dir(labeled_dir, size=32)
        want = jax_finetune.load_labeled_dir(labeled_dir, size=32)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[1].dtype == want[1].dtype == np.int32
        assert got[2] == want[2] == ["green", "red"]

    def test_empty_raises(self, tmp_path):
        with pytest.raises(ValueError, match="no class"):
            finetune.load_labeled_dir(str(tmp_path))


class TestFinetune:
    def test_end_to_end_and_jax_reads_checkpoint(self, labeled_dir,
                                                 tmp_path):
        out = str(tmp_path / "ckpt")
        model, classes, loss = finetune.finetune_resnet50(
            labeled_dir, out, epochs=2, batch_size=4, learning_rate=1e-2,
            device="cpu", **_SMALL)
        assert classes == ["green", "red"]
        assert np.isfinite(loss)
        assert os.path.isdir(out)
        back = jax_restore(out)
        want = dict(_leaves(resnet50_flax_from_state_dict(model)))
        got = dict(_leaves(back))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # the JAX template restore of the state (count, moments, epoch)
        state = jax_restore(out + "_state")
        assert int(state["epoch"]) == 2
        assert int(state["opt_state"][0]["count"]) == 6  # 12 images / 4

    def test_onnx_export_side_output_and_classes(self, labeled_dir,
                                                 tmp_path):
        import cv2

        onnx_out = str(tmp_path / "tuned.onnx")
        finetune.finetune_resnet50(
            labeled_dir, str(tmp_path / "ck"), epochs=1, batch_size=4,
            onnx_out=onnx_out, device="cpu", **_SMALL)
        net = cv2.dnn.readNetFromONNX(onnx_out)
        net.setInput(np.zeros((1, 3, 32, 32), np.float32))
        assert net.forward("resnetv17_dense0_fwd").shape == (1, 2)
        with open(tmp_path / "classes.txt") as fh:
            assert fh.read() == "green\nred"

    def test_mesh_raises(self, labeled_dir, tmp_path):
        """Formerly the refusal of ``mesh=``. An object that is not a Mesh
        is a TypeError; a Mesh (a world of one rank here) trains with the
        sharded step to the single device's weights (each leaf within
        rtol 1e-5, atol 1e-5 of its largest magnitude) and writes a
        checkpoint the JAX ``restore_variables`` reads bit for bit. Over
        four ranks: tests/test_torch_train_sharded.py."""
        from imageclust_tpu_torch.core.mesh import create_mesh

        with pytest.raises(TypeError, match="Mesh"):
            finetune.finetune_resnet50(labeled_dir, str(tmp_path / "ck"),
                                       mesh=object(), device="cpu",
                                       **_SMALL)
        kw = dict(epochs=1, batch_size=4, device="cpu", **_SMALL)
        one, _, loss_one = finetune.finetune_resnet50(
            labeled_dir, str(tmp_path / "one"), **kw)
        got, classes, loss = finetune.finetune_resnet50(
            labeled_dir, str(tmp_path / "mesh"),
            mesh=create_mesh(data=1, device="cpu"), **kw)
        assert classes == ["green", "red"]
        np.testing.assert_allclose(loss, loss_one, rtol=1e-5)
        back = dict(_leaves(jax_restore(str(tmp_path / "mesh"))))
        want = dict(_leaves(resnet50_flax_from_state_dict(got)))
        ref = dict(_leaves(resnet50_flax_from_state_dict(one)))
        assert back.keys() == want.keys() == ref.keys()
        for k in want:
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
            np.testing.assert_allclose(
                want[k], ref[k], rtol=1e-5,
                atol=1e-5 * np.abs(ref[k]).max(), err_msg=k)

    def test_default_device_needs_cuda(self, labeled_dir, tmp_path,
                                       monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            finetune.finetune_resnet50(labeled_dir, str(tmp_path / "ck"),
                                       **_SMALL)


class TestResume:
    def test_resumes_from_saved_epoch(self, labeled_dir, tmp_path, caplog):
        out = str(tmp_path / "ck")
        finetune.finetune_resnet50(labeled_dir, out, epochs=1, batch_size=4,
                                   device="cpu", **_SMALL)
        assert os.path.isdir(out + "_state")
        # asking for 3 epochs resumes at 1 (runs 2 more, not 3)
        with caplog.at_level(logging.INFO):
            _, _, loss = finetune.finetune_resnet50(
                labeled_dir, out, epochs=3, batch_size=4, device="cpu",
                **_SMALL)
        assert "resuming fine-tune from epoch 1" in caplog.text
        assert [s["epoch"] for s in _epochs(caplog)] == [1, 2]
        assert np.isfinite(loss)

    def test_resume_disabled_starts_fresh(self, labeled_dir, tmp_path,
                                          caplog):
        out = str(tmp_path / "ck2")
        finetune.finetune_resnet50(labeled_dir, out, epochs=1, batch_size=4,
                                   device="cpu", **_SMALL)
        with caplog.at_level(logging.INFO):
            finetune.finetune_resnet50(labeled_dir, out, epochs=1,
                                       batch_size=4, resume=False,
                                       device="cpu", **_SMALL)
        assert "resuming" not in caplog.text
        assert [s["epoch"] for s in _epochs(caplog)] == [0]


class TestCrossPackageResume:
    @pytest.mark.parametrize("first", ["jax", "port"])
    def test_state_resumes_in_either_package(self, noise_dir, tmp_path,
                                             caplog, first):
        """One epoch in ``first``; both packages resume that ``_state``
        to epoch 2 on the same batches."""
        start = tmp_path / "first"
        start.mkdir()
        kw = dict(epochs=1, batch_size=8, learning_rate=1e-4, **_SMALL)
        if first == "jax":
            jax_finetune.finetune_resnet50(noise_dir, str(start / "ck"), **kw)
        else:
            finetune.finetune_resnet50(noise_dir, str(start / "ck"),
                                       device="cpu", **kw)
        shutil.copytree(start, tmp_path / "j")
        shutil.copytree(start, tmp_path / "p")
        kw["epochs"] = 2
        with caplog.at_level(logging.INFO):
            _, _, jloss = jax_finetune.finetune_resnet50(
                noise_dir, str(tmp_path / "j" / "ck"), **kw)
            _, _, ploss = finetune.finetune_resnet50(
                noise_dir, str(tmp_path / "p" / "ck"), device="cpu", **kw)
        assert caplog.text.count("resuming fine-tune from epoch 1") == 2
        assert np.isfinite(jloss) and jloss > 0.01
        np.testing.assert_allclose(ploss, jloss, rtol=1e-2)


class TestCliTrain:
    def test_json_line_matches_jax_cli(self, labeled_dir, tmp_path,
                                       monkeypatch, capsys):
        from imageclust_tpu import cli as jax_cli

        def small(fn):
            return lambda *a, **k: fn(*a, **{**k, **_SMALL})

        monkeypatch.setattr(finetune, "finetune_resnet50",
                            small(finetune.finetune_resnet50))
        monkeypatch.setattr(jax_finetune, "finetune_resnet50",
                            small(jax_finetune.finetune_resnet50))
        args = ["train", "--images", labeled_dir, "--epochs", "1",
                "--batch", "4"]
        assert cli.main(args + ["--out", str(tmp_path / "p" / "ck"),
                                "--device", "cpu"]) == 0
        got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert jax_cli.main(args + ["--out", str(tmp_path / "j" / "ck")]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert set(got) == set(want) == {"checkpoint", "classes",
                                         "final_loss"}
        assert got["classes"] == want["classes"] == ["green", "red"]
        assert got["checkpoint"] == str(tmp_path / "p" / "ck")
        assert np.isfinite(got["final_loss"])
        assert os.path.isdir(got["checkpoint"])


class _SmallFlax(jax_resnet50.ResNet50V1):
    stage_layers: tuple = (1, 1, 1, 1)


class _SmallPort(ResNet50V1):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, stage_layers=(1, 1, 1, 1), **kwargs)


class TestServeJaxCheckpoint:
    def test_pipeline_from_jax_checkpoint(self, tmp_path, monkeypatch, rng):
        """Both pipelines build their tower from the same JAX-written
        checkpoint (a small tower patched into both registries) and
        embed alike; the port's tag is the JAX tag under ``torch-``."""
        monkeypatch.setattr(jax_resnet50, "ResNet50V1", _SmallFlax)
        monkeypatch.setattr(registry, "ResNet50V1", _SmallPort)
        variables = jax.tree.map(np.asarray, _SmallFlax(
            num_classes=5).init(jax.random.PRNGKey(3),
                                jnp.zeros((1, 3, 32, 32))))
        stats_rng = np.random.default_rng(3)

        def stats(tree):  # the init's 0/1 would leave the norms untested
            if "mean" in tree:
                return {"mean": stats_rng.uniform(-0.05, 0.05, tree[
                    "mean"].shape).astype(np.float32),
                        "var": stats_rng.uniform(0.5, 1.5, tree[
                            "var"].shape).astype(np.float32)}
            return {k: stats(t) for k, t in tree.items()}

        variables["batch_stats"] = stats(variables["batch_stats"])
        ck = str(tmp_path / "ck")
        jax_save(ck, variables)
        embed = dict(checkpoint_path=ck, num_classes=5, output="pooled",
                     batch_size=8, cache=False)
        jpipe = JaxPipeline(JaxAppConfig(
            embed=JaxEmbedConfig(**embed),
            labels=JaxLabelConfig(backend="fake"),
            naming=JaxNamingConfig(services=("fake",), retries=1)))
        ppipe = Pipeline(AppConfig(
            embed=EmbedConfig(**embed), labels=LabelConfig(backend="fake"),
            naming=NamingConfig(services=("fake",), retries=1)),
            device="cpu")
        assert ppipe.embedder.weights_loaded
        assert ppipe.embedder.tag == jpipe.embedder.tag.replace(
            ":ckpt-", ":torch-ckpt-")
        names, blobs = color_group_images(rng, n_groups=2, per_group=3)
        want = jpipe.run([JaxUpload(n, b) for n, b in zip(names, blobs)],
                         str(tmp_path / "jax"), min_size=3, max_size=3)
        got = ppipe.run([UploadedImage(n, b) for n, b in zip(names, blobs)],
                        str(tmp_path / "port"), min_size=3, max_size=3)
        assert sorted(m for c in got.clusters.values() for m in c.images) \
            == sorted(m for c in want.clusters.values() for m in c.images)
        u8 = rng.integers(0, 256, (8, 224, 224, 3)).astype(np.uint8)
        a = np.asarray(jpipe.embedder.embed(u8), np.float64)
        b = ppipe.embedder.embed(u8).astype(np.float64)
        cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1)
                                * np.linalg.norm(b, axis=1))
        assert cos.min() >= 0.99, cos
