"""ONNX ingestion and export of the port's ResNet50 against the JAX
package's (models/onnx_io.py, resnet50.load_onnx_params, onnx_export.py),
the registry's ``embed.onnx_path``, and ``cli export`` / ``cli models``.

The file is written by the JAX exporter from a Flax tower (64x64 inputs, 32
classes, every block, randomised BatchNorm statistics), so no download is
needed. Weights move between the packages as float32 bits: the loaded
``state_dict`` must equal the JAX route's bit for bit, and the port's
export of the same weights must be byte-identical to the JAX exporter's.
"""

import hashlib
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from imageclust_tpu import cli as jax_cli
from imageclust_tpu.models.onnx_export import (
    export_resnet50_onnx as jax_export,
)
from imageclust_tpu.models.onnx_io import (
    read_onnx_graph,
    read_onnx_initializers,
    write_onnx_model,
)
from imageclust_tpu.models.registry import _weights_tag as jax_tag
from imageclust_tpu.models.resnet50 import ResNet50V1 as FlaxResNet
from imageclust_tpu.models.resnet50 import load_onnx_params as jax_load
from imageclust_tpu_torch import cli
from imageclust_tpu_torch.config import EmbedConfig
from imageclust_tpu_torch.models import create_embedder
from imageclust_tpu_torch.models import onnx_io
from imageclust_tpu_torch.models.convert import resnet50_state_dict_from_flax
from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx
from imageclust_tpu_torch.models.resnet50 import ResNet50V1, load_onnx_params

torch.set_num_threads(1)

CLASSES = 32


def _sha(path) -> str:
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


def _randomised(v, rng):
    """Flax variables with BatchNorm statistics and affines moved off the
    init's 0/1 (which would leave them untested)."""
    def walk(tree, leaf):
        return {k: walk(t, leaf) if isinstance(t, dict) else leaf(k, t)
                for k, t in tree.items()}

    def stat(k, t):
        lo, hi = (-0.05, 0.05) if k == "mean" else (0.5, 1.5)
        return rng.uniform(lo, hi, t.shape).astype(np.float32)

    def affine(k, t):
        if k in ("scale", "bias") and t.ndim == 1:
            base = 1.0 if k == "scale" else 0.0
            return (base + rng.uniform(-0.1, 0.1, t.shape)).astype(
                np.float32)
        return t

    return {"params": walk(v["params"], affine),
            "batch_stats": walk(v["batch_stats"], stat)}


@pytest.fixture(scope="module")
def flax_tower(tmp_path_factory):
    """(Flax variables as numpy, the JAX exporter's file of them)."""
    model = FlaxResNet(num_classes=CLASSES, dtype=jnp.float32)
    v = jax.tree.map(np.asarray, model.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 3, 64, 64), jnp.float32)))
    variables = _randomised(v, np.random.default_rng(3))
    path = tmp_path_factory.mktemp("onnx") / "jax.onnx"
    jax_export(variables, str(path), num_classes=CLASSES)
    return variables, path


def _port_model():
    return ResNet50V1(num_classes=CLASSES, dtype="float32",
                      norm_dtype="float32")


class TestIngestion:
    def test_state_dict_equals_jax_route(self, flax_tower):
        variables, path = flax_tower
        got = load_onnx_params(str(path), _port_model())
        want = resnet50_state_dict_from_flax(
            jax.tree.map(np.asarray, jax_load(str(path), variables)))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == torch.float32
            assert torch.equal(got[k].view(torch.int32),
                               want[k].view(torch.int32)), k

    def test_reader_is_the_jax_reader(self, flax_tower):
        _, path = flax_tower
        mine = onnx_io.read_onnx_initializers(str(path))
        theirs = read_onnx_initializers(str(path))
        assert mine.keys() == theirs.keys()
        assert all(np.array_equal(mine[k], theirs[k]) for k in mine)
        assert onnx_io.read_onnx_graph(str(path)) == read_onnx_graph(
            str(path))

    @pytest.mark.parametrize("fault", ["truncated", "renamed"])
    def test_bad_initializer_names_the_jax_problems(self, flax_tower,
                                                    tmp_path, fault):
        variables, path = flax_tower
        inits = read_onnx_initializers(str(path))
        name = "resnetv17_stage2_conv1_weight"
        if fault == "truncated":
            inits[name] = inits[name][:-3]
        else:
            inits["resnetv17_stage2_conv1_wieght"] = inits.pop(name)
        bad = tmp_path / "bad.onnx"
        write_onnx_model(str(bad), read_onnx_graph(str(path)), inits,
                         {"data": (1, 3, 224, 224)},
                         {"resnetv17_dense0_fwd": (1, CLASSES)})
        with pytest.raises(ValueError) as mine:
            load_onnx_params(str(bad), _port_model())
        with pytest.raises(ValueError) as theirs:
            jax_load(str(bad), variables)
        problems = lambda e: sorted(str(e.value).splitlines()[1:])  # noqa
        assert problems(mine) == problems(theirs)
        assert str(mine.value).splitlines()[0] == "ONNX->Flax conversion failed:"
        assert any("stage2_block0/conv1" in p for p in problems(mine))


class TestExport:
    def test_byte_identical_to_jax_export(self, flax_tower, tmp_path):
        variables, path = flax_tower
        model = _port_model()
        model.load_state_dict(resnet50_state_dict_from_flax(variables))
        out = tmp_path / "port.onnx"
        export_resnet50_onnx(model, str(out))
        assert _sha(out) == _sha(path)

    def test_round_trip(self, tmp_path):
        model = ResNet50V1(num_classes=CLASSES, stage_layers=(1, 2, 1, 1),
                           dtype="float32").init_random(5)
        with torch.no_grad():
            for name, buf in model.named_buffers():
                buf.uniform_(0.5, 1.5)
        out = tmp_path / "rt.onnx"
        export_resnet50_onnx(model, str(out))
        back = ResNet50V1(num_classes=CLASSES, stage_layers=(1, 2, 1, 1),
                          dtype="float32")
        sd = load_onnx_params(str(out), back)
        want = model.state_dict()
        assert sd.keys() == want.keys()
        assert all(torch.equal(sd[k], want[k]) for k in want)
        back.load_state_dict(sd)
        x = torch.rand(2, 3, 64, 64)
        with torch.inference_mode():
            torch.testing.assert_close(back(x), model(x), rtol=0, atol=0)

    def test_folded_tower_refused(self, tmp_path):
        from imageclust_tpu_torch.models.resnet50 import fold_bn_variables

        folded = fold_bn_variables(_port_model().init_random(0))
        with pytest.raises(ValueError, match="unfolded"):
            export_resnet50_onnx(folded, str(tmp_path / "f.onnx"))


class TestRegistry:
    def test_onnx_path_loads(self, flax_tower, caplog):
        _, path = flax_tower
        cfg = EmbedConfig(onnx_path=str(path), num_classes=CLASSES,
                          dtype="float32", norm_dtype="float32",
                          batch_size=4)
        with caplog.at_level(logging.INFO):
            emb = create_embedder(cfg, device="cpu")
        assert f"loaded ONNX weights from {path}" in caplog.text
        assert emb.weights_loaded
        want = load_onnx_params(str(path), _port_model())
        got = emb.model.state_dict()
        assert all(torch.equal(got[k], want[k]) for k in want)
        # the JAX package's fingerprint of the same file, with torch-
        head, _, fp = jax_tag(cfg, 0).rpartition(":")
        assert emb.tag == f"{head}:torch-{fp}"
        imgs = np.random.default_rng(0).integers(
            0, 256, (3, 224, 224, 3)).astype(np.uint8)
        out = emb.embed(imgs)
        assert out.shape == (3, CLASSES) and np.isfinite(out).all()

    def test_missing_onnx_path_warns_and_runs_random_init(self, tmp_path,
                                                          caplog):
        missing = str(tmp_path / "nope.onnx")
        with caplog.at_level(logging.WARNING):
            emb = create_embedder(
                EmbedConfig(onnx_path=missing, num_classes=CLASSES),
                device="cpu")
        assert f"ONNX checkpoint {missing} not found" in caplog.text
        assert not emb.weights_loaded
        assert emb.tag == "resnet50:logits:torch-randominit-0"

    def test_int8_calibrates_the_loaded_weights(self, flax_tower):
        """int8 after an ONNX load quantizes the file's weights: kernel_q,
        w_scale and bias equal the JAX package's int8 tower built from the
        same file, and act_scale agrees at rtol 1e-5 (two float32
        calibration forwards on the same synthetic batch)."""
        from imageclust_tpu.models.registry import (
            create_embedder as jax_create,
        )
        from imageclust_tpu.config import EmbedConfig as JaxEmbedConfig

        _, path = flax_tower
        kw = dict(onnx_path=str(path), num_classes=CLASSES, quantize="int8",
                  batch_size=4)
        emb = create_embedder(EmbedConfig(**kw), device="cpu")
        q = jax.tree.map(np.asarray,
                         jax_create(JaxEmbedConfig(**kw)).variables)
        sd = emb.model.state_dict()
        for blk, convs in q.items():
            if not blk.startswith("stage"):
                continue
            for conv, p in convs.items():
                k = f"{blk}.{conv}"
                np.testing.assert_array_equal(
                    sd[f"{k}.kernel_q"].numpy(),
                    p["kernel_q"].transpose(3, 0, 1, 2))
                np.testing.assert_array_equal(sd[f"{k}.w_scale"].numpy(),
                                              p["w_scale"])
                np.testing.assert_array_equal(sd[f"{k}.bias"].numpy(),
                                              p["bias"])
                np.testing.assert_allclose(float(sd[f"{k}.act_scale"]),
                                           float(p["act_scale"]), rtol=1e-5)
        assert ":int8-absmax:torch-" in emb.tag


class TestCli:
    def test_models_matches_jax(self, capsys):
        assert jax_cli.main(["models"]) == 0
        theirs = capsys.readouterr().out
        assert cli.main(["models"]) == 0
        # the JAX package's towers, then the port's own
        assert capsys.readouterr().out == theirs + "siglip_so400m_384\n"
        assert "resnet50" in theirs and "siglip_so400m" in theirs

    def test_export_refuses_other_towers(self, capsys, monkeypatch):
        monkeypatch.setenv("IMAGECLUST_JAX_CACHE", "off")
        args = ["export", "--model", "vit_b32", "--out", "x.onnx"]
        assert jax_cli.main(args) == 2
        theirs = capsys.readouterr().err
        assert cli.main(args + ["--device", "cpu"]) == 2
        assert capsys.readouterr().err == theirs
        assert "supports resnet50" in theirs

    def test_export_matches_jax(self, flax_tower, tmp_path, capsys,
                                monkeypatch):
        """Both CLIs load the file through ``embed.onnx_path`` and write it
        back: byte-identical to it, and to each other, with the same
        JSON line."""
        monkeypatch.setenv("IMAGECLUST_JAX_CACHE", "off")
        _, path = flax_tower
        sets = ["--set", f"embed.onnx_path={path}",
                "--set", f"embed.num_classes={CLASSES}"]
        outs = []
        for main, name, extra in ((jax_cli.main, "jax", []),
                                  (cli.main, "port", ["--device", "cpu"])):
            out = tmp_path / f"{name}.onnx"
            assert main(["export", "--out", str(out), *sets, *extra]) == 0
            line = json.loads(capsys.readouterr().out)
            assert line == {"onnx": str(out), "num_classes": CLASSES}
            outs.append(_sha(out))
        assert outs == [_sha(path)] * 2
