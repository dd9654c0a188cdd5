"""The port's weight-parity gate (``imageclust_tpu_torch/verify.py`` and
``cli verify``) against the JAX package's, and the port's copy of the
reference oracle (``cluster/oracle.py``).

A full-width seeded ResNet50 exported by the port's own ONNX writer stands
in for the real ``resnet50-v1-7.onnx`` (absent from the repository), as
tests/test_verify_cmd.py does for the JAX package: both reports on the same
file must agree. The port runs on ``device="cpu"`` here;
tests/test_torch_cuda.py runs it on a card.
"""

import ast
import json
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from imageclust_tpu import cli as jax_cli
from imageclust_tpu import verify as jax_verify
from imageclust_tpu.cluster import oracle as jax_oracle
from imageclust_tpu.models import vit as jax_vit
from imageclust_tpu_torch import cli
from imageclust_tpu_torch import verify
from imageclust_tpu_torch.cluster import oracle
from imageclust_tpu_torch.models import vit

from test_torch_vit import _hf_state_dict, _flax_variables
from test_verify_cmd import TestVerifyClipText as _JaxClipText

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
_TINY_VIT = vit.ViTConfig(patch=8, width=32, depth=2, heads=4, proj_dim=16,
                          image_size=32)


@pytest.fixture(scope="module")
def rn50_onnx(tmp_path_factory):
    """A seeded full-width ResNet50 written by the port's exporter."""
    from imageclust_tpu_torch.models.onnx_export import export_resnet50_onnx
    from imageclust_tpu_torch.models.resnet50 import ResNet50V1

    model = ResNet50V1(dtype="float32", norm_dtype="float32").init_random(7)
    path = str(tmp_path_factory.mktemp("verify") / "rn50.onnx")
    export_resnet50_onnx(model, path)
    return path


@pytest.fixture()
def clip_text_npz(tmp_path):
    """A toy HF-layout CLIPTextModel npz (tests/test_verify_cmd.py's)."""
    return _JaxClipText()._npz(tmp_path)


@pytest.fixture()
def tiny_vit_b32(monkeypatch):
    """``vit_b32`` cut to a tiny tower in both packages, so ``verify
    --clip`` runs in seconds."""
    monkeypatch.setitem(vit.VIT_CONFIGS, "vit_b32", _TINY_VIT)
    monkeypatch.setitem(jax_vit.VIT_CONFIGS, "vit_b32",
                        jax_vit.ViTConfig(**{
                            f: getattr(_TINY_VIT, f) for f in
                            jax_vit.ViTConfig.__dataclass_fields__}))


def _run_cli(main, args, capsys):
    rc = main(args)
    out = capsys.readouterr().out
    verdict = out.strip().splitlines()[-1]
    report = json.loads(out[:out.rindex("VERDICT")])
    return rc, verdict, report


class TestVerifyOnnx:
    def test_report_agrees_with_jax(self, rn50_onnx):
        got = verify.verify_onnx(rn50_onnx, sample=6, device="cpu")
        want = jax_verify.verify_onnx(rn50_onnx, sample=6)
        assert got["ok"] is want["ok"] is True
        assert got["checks"]["ingest"] == want["checks"]["ingest"] == "ok"
        assert (got["checks"]["assignments_equal"]
                is want["checks"]["assignments_equal"] is True)
        assert got["checks"]["cosine_min"] > verify.COSINE_GATE
        assert want["checks"]["cosine_min"] > jax_verify.COSINE_GATE
        assert got["checks"]["cosine_gate"] == want["checks"]["cosine_gate"]
        assert set(got["checks"]) == set(want["checks"])
        assert got["checks"]["max_rel_err"] < 1e-4

    def test_real_images_fixture(self, rn50_onnx, tmp_path, rng):
        d = tmp_path / "imgs"
        d.mkdir()
        for i in range(4):
            img = rng.integers(0, 255, (64, 80, 3), np.uint8)
            cv2.imwrite(str(d / f"im{i}.png"), img)
        got = verify.verify_onnx(rn50_onnx, images_dir=str(d), sample=4,
                                 device="cpu")
        want = jax_verify.verify_onnx(rn50_onnx, images_dir=str(d), sample=4)
        assert got["ok"] is want["ok"] is True
        assert got["checks"]["assignments_equal"] is True

    def test_empty_images_dir_raises(self, rn50_onnx, tmp_path):
        for fn, kw in ((verify.verify_onnx, {"device": "cpu"}),
                       (jax_verify.verify_onnx, {})):
            with pytest.raises(ValueError, match="no images found"):
                fn(rn50_onnx, images_dir=str(tmp_path), **kw)

    def test_int8_leg(self, rn50_onnx):
        got = verify.verify_onnx(rn50_onnx, sample=4, quantize="int8",
                                 device="cpu")
        assert got["checks"]["int8_cosine_min"] > verify.INT8_GATE
        assert got["checks"]["int8_ok"] is True and got["ok"] is True
        assert got["checks"]["int8_gate"] == jax_verify.INT8_GATE

    def test_without_cv2_fails_structurally(self, rn50_onnx, monkeypatch,
                                            capsys):
        """The card's machine has no cv2: the gate has no reference
        runtime there, and says so (exit 2, the error names cv2)."""
        monkeypatch.setitem(sys.modules, "cv2", None)
        rc, verdict, report = _run_cli(
            cli.main, ["verify", "--onnx", rn50_onnx, "--device", "cpu"],
            capsys)
        assert rc == 2 and verdict == "VERDICT: FAIL (structural)"
        assert report["ok"] is False and "cv2" in report["error"]

    def test_wrong_shapes_fail_structurally(self, tmp_path, capsys):
        """An export of another ResNet (fewer blocks) fails the converter's
        shape check in both packages."""
        from imageclust_tpu_torch.models.onnx_export import (
            export_resnet50_onnx,
        )
        from imageclust_tpu_torch.models.resnet50 import ResNet50V1

        path = str(tmp_path / "small.onnx")
        export_resnet50_onnx(ResNet50V1(stage_layers=(1, 1, 1, 1),
                                        num_classes=8).init_random(0), path)
        got = _run_cli(cli.main, ["verify", "--onnx", path, "--device",
                                  "cpu"], capsys)
        want = _run_cli(jax_cli.main, ["verify", "--onnx", path], capsys)
        assert got[:2] == want[:2] == (2, "VERDICT: FAIL (structural)")
        assert "missing initializer" in got[2]["error"]


class TestCliExitCodes:
    """``cli verify`` exits 0 (PASS), 1 (FAIL) or 2 (structural) as the
    JAX CLI does on the same arguments."""

    @pytest.mark.parametrize("case", ["pass_onnx", "garbage", "nothing",
                                      "clip_not_ingested", "clip_ingested",
                                      "clip_missing", "clip_text_pass",
                                      "clip_text_missing", "clip_text_bpe"])
    def test_same_exit_code_and_verdict(self, case, rn50_onnx, tmp_path,
                                        capsys, tiny_vit_b32, clip_text_npz):
        garbage = tmp_path / "bad.onnx"
        garbage.write_bytes(b"not an onnx file")
        unloadable = tmp_path / "clip.ckpt"
        unloadable.write_bytes(b"\x00" * 16)
        sd = _hf_state_dict(_TINY_VIT, _flax_variables(_TINY_VIT, seed=3))
        np.savez(tmp_path / "clip.npz", **sd)
        args = {
            "pass_onnx": ["--onnx", rn50_onnx, "--sample", "4"],
            "garbage": ["--onnx", str(garbage)],
            "nothing": [],
            "clip_not_ingested": ["--clip", str(unloadable)],
            "clip_ingested": ["--clip", str(tmp_path / "clip.npz")],
            "clip_missing": ["--clip", str(tmp_path / "absent.pt")],
            "clip_text_pass": ["--clip-text", clip_text_npz],
            "clip_text_missing": ["--clip-text", str(tmp_path / "no.pt")],
            "clip_text_bpe": ["--clip-text", clip_text_npz, "--bpe",
                              str(tmp_path / "absent_merges.txt")],
        }[case]
        got = _run_cli(cli.main, ["verify", *args, "--device", "cpu"], capsys)
        want = _run_cli(jax_cli.main, ["verify", *args], capsys)
        assert got[:2] == want[:2]
        expect = {"pass_onnx": 0, "clip_ingested": 0, "clip_text_pass": 0,
                  "clip_not_ingested": 1, "clip_text_bpe": 1}.get(case, 2)
        assert got[0] == expect
        if expect == 2:
            assert got[2]["error"] == want[2]["error"]
        else:
            assert set(got[2]) == set(want[2])
            for key, part in got[2].items():
                if key != "ok":
                    assert set(part["checks"]) == set(want[2][key]["checks"])
                    assert part["ok"] == want[2][key]["ok"]


class TestVerifyClipText:
    def test_report_equals_jax(self, clip_text_npz):
        got = verify.verify_clip_text(clip_text_npz, device="cpu")
        want = jax_verify.verify_clip_text(clip_text_npz)
        assert got == want
        assert got["ok"] and got["checks"]["text_dim"] == 12

    def test_missing_checkpoint_raises(self):
        with pytest.raises(ValueError, match="not found"):
            verify.verify_clip_text("/nonexistent/clip_text.pt",
                                    device="cpu")


class TestVerifyClip:
    def test_ingested_report_agrees_with_jax(self, tiny_vit_b32, tmp_path):
        sd = _hf_state_dict(_TINY_VIT, _flax_variables(_TINY_VIT, seed=5))
        path = str(tmp_path / "clip.npz")
        np.savez(path, **sd)
        got = verify.verify_clip(path, device="cpu")
        want = jax_verify.verify_clip(path)
        assert got == want
        assert got["ok"] and got["checks"]["image_dim"] == 16

    def test_unloadable_extension_fails_gate(self, tiny_vit_b32, tmp_path):
        p = tmp_path / "clip.ckpt"
        p.write_bytes(b"\x00" * 16)
        report = verify.verify_clip(str(p), device="cpu")
        assert report["checks"]["ingested"] is False
        assert report["ok"] is False

    def test_missing_checkpoint_raises(self):
        with pytest.raises(ValueError, match="not found"):
            verify.verify_clip("/nonexistent/clip.pt", device="cpu")


class TestRunVerify:
    def test_combined_report(self, rn50_onnx, clip_text_npz):
        ok, got = verify.run_verify(rn50_onnx, sample=4,
                                    clip_text=clip_text_npz, device="cpu")
        want_ok, want = jax_verify.run_verify(rn50_onnx, sample=4,
                                              clip_text=clip_text_npz)
        assert ok is want_ok is True
        assert set(got) == set(want) == {"resnet50", "clip_text", "ok"}
        assert got["clip_text"] == want["clip_text"]

    def test_nothing_requested(self):
        with pytest.raises(ValueError, match="nothing to verify"):
            verify.run_verify(None, device="cpu")

    def test_default_device_needs_cuda(self, clip_text_npz, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            verify.run_verify(None, clip_text=clip_text_npz)


class TestOracle:
    def test_module_equals_jax_below_the_docstring(self):
        """The port's oracle is the JAX module with only its docstring
        reworded: the code is the same, token for token."""
        def body(path):
            tree = ast.parse(path.read_text())
            tree.body = tree.body[1:]  # the module docstring
            return ast.dump(tree)

        port = ROOT / "imageclust_tpu_torch" / "cluster" / "oracle.py"
        jax_file = ROOT / "imageclust_tpu" / "cluster" / "oracle.py"
        assert body(port) == body(jax_file)
        head = port.read_text().split('"""')[2]
        assert head == jax_file.read_text().split('"""')[2]

    @pytest.mark.parametrize("n,d,lo,hi,seed", [(30, 4, 3, 6, 0),
                                                (41, 8, 2, 5, 1),
                                                (25, 2, 3, 4, 2)])
    def test_same_result_on_seeded_input(self, n, d, lo, hi, seed):
        x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
        ids = [f"img{i}" for i in range(n)]
        got = oracle.perform_clustering_with_constraints(x, ids, lo, hi)
        want = jax_oracle.perform_clustering_with_constraints(x, ids, lo, hi)
        assert got[1] is True and repr(got) == repr(want)
        assert oracle.calculate_optimal_clusters(n, lo, hi) == (
            jax_oracle.calculate_optimal_clusters(n, lo, hi))

    def test_port_engine_agrees_with_its_oracle(self):
        """What the oracle is for: the port's exact engine gives the
        oracle's partition on an integer grid."""
        from imageclust_tpu_torch.cluster import constrained_ward

        x = np.random.default_rng(3).integers(-4, 5, (24, 3)).astype(
            np.float32)
        ids = [f"img{i}" for i in range(len(x))]
        res = constrained_ward(x, ids, min_size=3, max_size=6, device="cpu")
        clusters, ok = oracle.perform_clustering_with_constraints(x, ids, 3,
                                                                  6)
        assert ok
        assert {frozenset(c) for c in clusters.values()} == {
            frozenset(m) for m in res.cluster_map.values()}
