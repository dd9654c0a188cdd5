"""The PyTorch port stands alone: no JAX, no Flax, nothing of the JAX
package, anywhere in ``imageclust_tpu_torch/`` or ``chip_smoke.py``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "imageclust_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "imageclust_tpu")

torch.set_num_threads(2)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_has_modules():
    names = {p.relative_to(PORT).as_posix() for p in PORT.rglob("*.py")}
    for mod in ("device.py", "config.py", "pipeline.py", "cli.py",
                "cluster/ward.py", "ops/merge_kernels.py", "ops/_build.py",
                "models/resnet50.py", "models/convert.py",
                "models/registry.py", "service/app.py", "data/loader.py"):
        assert mod in names
    assert (PORT / "csrc" / "merge_update_argmin.cu").exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_and_cluster_without_jax(tmp_path):
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'flax', 'imageclust_tpu', 'cv2', "
        "'PIL', 'aiohttp', 'yaml'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np, torch\n"
        "torch.set_num_threads(1)\n"
        "import imageclust_tpu_torch\n"
        "from imageclust_tpu_torch import cli, pipeline\n"
        "from imageclust_tpu_torch.service import app\n"
        "from imageclust_tpu_torch.cluster import constrained_ward\n"
        "x = np.random.default_rng(0).integers(-3, 4, (20, 4))"
        ".astype(np.float32)\n"
        "r = constrained_ward(x, min_size=3, max_size=6, device='cpu')\n"
        "print(r.n_clusters, len(r.merges))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    clusters, merges = map(int, proc.stdout.split())
    assert merges == 20 - 5 and clusters >= 1  # target 5 under (3, 6)


def test_resolve_device_raises_without_cuda(monkeypatch):
    from imageclust_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_resolve_device_turns_tf32_off():
    from imageclust_tpu_torch.device import resolve_device

    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card, and outside a checkout, chip_smoke.py exits non-zero
    and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    for where in (ROOT, tmp_path):
        script = where / "chip_smoke.py"
        if where is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script)], cwd=where,
                              capture_output=True, text=True, env=env,
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_kernel_build_is_lazy():
    """Importing the kernel modules builds nothing and needs no nvcc."""
    code = ("import imageclust_tpu_torch.ops.merge_kernels as mk, "
            "imageclust_tpu_torch.ops._build as b\n"
            "assert b._lib is None and b.build_info() == {}\n"
            "print(b.SOURCES)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "merge_update_argmin.cu" in proc.stdout
