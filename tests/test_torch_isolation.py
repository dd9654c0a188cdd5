"""The PyTorch port stands alone: no JAX, no Flax, no optax, Orbax or
tensorstore, no ``requests``, nothing of the JAX package, anywhere in
``imageclust_tpu_torch/`` or ``chip_smoke.py``."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "imageclust_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
             "imageclust_tpu", "requests")

torch.set_num_threads(1)


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
                "cluster/ward.py", "cluster/sharded.py",
                "ops/merge_kernels.py", "ops/bucket_kernels.py",
                "ops/_build.py", "ops/attention.py",
                "models/resnet50.py", "models/convert.py", "models/vit.py",
                "models/registry.py", "models/onnx_io.py",
                "models/onnx_export.py", "models/quantize.py",
                "models/quantize_vit.py", "ops/int8.py", "service/app.py",
                "data/loader.py", "models/text.py", "models/tokenizer.py",
                "labels/zero_shot.py", "labels/text_fusion.py",
                "cluster/chain.py", "cluster/agreement.py",
                "cluster/quality.py", "utils/orbax_io.py",
                "utils/checkpoint.py", "models/train.py",
                "models/finetune.py", "core/mesh.py", "core/collectives.py",
                "parallel/__init__.py", "parallel/_worker.py",
                "utils/aws.py", "labels/rekognition.py", "naming/bedrock.py",
                "naming/openai_backend.py", "cluster/oracle.py",
                "verify.py", "bench.py"):
        assert mod in names
    for src in ("merge_update_argmin.cu", "merge_update_argmin_batched.cu",
                "merge_loop_whole.cu", "short_seq_attention.cu",
                "bn_act.cu", "lexmin.cuh"):
        assert (PORT / "csrc" / src).exists()


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_imports(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_regex_or_cv2_at_import(path):
    """The card's machine has no ``regex`` (CLIP's tokenizer needs it in
    the JAX package) and no cv2: no module imports the first at all, and
    none imports cv2 at module level."""
    assert "regex" not in {m.split(".")[0] for m in _imports(path)}
    tree = ast.parse(path.read_text(), str(path))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    names = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module.split(".")[0] for n in top
              if isinstance(n, ast.ImportFrom) and n.module}
    assert "cv2" not in names


def _python(code: str, cwd, env=None) -> subprocess.CompletedProcess:
    """``code`` in a fresh interpreter with one OpenMP thread."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               **(env or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, env=env,
                          timeout=300)


# What a clean interpreter has loaded after importing each group of the
# port's modules (the text side, then the cloud side, then the kernel
# modules, whose import must build nothing): one interpreter for the three
# tests that read it.
_IMPORTS = (
    "import json, sys\n"
    "def loaded(*names):\n"
    "    return sorted(m for m in names if m in sys.modules)\n"
    "seen = {}\n"
    "from imageclust_tpu_torch.models import text, tokenizer\n"
    "from imageclust_tpu_torch.labels import zero_shot, text_fusion\n"
    "from imageclust_tpu_torch import pipeline, cli\n"
    "seen['text'] = loaded('cv2', 'regex', 'PIL')\n"
    "from imageclust_tpu_torch.utils import aws\n"
    "from imageclust_tpu_torch.labels import rekognition\n"
    "from imageclust_tpu_torch.naming import bedrock, "
    "openai_backend, registry\n"
    "from imageclust_tpu_torch.cluster import oracle\n"
    "from imageclust_tpu_torch import verify\n"
    "seen['cloud'] = loaded('cv2', 'requests', 'jax', 'PIL')\n"
    "import imageclust_tpu_torch.ops.merge_kernels as mk, "
    "imageclust_tpu_torch.ops.bucket_kernels as bk, "
    "imageclust_tpu_torch.ops.attention as at, "
    "imageclust_tpu_torch.ops.bn_act as ba, "
    "imageclust_tpu_torch.models.vit as vit, "
    "imageclust_tpu_torch.cluster.sharded as sh, "
    "imageclust_tpu_torch.ops._build as b\n"
    "seen['lazy'] = b._lib is None and b.build_info() == {}\n"
    "seen['sources'] = str(b.SOURCES)\n"
    "print(json.dumps(seen))"
)


@pytest.fixture(scope="module")
def clean_imports():
    proc = _python(_IMPORTS, ROOT)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


# Bodies that run with modules absent (``sys.modules[m] = None``), each
# printing what its test reads. They share one interpreter, in which every
# module that any of them blocks is absent for all of them, and one work
# directory; each body runs in a namespace of its own, and the fine-tune,
# which replaces ``registry.ResNet50V1``, runs last.
_TEXT_SIDE = (
    "import sys\n"
    "for m in ('regex', 'cv2', 'PIL', 'jax', 'flax', 'imageclust_tpu'):\n"
    "    sys.modules[m] = None\n"
    "import numpy as np, torch\n"
    "torch.set_num_threads(1)\n"
    "from imageclust_tpu_torch.models import text, tokenizer\n"
    "from imageclust_tpu_torch.labels import zero_shot, text_fusion\n"
    "from imageclust_tpu_torch import pipeline, cli\n"
    "open('m.txt', 'w').write('#version: x\\nh e\\nhe llo</w>\\n')\n"
    "t = tokenizer.BPETokenizer('m.txt', context=16)\n"
    "assert t.decode(t.encode_text('Hello, W\\u00d6RLD')) == 'hello , w\\u00f6rld'\n"
    "enc = text.TextEncoder(text.TextConfig(vocab=64, width=16, depth=1,"
    " heads=2, proj_dim=8, context=8, eot_id=2), bpe_path='absent',"
    " device='cpu')\n"
    "assert enc.encode(['a', 'b c']).shape == (2, 8)\n"
    "class E:\n"
    "    spec = type('s', (), {'dim': 8})\n"
    "    device = torch.device('cpu')\n"
    "zs = zero_shot.ZeroShotLabeler.from_texts(['x', 'y'], E(), enc)\n"
    "print(len(zs.labels_from_embeddings(torch.ones(3, 8), 2, 0.0)))\n"
    "assert 'cv2' not in sys.modules or sys.modules['cv2'] is None\n"
)

_CLUSTER = (
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
    "from imageclust_tpu_torch.cluster import constrained_ward_bucketed\n"
    "y = np.random.default_rng(1).normal(size=(300, 4))"
    ".astype(np.float32)\n"
    "b = constrained_ward_bucketed(y, bucket_size=64, device='cpu')\n"
    "assert sum(len(m) for m in b.cluster_map.values()) "
    "+ len(b.dropped) == 300\n"
    "from imageclust_tpu_torch.cluster import constrained_ward_chain\n"
    "from imageclust_tpu_torch.cluster.agreement import agreement\n"
    "from imageclust_tpu_torch.cluster import quality\n"
    "c = constrained_ward_chain(y[:120], device='cpu')\n"
    "assert agreement(c.assignments(), c.assignments())['ari'] == 1.0\n"
    "from imageclust_tpu_torch.models.vit import ViTConfig, "
    "VisionTransformer\n"
    "m = VisionTransformer(ViTConfig(patch=8, width=32, depth=1, "
    "heads=4, proj_dim=8, image_size=16)).init_random(0)\n"
    "assert m(torch.zeros(2, 16, 16, 3)).shape == (2, 8)\n"
    "from imageclust_tpu_torch.models.quantize_vit import quantize_vit\n"
    "qm = quantize_vit(m, np.ones((2, 16, 16, 3), np.float32))\n"
    "assert qm(torch.zeros(2, 16, 16, 3)).shape == (2, 8)\n"
    "from imageclust_tpu_torch.models import onnx_export, quantize\n"
)

_CLOUD = (
    "import sys, json, io, contextlib\n"
    "for m in ('jax', 'jaxlib', 'flax', 'imageclust_tpu', 'cv2', "
    "'PIL', 'requests'):\n"
    "    sys.modules[m] = None\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from imageclust_tpu_torch.utils import aws\n"
    "from imageclust_tpu_torch.labels import rekognition\n"
    "from imageclust_tpu_torch.naming import bedrock, openai_backend\n"
    "from imageclust_tpu_torch.cluster import oracle\n"
    "from imageclust_tpu_torch import verify, cli\n"
    "sent = []\n"
    "def stub(method, url, body, headers, timeout):\n"
    "    sent.append(url)\n"
    "    t = json.dumps({'title': 'T', 'catchy_phrase': 'P'})\n"
    "    if 'rekognition' in url:\n"
    "        return 200, b'{\"Labels\": [{\"Name\": \"Cat\", "
    "\"Confidence\": 90}]}'\n"
    "    if 'openai' in url:\n"
    "        return 200, json.dumps({'choices': [{'message': "
    "{'content': t}}]}).encode()\n"
    "    return 200, json.dumps({'content': [{'text': t}]}).encode()\n"
    "aws.http_request = stub\n"
    "creds = aws.AwsCredentials('A', 'S')\n"
    "labels = rekognition.RekognitionLabeler(creds=creds)"
    ".detect_labels(b'x' * 10, 5, 1.0)\n"
    "assert [(l.name, l.confidence) for l in labels] == [('Cat', 90.0)]\n"
    "assert bedrock.ClaudeBedrockNamer(creds=creds).generate('c', 1)"
    " == ('T', 'P')\n"
    "import os\n"
    "os.environ['OPENAI_API_KEY'] = 'k'\n"
    "assert openai_backend.OpenAINamer().generate('c', 1) == "
    "('T', 'P')\n"
    "try:\n"
    "    rekognition.shrink_to_payload_limit(b'x' * 10, 5)\n"
    "except ValueError as e:\n"
    "    assert 'cv2' in str(e)\n"
    "else:\n"
    "    raise AssertionError('no error')\n"
    "out = io.StringIO()\n"
    "with contextlib.redirect_stdout(out):\n"
    "    rc = cli.main(['verify', '--onnx', 'absent.onnx', '--device', "
    "'cpu'])\n"
    "assert rc == 2 and 'cv2' in out.getvalue(), out.getvalue()\n"
    "print(len(sent), sorted(m for m in ('cv2', 'requests', 'jax') "
    "if sys.modules.get(m) is not None))\n"
)

_FINETUNE = (
    "import sys, os, json\n"
    "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
    "'tensorstore', 'imageclust_tpu', 'cv2', 'PIL'):\n"
    "    sys.modules[m] = None\n"
    "import numpy as np, torch\n"
    "torch.set_num_threads(1)\n"
    "from imageclust_tpu_torch.models import finetune, registry\n"
    "from imageclust_tpu_torch.models.resnet50 import ResNet50V1\n"
    "from imageclust_tpu_torch.config import EmbedConfig\n"
    "rng = np.random.default_rng(0)\n"
    "def bmp(img):\n"
    "    h, w, _ = img.shape\n"
    "    row = (w * 3 + 3) & ~3\n"
    "    body = b''.join(img[y].tobytes().ljust(row, b'\\0') "
    "for y in range(h - 1, -1, -1))\n"
    "    import struct\n"
    "    return (b'BM' + struct.pack('<IHHI', 54 + len(body), 0, 0, 54)"
    " + struct.pack('<IiiHHIIiiII', 40, w, h, 1, 24, 0, len(body), "
    "0, 0, 0, 0) + body)\n"
    "for c, col in (('a', (0, 0, 200)), ('b', (0, 200, 0))):\n"
    "    os.makedirs('d/' + c)\n"
    "    for i in range(4):\n"
    "        img = np.full((32, 32, 3), col, np.uint8)\n"
    "        open(f'd/{c}/{i}.bmp', 'wb').write(bmp(img))\n"
    "model, classes, loss = finetune.finetune_resnet50("
    "'d', 'ck/emb', epochs=1, batch_size=4, stage_layers=(1, 1, 1, 1),"
    " input_size=32, device='cpu')\n"
    "class Small(ResNet50V1):\n"
    "    def __init__(self, *a, **k):\n"
    "        super().__init__(*a, stage_layers=(1, 1, 1, 1), **k)\n"
    "registry.ResNet50V1 = Small\n"
    "emb = registry.create_embedder(EmbedConfig("
    "checkpoint_path='ck/emb', num_classes=2), device='cpu')\n"
    "assert emb.weights_loaded and ':torch-ckpt-' in emb.tag\n"
    "for k, v in model.state_dict().items():\n"
    "    assert torch.equal(emb.model.state_dict()[k], v), k\n"
    "print(classes, sorted(m for m in ('cv2', 'PIL', 'jax', 'orbax') "
    "if sys.modules.get(m) is not None))\n"
)

_ABSENT = ("regex", "cv2", "PIL", "jax", "jaxlib", "flax", "optax", "orbax",
           "tensorstore", "imageclust_tpu", "aiohttp", "yaml", "requests")
_RUN_BODIES = (
    "import contextlib, io, json, sys, traceback\n"
    f"for m in {_ABSENT!r}:\n"
    "    sys.modules[m] = None\n"
    "res = {}\n"
    "for name, code in json.load(open('bodies.json')):\n"
    "    out = io.StringIO()\n"
    "    try:\n"
    "        with contextlib.redirect_stdout(out):\n"
    "            exec(compile(code, name, 'exec'), {'__name__': name})\n"
    "        res[name] = {'ok': True, 'out': out.getvalue()}\n"
    "    except Exception:\n"
    "        res[name] = {'ok': False, 'out': out.getvalue(),\n"
    "                     'err': traceback.format_exc()}\n"
    "print(json.dumps(res))"
)


@pytest.fixture(scope="module")
def absent_runs(tmp_path_factory):
    wd = tmp_path_factory.mktemp("absent")
    (wd / "bodies.json").write_text(json.dumps([
        ("text_side", _TEXT_SIDE), ("cluster", _CLUSTER),
        ("cloud", _CLOUD), ("finetune", _FINETUNE)]))
    proc = _python(_RUN_BODIES, wd)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _body(runs, name) -> str:
    r = runs[name]
    assert r["ok"], r["err"]
    return r["out"]


def test_text_side_without_regex_or_cv2(absent_runs):
    """The tokenizer, text tower, zero-shot labeler and text fusion import
    and run with ``regex``, cv2, PIL and JAX absent, and pull in no cv2."""
    assert _body(absent_runs, "text_side").split() == ["3"]


def test_text_side_imports_no_cv2(clean_imports):
    assert clean_imports["text"] == []


def test_import_and_cluster_without_jax(absent_runs):
    clusters, merges = map(int, _body(absent_runs, "cluster").split())
    assert merges == 20 - 5 and clusters >= 1  # target 5 under (3, 6)


def test_finetune_and_serve_checkpoint_without_jax(absent_runs):
    """A tiny fine-tune on BMPs, its Orbax checkpoint restored through
    ``embed.checkpoint_path``, with JAX, Orbax, tensorstore, cv2 and PIL
    absent."""
    assert _body(absent_runs, "finetune").strip() == "['a', 'b'] []"


def test_cloud_backends_and_verify_without_jax_requests_or_cv2(absent_runs):
    """The SigV4 client, Rekognition, Bedrock, OpenAI, the oracle and
    ``verify`` import and run with JAX, ``requests`` and cv2 absent: the
    cloud calls through a stub at the transport's one seam, an under-limit
    image passes the shrink untouched, an over-limit one names cv2, and
    ``cli verify --onnx`` fails structurally (exit 2) naming cv2."""
    assert _body(absent_runs, "cloud").strip() == "3 []"


def test_cloud_modules_import_no_cv2_or_requests(clean_imports):
    assert clean_imports["cloud"] == []


def test_mesh_ranks_run_without_jax():
    """Two gloo ranks run the collectives, the mesh bucketed engine and
    import the mesh pipeline, chain and fine-tune with no JAX module in
    their interpreters."""
    from imageclust_tpu_torch.parallel import launch_processes

    outs = launch_processes("tests.test_torch_mesh_targets:no_jax", 2,
                            timeout=110.0)
    assert all("no jax ok" in o for o in outs)


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


def test_resolve_device_turns_bf16_reduced_precision_off():
    """cuBLAS may reduce bf16 products partly in bf16 unless told not to;
    XLA accumulates the towers' bf16 Dense layers in float32."""
    from imageclust_tpu_torch.device import resolve_device

    matmul = torch.backends.cuda.matmul
    matmul.allow_bf16_reduced_precision_reduction = True
    resolve_device("cpu")
    assert matmul.allow_bf16_reduced_precision_reduction is False


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a card, and outside a checkout, chip_smoke.py exits non-zero
    and prints no result line."""
    for where, args in ((ROOT, []), (tmp_path, []), (ROOT, ["--phases", "11"]),
                        (ROOT, ["--bogus"])):
        script = where / "chip_smoke.py"
        if where is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        proc = subprocess.run([sys.executable, str(script), *args], cwd=where,
                              capture_output=True, text=True,
                              env=dict(os.environ, CUDA_VISIBLE_DEVICES="",
                                       OMP_NUM_THREADS="1"),
                              timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout and '"phase"' not in proc.stdout


def test_kernel_build_is_lazy(clean_imports):
    """Importing the kernel modules builds nothing and needs no nvcc."""
    assert clean_imports["lazy"] is True
    for src in ("merge_update_argmin.cu", "merge_update_argmin_batched.cu",
                "merge_loop_whole.cu", "short_seq_attention.cu",
                "bn_act.cu"):
        assert src in clean_imports["sources"]
