"""The port does all the JAX package does: every public name of every JAX
module has a counterpart in the port.

Both packages are parsed with ``ast``; neither is imported. A JAX module's
public names are its module-level functions, classes and assignments that
do not start with ``_``, the names in its ``__all__``, and each public
class's public methods (``__call__`` included: a Flax module's forward).
Each must be defined, assigned or imported under the same name in the
port's module of the same path, or be listed in :data:`RENAMED` (the
port's name, which must exist, private names allowed), or in
:data:`NOT_PORTED` with its reason. :data:`NOT_PORTED` is the one list of
what the port leaves out on purpose; it may also name private JAX names
that carry a whole code path.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX = ROOT / "imageclust_tpu"
PORT = ROOT / "imageclust_tpu_torch"

# "jax module:name" -> "port module:name"
RENAMED = {
    "models/vit.py:load_clip_vision_torch":
        "models/vit.py:load_clip_vision_state_dict",
    "models/text.py:load_clip_text_torch":
        "models/text.py:load_clip_text_state_dict",
    "service/app.py:create_app": "service/app.py:create_server",
    # a package's re-exports: the port's packages re-export nothing
    "core/__init__.py:create_mesh": "core/mesh.py:create_mesh",
    "data/__init__.py:decode_images": "data/loader.py:decode_images",
    "data/__init__.py:load_image_dir": "data/loader.py:load_image_dir",
    "data/__init__.py:sanitize_filename": "data/loader.py:sanitize_filename",
    "ops/__init__.py:preprocess_batch": "ops/preprocess.py:preprocess_batch",
    "ops/__init__.py:resize_bilinear": "ops/preprocess.py:resize_bilinear",
    "ops/__init__.py:resize_weights": "ops/preprocess.py:resize_weights",
    "ops/__init__.py:merge_update_argmin":
        "ops/merge_kernels.py:merge_update_argmin",
    "service/__init__.py:create_app": "service/app.py:create_server",
    "service/__init__.py:run_server": "service/app.py:run_server",
    "service/__init__.py:JobStore": "service/jobs.py:JobStore",
    # the handler sets the same CORS headers on every reply
    "service/app.py:cors_middleware": "service/app.py:_CORS",
    "models/quantize.py:quant_apply":
        "models/quantize.py:QuantResNet50.forward",
    "models/quantize_vit.py:vit_quant_apply":
        "models/quantize_vit.py:QuantViT.forward",
    # a Flax module's __call__ is a torch module's forward
    "models/resnet50.py:ResNet50V1.__call__":
        "models/resnet50.py:ResNet50V1.forward",
    "models/resnet50.py:BottleneckV1.__call__":
        "models/resnet50.py:BottleneckV1.forward",
    "models/text.py:TextBlock.__call__": "models/text.py:TextBlock.forward",
    "models/text.py:TextTransformer.__call__":
        "models/text.py:TextTransformer.forward",
    "models/vit.py:EncoderBlock.__call__": "models/vit.py:EncoderBlock.forward",
    "models/vit.py:VisionTransformer.__call__":
        "models/vit.py:VisionTransformer.forward",
    # the Pallas kernels: each wrapper launches its Hopper kernel
    "ops/pallas_kernels.py:merge_update_argmin":
        "ops/merge_kernels.py:merge_update_argmin",
    "ops/pallas_kernels.py:merge_update_argmin_batched":
        "ops/merge_kernels.py:merge_update_argmin_batched",
    "ops/pallas_kernels.py:merge_loop_whole":
        "ops/bucket_kernels.py:merge_loop_whole",
    "ops/pallas_kernels.py:pref_topk_block":
        "ops/pref_kernels.py:pref_topk_block",
    # plain XLA in the JAX package: its plain twin
    "ops/pallas_kernels.py:masked_argmin_pair_xla":
        "ops/merge_kernels.py:masked_argmin_pair_plain",
    "ops/__init__.py:masked_argmin_pair_xla":
        "ops/merge_kernels.py:masked_argmin_pair_plain",
}

# "jax module:name" -> why the port has none
NOT_PORTED = {
    "core/mesh.py:data_sharding":
        "a jax.sharding.NamedSharding helper; the port moves rows with "
        "local_rows and ShardedRows",
    "core/mesh.py:replicated": "a NamedSharding helper, as data_sharding",
    "core/__init__.py:data_sharding": "the re-export of core/mesh.py's",
    "core/__init__.py:replicated": "the re-export of core/mesh.py's",
    "parallel/__init__.py:data_sharding": "the re-export of core/mesh.py's",
    "parallel/__init__.py:replicated": "the re-export of core/mesh.py's",
    "models/train.py:TrainState":
        "a flax.struct dataclass; the port's step carries the module and "
        "init_opt_state's tuple",
    "utils/compile_cache.py:enable_compile_cache":
        "XLA's persistent compile cache; the port's kernels build into a "
        "cache keyed by their source's hash (ops/_build.py)",
    # IMAGECLUST_DEVICE_PLACE: capacity repair's spill placement by
    # deferred acceptance on the device. Its exact prefix ends at the first
    # spill item whose preference list runs out, and on the card's 100k
    # and 1.6M jobs almost none of the spill items came before that point,
    # so the preference rows crossed all the same and repair was no faster
    "cluster/sharded.py:_device_spill_place":
        "the switch's placement; it saved no bytes on the card's jobs",
    "cluster/sharded.py:_use_device_place": "reads the switch",
    "cluster/sharded.py:_DP_CHUNK": "the placement's chunk width",
}


def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _is_public(name: str) -> bool:
    return not name.startswith("_")


def jax_public(path: Path) -> set[str]:
    """The public names of a JAX module."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and _is_public(node.name):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{f.name}" for f in node.body
                        if isinstance(f, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                        and (_is_public(f.name) or f.name == "__call__")}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if not isinstance(t, ast.Name):
                    continue
                if t.id == "__all__":
                    out |= {e.value for e in node.value.elts}
                elif _is_public(t.id):
                    out.add(t.id)
    return out


def port_defined(path: Path) -> set[str]:
    """Every name a module defines, assigns, imports or lists in
    ``__all__``, private ones too, and every method as ``Class.method``."""
    if not path.exists():
        return set()
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{f.name}" for f in node.body
                        if isinstance(f, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                if isinstance(t, ast.Name):
                    out.add(t.id)
                    if t.id == "__all__":
                        out |= {e.value for e in node.value.elts}
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out |= {a.asname or a.name.split(".")[0] for a in node.names}
    return out


MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _unaccounted(rel: str) -> list[str]:
    have = port_defined(PORT / rel)
    return sorted(name for name in jax_public(JAX / rel)
                  if name not in have and f"{rel}:{name}" not in RENAMED
                  and f"{rel}:{name}" not in NOT_PORTED)


@pytest.mark.parametrize("rel", MODULES)
def test_every_public_name_has_a_counterpart(rel):
    assert _unaccounted(rel) == [], (
        f"{rel}: public JAX names with no counterpart in "
        f"imageclust_tpu_torch/{rel}, RENAMED or NOT_PORTED")


@pytest.mark.parametrize("entry", sorted(RENAMED))
def test_renamed_entry_is_live(entry):
    """A rename names a public JAX name the port lacks under that name, and
    a port name that exists."""
    rel, name = entry.split(":")
    assert name in jax_public(JAX / rel)
    assert name not in port_defined(PORT / rel)
    prel, pname = RENAMED[entry].split(":")
    assert pname in port_defined(PORT / prel), RENAMED[entry]


@pytest.mark.parametrize("entry", sorted(NOT_PORTED))
def test_not_ported_entry_is_live(entry):
    rel, name = entry.split(":")
    assert name in port_defined(JAX / rel)
    assert name not in port_defined(PORT / rel)
    assert NOT_PORTED[entry]  # a reason


def test_the_survey_sees_both_packages():
    """The parse is not vacuous: it finds the engine and
    ``Embedder.embed_blob`` in both packages."""
    assert len(MODULES) > 50
    for pkg in (JAX, PORT):
        assert "constrained_ward_bucketed" in port_defined(
            pkg / "cluster/sharded.py")
    assert "Embedder.embed_blob" in jax_public(JAX / "models/registry.py")
    assert "Embedder.embed_blob" in port_defined(PORT
                                                 / "models/registry.py")
