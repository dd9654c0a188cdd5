"""Nothing under benchmark/ imports JAX or the JAX package, and the plain
references import nothing of the program: top-level module names compared
whole (``imageclust_tpu_torch`` begins with ``imageclust_tpu``)."""

from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "imageclust_tpu"}


def _top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(ROOT.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _top_names(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = _top_names(path)
    assert "imageclust_tpu_torch" not in names
    assert names <= {"__future__", "contextlib", "dataclasses", "torch",
                     "benchmark"}


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "imageclust_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "imageclust_tpu.fake", object())
    assert run.forbidden_modules() == ["imageclust_tpu"]
