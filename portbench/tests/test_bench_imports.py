"""Nothing in ``portbench/`` imports JAX, Flax, optax or the JAX package, and
the plain reference imports nothing of the program. Top-level module names
are compared whole (the part before the first dot): ``flexynesis_torch``
is not ``flexynesis_tpu``."""

from __future__ import annotations

import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "flexynesis_tpu"}
FILES = sorted((ROOT / "portbench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "flexynesis_torch" not in top_level_imports(path)
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):   # relative imports stay inside reference/
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1


def test_whole_name_comparison():
    assert "flexynesis_torch".split(".")[0] not in FORBIDDEN
    assert "jax.numpy".split(".")[0] in FORBIDDEN


def test_run_refuses_jax_modules(monkeypatch):
    import sys
    import types

    from portbench import core

    assert core.forbidden_modules() == [] or "jax" in sys.modules
    monkeypatch.setitem(sys.modules, "flexynesis_tpu.ops", types.ModuleType("x"))
    assert "flexynesis_tpu" in core.forbidden_modules()
