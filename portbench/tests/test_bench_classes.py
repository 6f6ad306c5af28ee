"""A model class is reached through its module alone: ``classes/<model_class>.py``,
found by the configuration's ``model_class``. Every configuration's module is
there and complete, a missing one fails when the cell loads and names the
file to add, a new one is found without an edit to any other file, and no
other file of the harness names a model class or imports a model of the
port."""

from __future__ import annotations

import ast
import copy
import json
import re

import pytest

from conftest import ROOT

from portbench import core

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
# what every class module gives; ``core.CLASS_NAMES`` may add to it, never less
TABLE = ("dataset", "canon", "widths", "rows_of", "keep_width", "init_law", "matmul_shapes",
         "noise_sites", "train_loss_and_grads", "eval_loss", "noise_blocks", "eval_forward")


def _bench_with_config(tmp_path, model_class):
    """BENCHMARK.json with the first cell's configuration a copy in
    ``tmp_path`` whose ``model_class`` is ``model_class``: (bench, cell)."""
    bench = copy.deepcopy(BENCH)
    cell = bench["workloads"][0]
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / conf["file"]).read_text())
    path = tmp_path / "config.json"
    path.write_text(json.dumps(dict(cfg, model_class=model_class)))
    conf["file"] = str(path)
    return bench, cell["name"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_every_configuration_has_its_module(conf):
    assert set(TABLE) <= set(core.CLASS_NAMES)
    model_class = json.loads((ROOT / conf["file"]).read_text())["model_class"]
    module = core.model_module(model_class)
    assert module.__file__ == str(ROOT / "portbench" / "classes" / f"{model_class}.py")
    for name in core.CLASS_NAMES:
        assert callable(getattr(module, name)), name


def test_missing_module_fails_at_load_cell(tmp_path):
    bench, cell = _bench_with_config(tmp_path, "NoSuchModel")
    with pytest.raises(FileNotFoundError, match=re.escape("portbench/classes/NoSuchModel.py")):
        core.load_cell(cell, bench)


def test_new_module_is_found_without_edits(tmp_path, monkeypatch):
    classes = tmp_path / "classes"
    classes.mkdir()
    body = "".join(f"def {name}(*args):\n    return '{name}'\n\n\n" for name in core.CLASS_NAMES)
    (classes / "Stub.py").write_text(body)
    (classes / "Partial.py").write_text(body.replace("def eval_forward", "def other"))
    monkeypatch.setattr(core, "CLASSES", classes)
    bench, cell = _bench_with_config(tmp_path, "Stub")
    module = core.load_cell(cell, bench).model_module
    assert module.__file__ == str(classes / "Stub.py")
    assert module.canon("x") == "canon"
    with pytest.raises(AttributeError, match="eval_forward"):
        core.model_module("Partial")


def _violations(source: str, class_names: set, model_modules: set) -> list:
    """Model-class literals, and imports of a model module of the port or of
    a model class from ``flexynesis_torch.models``, in ``source``."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Constant) and node.value in class_names:
            found.append(f"line {node.lineno}: the literal {node.value!r}")
        elif isinstance(node, ast.Import):
            found += [f"line {node.lineno}: import {a.name}" for a in node.names
                      if a.name in model_modules]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names = {f"{node.module}.{a.name}" for a in node.names}
            if node.module in model_modules or names & model_modules or (
                    node.module == "flexynesis_torch.models"
                    and {a.name for a in node.names} & class_names):
                found.append(f"line {node.lineno}: from {node.module} import ...")
    return found


def test_no_model_class_outside_classes():
    from flexynesis_torch.models import MODEL_REGISTRY

    class_names = set(MODEL_REGISTRY) | {c.__name__ for c in MODEL_REGISTRY.values()}
    model_modules = {c.__module__ for c in MODEL_REGISTRY.values()}
    # the scan finds what it looks for
    planted = ('from flexynesis_torch.models import supervised_vae\n'
               'from flexynesis_torch.models.direct_pred import DirectPred\n'
               'if cfg["model_class"] == "GNN":\n    pass\n')
    assert len(_violations(planted, class_names, model_modules)) == 3
    bench = ROOT / "portbench"
    files = [p for p in sorted(bench.rglob("*.py"))
             if p.relative_to(bench).parts[0] not in ("classes", "tests")]
    assert files
    found = {str(p.relative_to(ROOT)): v for p in files
             if (v := _violations(p.read_text(), class_names, model_modules))}
    assert not found, found
