"""flexynesis_torch and chip_smoke.py stand alone: they import no JAX, no
part of the JAX package, and nothing the card's machine lacks (pandas,
sklearn, safetensors, joblib) at module level; and the CLI's default device
is the card, with no fallback to the CPU."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from flexynesis_torch.__main__ import main

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "flexynesis_tpu", "pandas",
             "sklearn", "safetensors", "joblib"}
SOURCES = sorted((REPO / "flexynesis_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    found = set(_imported_roots(ast.parse(path.read_text()))) & FORBIDDEN
    assert not found, f"{path.name} imports {sorted(found)}"


def test_cli_module_loads_without_forbidden_modules():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import flexynesis_torch.__main__, flexynesis_torch.inference\n"
        "import flexynesis_torch.data.inference_importer, flexynesis_torch.utils.metrics\n"
        "import flexynesis_torch.utils.synthetic, flexynesis_torch.data.importer\n"
        "import flexynesis_torch.data.feature_selection, flexynesis_torch.train.hpo\n"
        "import flexynesis_torch.train.trainer, flexynesis_torch.ops.losses\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        f"bad = sorted(set({sorted(FORBIDDEN)!r}) & new)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_card_devices_raise_without_cuda(device, tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--pretrained_model", str(tmp_path / "m.final_model.safetensors"),
              "--artifacts", str(tmp_path / "a.json"),
              "--data_path_test", str(tmp_path), "--outdir", str(tmp_path),
              "--disable_marker_finding", "--device", device])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_training_mode_raises_without_cuda(device, tmp_path, monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--data_path", str(tmp_path), "--model_class", "DirectPred",
              "--data_types", "gex", "--target_variables", "y", "--hpo_batch", "1",
              "--safetensors", "--disable_marker_finding", "--outdir",
              str(tmp_path / "out"), "--device", device])
    assert not any(tmp_path.iterdir())
