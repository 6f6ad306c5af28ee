"""flexynesis_torch and chip_smoke.py stand alone: they import no JAX, no
part of the JAX package, and nothing the card's machine lacks or the port
replaces (pandas, sklearn, safetensors, joblib, h5py; networkx, seaborn,
umap, requests, lifelines and sksurv, whose parts the analysis modules
compute themselves) anywhere in a module; matplotlib only inside function
bodies, so no import of the CLI needs it; the walk covers every module of
the package, the HDF5 reader, the converter, the profiler, the classical
estimators and the analysis modules included; and the CLI's default device
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
             "sklearn", "safetensors", "joblib", "h5py", "networkx", "seaborn", "umap",
             "requests", "lifelines", "sksurv"}
FUNCTION_ONLY = {"matplotlib"}  # imported inside function bodies only
SOURCES = sorted((REPO / "flexynesis_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def _imported_roots(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _outside_functions(node):
    """The roots imported outside every function body of a module."""
    for child in ast.iter_child_nodes(node):
        if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(child, (ast.Import, ast.ImportFrom)):
            yield from _imported_roots(child)
        yield from _outside_functions(child)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_forbidden_imports(path):
    tree = ast.parse(path.read_text())
    found = set(_imported_roots(tree)) & FORBIDDEN
    assert not found, f"{path.name} imports {sorted(found)}"
    found = set(_outside_functions(tree)) & FUNCTION_ONLY
    assert not found, f"{path.name} imports {sorted(found)} outside a function"


def test_function_only_check_sees_module_level_imports():
    tree = ast.parse("import matplotlib\nclass A:\n    import matplotlib.pyplot\n"
                     "    def g(self):\n        import matplotlib\n"
                     "def f():\n    import matplotlib\n")
    assert list(_outside_functions(tree)) == ["matplotlib", "matplotlib"]


def test_cli_module_loads_without_forbidden_modules():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import flexynesis_torch.__main__, flexynesis_torch.inference\n"
        "import flexynesis_torch.data.inference_importer, flexynesis_torch.utils.metrics\n"
        "import flexynesis_torch.utils.synthetic, flexynesis_torch.data.importer\n"
        "import flexynesis_torch.data.feature_selection, flexynesis_torch.train.hpo\n"
        "import flexynesis_torch.train.trainer, flexynesis_torch.ops.losses\n"
        "import flexynesis_torch.models, flexynesis_torch.kernels.mmd\n"
        "import flexynesis_torch.models.supervised_vae, flexynesis_torch.models.crossmodal_pred\n"
        "import flexynesis_torch.interpret.attribution, flexynesis_torch.utils.prng\n"
        "import flexynesis_torch.data.fastcsv, flexynesis_torch.data.h5\n"
        "import flexynesis_torch.csv_to_h5, flexynesis_torch.utils.hdf5\n"
        "import flexynesis_torch.utils.profiling, flexynesis_torch.utils.baselines\n"
        "import flexynesis_torch.utils.classical\n"
        "import flexynesis_torch.coexpression, flexynesis_torch.utils.survival\n"
        "import flexynesis_torch.utils.clustering, flexynesis_torch.utils.batch_correction\n"
        "import flexynesis_torch.utils.plotting, flexynesis_torch.utils.cbioportal\n"
        "import flexynesis_torch.train.live_plot\n"
        "import flexynesis_torch.utils.classical.feature_selection\n"
        "new = {m.split('.')[0] for m in set(sys.modules) - before}\n"
        f"bad = sorted(set({sorted(FORBIDDEN | FUNCTION_ONLY)!r}) & new)\n"
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


def test_walk_covers_this_slices_modules():
    names = {p.relative_to(REPO).as_posix() for p in SOURCES}
    assert {"flexynesis_torch/utils/hdf5.py", "flexynesis_torch/data/h5.py",
            "flexynesis_torch/csv_to_h5.py", "flexynesis_torch/utils/profiling.py",
            "flexynesis_torch/utils/baselines.py",
            "flexynesis_torch/utils/classical/tree.py",
            "flexynesis_torch/utils/classical/ensemble.py",
            "flexynesis_torch/utils/classical/svm.py",
            "flexynesis_torch/utils/classical/model_selection.py",
            "flexynesis_torch/utils/classical/pca.py",
            "flexynesis_torch/coexpression.py", "flexynesis_torch/utils/survival.py",
            "flexynesis_torch/utils/clustering.py", "flexynesis_torch/utils/batch_correction.py",
            "flexynesis_torch/utils/plotting.py", "flexynesis_torch/utils/cbioportal.py",
            "flexynesis_torch/train/live_plot.py",
            "flexynesis_torch/utils/classical/feature_selection.py"} <= names
