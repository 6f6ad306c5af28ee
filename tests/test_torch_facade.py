"""The package facades: every lazy name of ``flexynesis_torch`` and of
``flexynesis_torch.utils`` resolves to an object of the port (defined in a
``flexynesis_torch`` module), the table covers flexynesis_tpu's names, and
importing the package loads neither torch-heavy modules nor matplotlib."""

import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

import flexynesis_torch
import flexynesis_torch.utils
import flexynesis_tpu

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("name", sorted(flexynesis_torch._LAZY_ATTRS))
def test_lazy_name_resolves_to_the_port(name):
    value = getattr(flexynesis_torch, name)
    module = getattr(value, "__module__", None) or type(value).__module__
    if name == "MODEL_REGISTRY":
        module = next(iter(value.values())).__module__
    assert module.startswith("flexynesis_torch."), (name, module)


@pytest.mark.parametrize("name", sorted(flexynesis_torch.utils._LAZY_ATTRS))
def test_utils_name_resolves_to_the_port(name):
    assert getattr(flexynesis_torch.utils, name).__module__.startswith("flexynesis_torch.utils.")


def test_covers_the_jax_tables():
    import flexynesis_tpu.utils as jax_utils

    assert set(flexynesis_tpu._LAZY_ATTRS) <= set(flexynesis_torch._LAZY_ATTRS)
    assert set(flexynesis_tpu._LAZY_SUBMODULES) <= set(flexynesis_torch._LAZY_SUBMODULES)
    jax_names = {n for n in jax_utils.__all__ if n != "annotations"
                 and not isinstance(getattr(jax_utils, n), types.ModuleType)}
    assert jax_names <= set(flexynesis_torch.utils.__all__)
    for sub in flexynesis_torch._LAZY_SUBMODULES:
        assert getattr(flexynesis_torch, sub).__name__ == f"flexynesis_torch.{sub}"
    with pytest.raises(AttributeError):
        flexynesis_torch.not_a_name  # noqa: B018


def test_import_is_light():
    code = (
        "import sys\n"
        "import flexynesis_torch, flexynesis_torch.utils\n"
        "heavy = sorted({m.split('.')[0] for m in sys.modules} & "
        "{'torch', 'matplotlib', 'scipy', 'numpy'})\n"
        "assert not heavy, heavy\n"
        "import flexynesis_torch.utils.csvio\n"
        "assert 'torch' not in sys.modules\n"
        "import flexynesis_torch.utils.plotting, flexynesis_torch.train.live_plot\n"
        "import flexynesis_torch.__main__\n"
        "assert 'matplotlib' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
