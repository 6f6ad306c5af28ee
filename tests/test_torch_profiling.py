"""``--profile`` (``utils/profiling.py``) against ``flexynesis_tpu/utils/profiling.py``:

* ``PhaseTimer`` records the phases JAX's records, with the same JSON keys
  (``seconds`` rounded to the millisecond, ``device_bytes_delta`` 0 off the
  card, as JAX's on its CPU backend), prints the same ``[PROFILE]`` table
  lines and writes the same JSON layout; a disabled timer records and writes
  nothing;
* ``trace`` writes a Chrome trace under its directory, and nothing without
  one;
* the training CLI with ``--profile`` on the CPU writes
  ``<prefix>.profile.json`` with exactly JAX's phase names (``finetuning``
  with ``--finetuning_samples``) and the HPO's trace under
  ``<prefix>.profile/``, and keeps ``model.cli_phases``."""

import json
import re

import pytest

from flexynesis_tpu.utils.profiling import PhaseTimer as JaxPhaseTimer
from flexynesis_torch.__main__ import parse_args, run_training
from flexynesis_torch.utils.profiling import PhaseTimer, trace
from flexynesis_torch.utils.synthetic import write_synthetic_folder


def _run(timer):
    with timer.phase("alpha"):
        sum(range(1000))
    with timer.phase("beta"):
        pass


def _table(text):
    """The report's lines with the numbers taken out."""
    return [re.sub(r"[-+]?\d+\.\d+", "#", line) for line in text.splitlines()
            if line.startswith("[PROFILE]") and "wrote" not in line]


def test_phase_timer_matches_jax(tmp_path, capsys):
    ours, theirs = PhaseTimer(device="cpu"), JaxPhaseTimer()
    for t in (ours, theirs):
        _run(t)
    ours.report(str(tmp_path / "ours.json"))
    ours_out = capsys.readouterr().out
    theirs.report(str(tmp_path / "theirs.json"))
    theirs_out = capsys.readouterr().out
    assert _table(ours_out) == _table(theirs_out)
    a = json.loads((tmp_path / "ours.json").read_text())
    b = json.loads((tmp_path / "theirs.json").read_text())
    assert list(a) == list(b) == ["alpha", "beta"]
    for name in a:
        assert list(a[name]) == list(b[name]) == ["seconds", "device_bytes_delta"]
        assert a[name]["device_bytes_delta"] == b[name]["device_bytes_delta"] == 0
        assert a[name]["seconds"] == round(a[name]["seconds"], 3) >= 0


def test_disabled_timer_writes_nothing(tmp_path, capsys):
    for t in (PhaseTimer(enabled=False), JaxPhaseTimer(enabled=False)):
        _run(t)
        t.report(str(tmp_path / "p.json"))
        assert not t.phases
    assert not (tmp_path / "p.json").exists()
    assert capsys.readouterr().out == ""


def test_trace_writes_a_chrome_trace(tmp_path):
    with trace(str(tmp_path / "tr"), "cpu"):
        sum(range(100))
    data = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert "traceEvents" in data
    with trace(None):
        pass


CONFIG = """DirectPred:
  - {type: Categorical, categories: [8], name: latent_dim}
  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.001], name: lr}
  - {type: Categorical, categories: [6], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
  - {type: Categorical, categories: [true], name: fused_kernels}
"""


@pytest.mark.parametrize("finetune", [False, True])
def test_cli_profile(tmp_path, finetune):
    data = tmp_path / "data"
    write_synthetic_folder(str(data), n_train=60, n_test=30,
                           n_features={"gex": 30, "cnv": 20}, n_classes=3, seed=4)
    config = tmp_path / "hpo.yaml"
    config.write_text(CONFIG)
    out = tmp_path / "out"
    extra = ["--finetuning_samples", "10"] if finetune else []
    model = run_training(*parse_args([
        "--data_path", str(data), "--model_class", "DirectPred", "--data_types", "gex,cnv",
        "--target_variables", "subtype", "--config_path", str(config), "--hpo_iter", "1",
        "--features_min", "10", "--safetensors", "--disable_marker_finding",
        "--device", "cpu", "--outdir", str(out), "--prefix", "job", "--profile", *extra]))
    phases = json.loads((out / "job.profile.json").read_text())
    want = ["data_import", "hpo_training"] + (["finetuning"] if finetune else []) + [
        "evaluation_outputs"]
    assert list(phases) == want
    for p in phases.values():
        assert set(p) == {"seconds", "device_bytes_delta"} and p["device_bytes_delta"] == 0
    assert "traceEvents" in json.loads((out / "job.profile" / "trace.json").read_text())
    assert {"hpo_fit", "evaluation_outputs", "save"} <= set(model.cli_phases)
