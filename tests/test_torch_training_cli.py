"""``python -m flexynesis_torch`` in training mode, on the CPU:

* with the same flags it writes every file the JAX CLI writes;
* a model it trained (fused blocks, kernel B1 in training) loads in the JAX
  package's inference CLI, whose outputs match the port's inference CLI on the
  same test folder;
* the options that raised ``NotImplementedError`` before they were ported
  now pass the argument checks (``--evaluate_baseline_performance``,
  ``--profile`` and the classical ``--model_class`` run in
  ``tests/test_torch_{baselines,profiling}.py``; ``--use_cv`` and the VAE
  classes' ``--hpo_batch 4`` run since their trial
  engine was ported: ``tests/test_torch_cv.py`` and
  ``tests/test_torch_vae_trials.py`` run them through the CLI; the
  MultiTripletNetwork and GNN classes train since they were ported:
  ``tests/test_torch_zoo_cli.py`` runs them; ``--covariates``,
  ``--fusion_type early``, ``--finetuning_samples`` and ``--hpo_checkpoint``
  run since they were ported: ``tests/test_torch_{covariates,finetune,
  checkpoint}.py`` run them);
* a GNN run refuses early fusion and covariates as the JAX CLI does;
* an artifact failure only warns, as in JAX: the run exits 0 and still
  writes the weights and config;
* ``--threads`` sets ``OMP_NUM_THREADS`` where it is absent, leaves it
  where it is set, sets torch's threads for a CPU run (restored after it)
  and reaches the baselines as ``n_jobs``.

Tolerance for the two inference CLIs: rtol=1e-4, atol=1e-5 (f32)."""

import os

import numpy as np
import pytest
import torch

from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_torch import __main__ as cli
from flexynesis_torch.__main__ import main
from flexynesis_torch.utils.csvio import read_matrix, read_table
from flexynesis_torch.utils.synthetic import write_synthetic_folder

CONFIG = """DirectPred:
  - {type: Categorical, categories: [16], name: latent_dim}
  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.003], name: lr}
  - {type: Categorical, categories: [8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [3], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
  - {type: Categorical, categories: [true], name: fused_kernels}
"""


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("training_cli")
    write_synthetic_folder(str(root / "data"), n_train=48, n_test=20,
                           n_features={"gex": 40, "cnv": 30}, n_classes=3, seed=4)
    (root / "hpo.yaml").write_text(CONFIG)
    return root


def train_args(root, outdir, *extra):
    return ["--data_path", str(root / "data"), "--model_class", "DirectPred",
            "--data_types", "gex,cnv", "--target_variables", "subtype",
            "--config_path", str(root / "hpo.yaml"), "--hpo_iter", "1",
            "--features_top_percentile", "50", "--features_min", "10",
            "--safetensors", "--disable_marker_finding", "--device", "cpu",
            "--outdir", str(outdir), "--prefix", "job", *extra]


@pytest.fixture(scope="module")
def trained(folder):
    out = folder / "torch_train"
    assert main(train_args(folder, out)) == 0
    return out


def test_writes_every_file_the_jax_cli_writes(folder, trained):
    jax_out = folder / "jax_train"
    assert jax_main(train_args(folder, jax_out, "--hpo_batch", "1")) == 0
    assert sorted(os.listdir(trained)) == sorted(os.listdir(jax_out))
    # same selected features and the same table layouts
    for layer in ("gex", "cnv"):
        ours = read_table(str(trained / f"job.feature_logs.{layer}.csv"))
        theirs = read_table(str(jax_out / f"job.feature_logs.{layer}.csv"))
        assert ours[0] == theirs[0] and ours[1] == theirs[1]
    for name in ("predicted_labels", "stats"):
        assert read_table(str(trained / f"job.{name}.csv"))[1] == \
            read_table(str(jax_out / f"job.{name}.csv"))[1]
    samples, _, emb = read_matrix(str(trained / "job.embeddings_train.csv"))
    assert emb.shape == (48, 16) and np.isfinite(emb).all()


def _infer_args(trained, outdir):
    return ["--pretrained_model", str(trained / "job.final_model.safetensors"),
            "--artifacts", str(trained / "job.artifacts.json"),
            "--data_path_test", None, "--outdir", str(outdir), "--prefix", "inf",
            "--disable_marker_finding", "--device", "cpu"]


def test_port_trained_model_serves_in_the_jax_cli(folder, trained):
    outputs = {}
    for name, entry in (("torch", main), ("jax", jax_main)):
        args = _infer_args(trained, folder / f"infer_{name}")
        args[args.index(None)] = str(folder / "data" / "test")
        assert entry(args) == 0
        samples, _, emb = read_matrix(str(folder / f"infer_{name}" / "inf.embeddings_test.csv"))
        _, cols, rows = read_table(str(folder / f"infer_{name}" / "inf.predicted_labels.csv"))
        prob = np.array([float(r[cols.index("probability")]) for r in rows])
        outputs[name] = (samples, emb, prob)
    (s1, e1, p1), (s2, e2, p2) = outputs["torch"], outputs["jax"]
    assert s1 == s2
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("extra,item", [
    (["--evaluate_baseline_performance"], "item 13"),
    (["--profile"], "item 13"),
    (["--model_class", "RandomForest"], "item 13"),
])
def test_not_ported_options_raise(folder, tmp_path, monkeypatch, extra, item):
    """These options raised before any work, citing ROADMAP ``item``; since
    they were ported a run with them passes every check and reaches the data
    import (the whole runs are in ``tests/test_torch_{baselines,profiling}.py``)."""

    class Reached(Exception):
        pass

    def importer(args, device):
        raise Reached

    monkeypatch.setattr(cli, "_build_importer", importer)
    with pytest.raises(Reached):
        main(train_args(folder, tmp_path / "out") + extra)


@pytest.mark.parametrize("extra,message", [
    (["--fusion_type", "early"], "--fusion_type early is not applicable to GNN"),
    (["--covariates", "age"], "--covariates are not supported for GNN models"),
])
def test_gnn_refuses_what_the_jax_cli_refuses(folder, tmp_path, capsys, extra, message):
    args = train_args(folder, tmp_path / "out") + ["--model_class", "GNN", "--user_graph",
                                                   str(tmp_path / "graph.csv"), *extra]
    for entry in (main, jax_main):
        with pytest.raises(SystemExit):
            entry(args)
        assert message in capsys.readouterr().err


@pytest.mark.parametrize("drop", ["--disable_marker_finding"])
def test_joblib_artifacts_and_marker_finding_raise(folder, tmp_path, drop):
    """Marker finding on a fused DirectPred raises before any work (joblib
    artifacts, which raised here too, are written since they were ported:
    ``tests/test_torch_joblib.py``)."""
    args = [a for a in train_args(folder, tmp_path / "out") if a != drop]
    with pytest.raises(NotImplementedError):
        main(args)


def test_artifact_failure_only_warns(folder, tmp_path, monkeypatch, capsys):
    from flexynesis_torch import inference

    def broken(*a, **k):
        raise RuntimeError("no artifacts today")

    monkeypatch.setattr(inference, "build_artifacts", broken)
    out = tmp_path / "out"
    assert main(train_args(folder, out)) == 0
    assert "[WARN] Could not write inference artifacts: no artifacts today" in \
        capsys.readouterr().out
    assert (out / "job.final_model.safetensors").exists()
    assert (out / "job.final_model_config.json").exists()
    assert not (out / "job.artifacts.json").exists()


@pytest.mark.parametrize("preset", [None, "3"])
def test_threads_set_omp_num_threads(folder, tmp_path, monkeypatch, preset):
    if preset is None:
        monkeypatch.delenv("OMP_NUM_THREADS", raising=False)
    else:
        monkeypatch.setenv("OMP_NUM_THREADS", preset)
    seen = {}

    def classical(args, train, test, device):
        seen["n_jobs"] = args.threads
        seen["torch_threads"] = torch.get_num_threads()

    monkeypatch.setattr(cli, "run_classical", classical)
    before = torch.get_num_threads()
    assert main(["--data_path", str(folder / "data"), "--model_class", "SVM",
                 "--data_types", "gex", "--target_variables", "subtype",
                 "--features_min", "10", "--threads", "7", "--device", "cpu",
                 "--outdir", str(tmp_path / "out")]) == 0
    assert os.environ["OMP_NUM_THREADS"] == (preset or "7")
    assert seen == {"n_jobs": 7, "torch_threads": 7}
    assert torch.get_num_threads() == before


def test_threads_reach_the_baselines_as_n_jobs(tmp_path, monkeypatch):
    import argparse

    from flexynesis_torch.utils import baselines

    calls = []

    def record(*a, n_jobs=None, **k):
        calls.append(n_jobs)
        return [], []

    monkeypatch.setattr(baselines, "evaluate_baseline_performance", record)
    monkeypatch.setattr(baselines, "evaluate_baseline_survival_performance", record)
    args = argparse.Namespace(target_variables="subtype", surv_event_var="E",
                              surv_time_var="T", threads=5, outdir=str(tmp_path),
                              prefix="job", model_class="SVM")
    cli._run_baseline_comparison(args, None, None, "cpu")  # the three, then survival
    cli.run_classical(args, None, None, "cpu")
    args.model_class = "RandomSurvivalForest"
    cli.run_classical(args, None, None, "cpu")
    assert calls == [5, 5, 5, 5]
