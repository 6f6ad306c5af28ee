"""``python -m flexynesis_torch`` in training mode, on the CPU:

* with the same flags it writes every file the JAX CLI writes;
* a model it trained (fused blocks, kernel B1 in training) loads in the JAX
  package's inference CLI, whose outputs match the port's inference CLI on the
  same test folder;
* the options that are not ported yet raise ``NotImplementedError``
  (``--use_cv`` and the VAE classes' ``--hpo_batch 4`` run since their trial
  engine was ported: ``tests/test_torch_cv.py`` and
  ``tests/test_torch_vae_trials.py`` run them through the CLI; the
  MultiTripletNetwork and GNN classes train since they were ported:
  ``tests/test_torch_zoo_cli.py`` runs them);
* a GNN run refuses early fusion and covariates as the JAX CLI does.

Tolerance for the two inference CLIs: rtol=1e-4, atol=1e-5 (f32)."""

import os

import numpy as np
import pytest

from flexynesis_tpu.__main__ import main as jax_main
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
    (["--covariates", "age", "--model_class", "supervised_vae"], "A.11"),
    (["--hpo_checkpoint", "ck.json"], "item 9"),
    (["--finetuning_samples", "5"], "A.12"),
    (["--evaluate_baseline_performance"], "item 13"),
    (["--profile"], "item 13"),
    (["--model_class", "RandomForest"], "item 13"),
    (["--covariates", "age"], "A.11"),
    (["--fusion_type", "early"], "A.11"),
])
def test_not_ported_options_raise(folder, tmp_path, extra, item):
    args = train_args(folder, tmp_path / "out") + extra
    with pytest.raises(NotImplementedError, match=item):
        main(args)


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


@pytest.mark.parametrize("drop", ["--safetensors", "--disable_marker_finding"])
def test_joblib_artifacts_and_marker_finding_raise(folder, tmp_path, drop):
    args = [a for a in train_args(folder, tmp_path / "out") if a != drop]
    with pytest.raises(NotImplementedError):
        main(args)
