"""Marker finding through ``python -m flexynesis_torch``, on the CPU:

* a DirectPred saved by the JAX package's training CLI (a categorical, a
  numerical and a survival target) is scored by both packages' inference
  CLIs with ``--feature_importance_method Both``, with and without
  ``--marker_sample_cap``: the two ``feature_importance.<method>.csv`` tables
  hold the same rows in the same order, with importances within rtol 1e-4 /
  atol 1e-6 (f32, different summation orders);
* a default training run of the port (no ``--disable_marker_finding``)
  writes its table and times the phase;
* a DirectPred whose configuration fixes ``fused_kernels`` is refused before
  any work, in training mode and in inference mode.

Every CLI runs in-process through ``main(argv)``, at a few hundred features
and tens of samples."""

import os

import numpy as np
import pandas as pd
import pytest
import yaml

from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_torch.__main__ import main, parse_args, run_training
from flexynesis_torch.interpret.attribution import FUSED_REFUSAL
from flexynesis_torch.utils.synthetic import write_synthetic_folder

TOL = dict(rtol=1e-4, atol=1e-6)
METHODS = ("IntegratedGradients", "GradientShap")


def _space(fused=None):
    space = [
        {"type": "Categorical", "categories": [16], "name": "latent_dim"},
        {"type": "Categorical", "categories": [0.3], "name": "hidden_dim_factor"},
        {"type": "Categorical", "categories": [0.01], "name": "lr"},
        {"type": "Categorical", "categories": [8], "name": "supervisor_hidden_dim"},
        {"type": "Categorical", "categories": [3], "name": "epochs"},
        {"type": "Categorical", "categories": [16], "name": "batch_size"},
    ]
    if fused is not None:
        space.append({"type": "Categorical", "categories": [fused], "name": "fused_kernels"})
    return yaml.safe_dump({"DirectPred": space})


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("marker_cli")
    write_synthetic_folder(str(root / "data"), n_train=48, n_test=24,
                           n_features={"gex": 120, "cnv": 80}, n_classes=3, seed=6)
    (root / "hpo.yaml").write_text(_space())
    (root / "fused.yaml").write_text(_space(fused=True))
    return root


def train_args(root, outdir, config="hpo.yaml", *extra):
    return ["--data_path", str(root / "data"), "--model_class", "DirectPred",
            "--data_types", "gex,cnv", "--target_variables", "subtype,age",
            "--surv_event_var", "OS_STATUS", "--surv_time_var", "OS_MONTHS",
            "--config_path", str(root / config), "--hpo_iter", "1",
            "--features_top_percentile", "80", "--features_min", "40",
            "--early_stop_patience", "3", "--safetensors", "--device", "cpu",
            "--outdir", str(outdir), "--prefix", "job", *extra]


def infer_args(trained, root, outdir, *extra):
    return ["--pretrained_model", str(trained / "job.final_model.safetensors"),
            "--artifacts", str(trained / "job.artifacts.json"),
            "--data_path_test", str(root / "data" / "test"), "--outdir", str(outdir),
            "--prefix", "inf", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def jax_trained(folder):
    out = folder / "jax_train"
    assert jax_main(train_args(folder, out, "hpo.yaml", "--disable_marker_finding")) == 0
    return out


def _table(path):
    return pd.read_csv(path, keep_default_na=False, na_values=[""])


@pytest.mark.parametrize("cap", [0, 15])
def test_inference_tables_match_the_jax_cli(folder, jax_trained, tmp_path, cap):
    extra = ["--feature_importance_method", "Both", "--marker_sample_cap", str(cap)]
    assert jax_main(infer_args(jax_trained, folder, tmp_path / "jax", *extra)) == 0
    assert main(infer_args(jax_trained, folder, tmp_path / "ours", *extra)) == 0
    for method in METHODS:
        name = f"inf.feature_importance.{method}.csv"
        ours, theirs = _table(tmp_path / "ours" / name), _table(tmp_path / "jax" / name)
        assert list(ours.columns) == list(theirs.columns) == [
            "target_variable", "target_class", "target_class_label", "layer", "name",
            "importance"]
        assert len(ours) == len(theirs) > 0
        for col in theirs.columns[:-1]:
            assert ours[col].fillna("").tolist() == theirs[col].fillna("").tolist(), col
        assert set(ours["target_variable"]) == {"subtype", "age", "OS_STATUS"}
        np.testing.assert_allclose(ours["importance"].to_numpy(), theirs["importance"].to_numpy(),
                                   **TOL, err_msg=method)
        assert np.isfinite(ours["importance"]).all() and (ours["importance"] >= 0).all()
    # the other outputs are written as before, after the importances
    for name in ("inf.embeddings_test.csv", "inf.predicted_labels.csv", "inf.stats.csv"):
        assert (tmp_path / "ours" / name).exists()


def test_default_training_run_writes_its_table(folder, tmp_path):
    out = tmp_path / "train"
    model = run_training(*parse_args(train_args(folder, out)))
    assert model.cli_phases["marker_finding"] > 0
    table = _table(out / "job.feature_importance.IntegratedGradients.csv")
    assert not (out / "job.feature_importance.GradientShap.csv").exists()
    n_features = sum(len(f) for f in model.feature_names.values())
    assert list(dict.fromkeys(table["target_variable"])) == model.variables
    for var, group in table.groupby("target_variable", sort=False):
        n_class = len(group) // n_features
        assert len(group) == n_class * n_features and n_class >= 1
        assert (n_class == 1) == (model.variable_types[var] == "numerical"), var
        assert np.isfinite(group["importance"]).all() and group["importance"].sum() > 0
    assert model.feature_importances.keys() == set(model.variables)


def test_fused_direct_pred_is_refused_before_any_work(folder, tmp_path):
    out = tmp_path / "refused"
    with pytest.raises(NotImplementedError) as err:
        main(train_args(folder, out, "fused.yaml"))
    assert str(err.value) == FUSED_REFUSAL and not os.listdir(out)

    trained = tmp_path / "fused"
    assert main(train_args(folder, trained, "fused.yaml", "--disable_marker_finding")) == 0
    served = tmp_path / "served"
    with pytest.raises(NotImplementedError, match="fused_kernels"):
        main(infer_args(trained, folder, served))
    assert not any(n.startswith("inf.") for n in os.listdir(served))
