"""The port's inference path against the JAX package's, on the CPU.

* the numpy safetensors codec against the ``safetensors`` package, both ways;
* the synthetic data writer and the inference importer against the JAX ones;
* a default-layout model trained by the JAX CLI (``--safetensors``) and a
  fused-layout model written by the JAX package's save functions: both CLIs
  score the same test folder and their three tables agree column by column;
* a model saved by the port loads in the JAX package and predicts the same.

Tolerance for model outputs: rtol=1e-4, atol=1e-5 (f32, as
tests/test_torch_parity.py); the data path is compared exactly."""

import json
import os
import shutil

import numpy as np
import pandas as pd
import pytest
import yaml
from safetensors.numpy import load_file as st_load, save_file as st_save

from flexynesis_tpu import inference as jax_inference
from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_tpu.data.inference_importer import (
    DataImporterInference as JaxImporter,
)
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.utils.synthetic import write_synthetic_folder as jax_write
from flexynesis_torch import inference
from flexynesis_torch.__main__ import main
from flexynesis_torch.data.inference_importer import DataImporterInference
from flexynesis_torch.data.preprocessing import apply_standard_scaler, fit_standard_scaler
from flexynesis_torch.utils import safetensors_io
from flexynesis_torch.utils.synthetic import write_synthetic_folder

FEATURES = {"gex": 40, "cnv": 30}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A DirectPred trained by the JAX CLI with JSON artifacts."""
    root = tmp_path_factory.mktemp("torch_inference")
    data = str(root / "data")
    jax_write(data, n_train=48, n_test=24, n_features=FEATURES, seed=5)
    out = str(root / "train")
    os.makedirs(out)
    space = [
        {"type": "Integer", "low": 16, "high": 16, "name": "latent_dim"},
        {"type": "Real", "low": 0.3, "high": 0.3, "name": "hidden_dim_factor"},
        {"type": "Real", "low": 0.01, "high": 0.01, "name": "lr"},
        {"type": "Integer", "low": 8, "high": 8, "name": "supervisor_hidden_dim"},
        {"type": "Categorical", "categories": [4], "name": "epochs"},
        {"type": "Categorical", "categories": [16], "name": "batch_size"},
    ]
    with open(os.path.join(out, "hpo.yaml"), "w") as fh:
        yaml.safe_dump({"DirectPred": space}, fh)
    rc = jax_main([
        "--data_path", data, "--hpo_iter", "1", "--outdir", out,
        "--prefix", "job", "--features_top_percentile", "50",
        "--features_min", "20", "--early_stop_patience", "3",
        "--config_path", os.path.join(out, "hpo.yaml"),
        "--model_class", "DirectPred", "--data_types", "gex,cnv",
        "--target_variables", "subtype", "--safetensors",
        "--disable_marker_finding", "--device", "cpu",
    ])
    assert rc == 0
    return {
        "test": os.path.join(data, "test"),
        "weights": os.path.join(out, "job.final_model.safetensors"),
        "config": os.path.join(out, "job.final_model_config.json"),
        "artifacts": os.path.join(out, "job.artifacts.json"),
    }


def _infer_args(weights, artifacts, test, outdir):
    return ["--pretrained_model", weights, "--artifacts", artifacts,
            "--data_path_test", test, "--outdir", outdir, "--prefix", "inf",
            "--disable_marker_finding", "--device", "cpu"]


def _assert_tables_agree(dir_ours, dir_theirs):
    emb = pd.read_csv(os.path.join(dir_ours, "inf.embeddings_test.csv"), index_col=0)
    emb_ref = pd.read_csv(os.path.join(dir_theirs, "inf.embeddings_test.csv"), index_col=0)
    assert list(emb.index) == list(emb_ref.index)
    assert list(emb.columns) == list(emb_ref.columns)
    np.testing.assert_allclose(emb.to_numpy(), emb_ref.to_numpy(), rtol=1e-4, atol=1e-5)
    for name in ("inf.predicted_labels.csv", "inf.stats.csv"):
        with open(os.path.join(dir_theirs, name)) as fh:
            if fh.read() == "\n":  # nothing to score: an empty table
                with open(os.path.join(dir_ours, name)) as mine:
                    assert mine.read() == "\n", name
                continue
        ours = pd.read_csv(os.path.join(dir_ours, name))
        theirs = pd.read_csv(os.path.join(dir_theirs, name))
        assert list(ours.columns) == list(theirs.columns), name
        assert len(ours) == len(theirs) > 0, name
        for col in theirs.columns:
            a, b = ours[col], theirs[col]
            if pd.api.types.is_numeric_dtype(b):
                np.testing.assert_allclose(a.to_numpy(float), b.to_numpy(float),
                                           rtol=1e-4, atol=1e-5, err_msg=col)
            else:
                assert a.fillna("").tolist() == b.fillna("").tolist(), (name, col)


def test_safetensors_codec_reads_and_writes_the_package_format(tmp_path):
    rng = np.random.default_rng(0)
    tensors = {
        "params/a/kernel": rng.normal(size=(5, 3)).astype(np.float32),
        "params/b": rng.normal(size=(7,)).astype(np.float64),
        "batch_stats/c": rng.integers(-9, 9, (2, 3, 4)).astype(np.int32),
        "graph/i64": rng.integers(0, 100, 6).astype(np.int64),
        "flags": rng.random(4) < 0.5,
        "scalar": np.asarray(3.5, np.float32),
        "empty": np.zeros((0, 3), np.float32),
    }
    st_save(tensors, str(tmp_path / "theirs.safetensors"))
    ours = safetensors_io.load_file(str(tmp_path / "theirs.safetensors"))
    safetensors_io.save_file(tensors, str(tmp_path / "ours.safetensors"),
                             metadata={"format": "np"})
    theirs = st_load(str(tmp_path / "ours.safetensors"))
    for loaded in (ours, theirs):
        assert loaded.keys() == tensors.keys()
        for k, v in tensors.items():
            assert loaded[k].dtype == v.dtype and loaded[k].shape == v.shape, k
            assert np.array_equal(loaded[k], v), k


def test_scaler_state_matches_sklearn():
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(4)
    x = rng.normal(3, 2, size=(40, 6))
    x[rng.random(x.shape) < 0.1] = np.nan
    x[:, 2] = 5.0  # constant column: scale 1
    names = [f"f{i}" for i in range(6)]
    ours = fit_standard_scaler(x, names)
    ref = StandardScaler().fit(x)
    for key, attr in (("mean", "mean_"), ("var", "var_"), ("scale", "scale_"),
                      ("n_samples_seen", "n_samples_seen_")):
        np.testing.assert_allclose(ours[key], getattr(ref, attr), rtol=1e-12, atol=1e-12)
    test = rng.normal(3, 2, size=(7, 6))
    np.testing.assert_allclose(apply_standard_scaler(ours, test), ref.transform(test),
                               rtol=1e-12, atol=1e-12)


def test_synthetic_folder_matches_jax(tmp_path):
    kwargs = dict(n_train=20, n_test=11, n_features={"gex": 15, "cnv": 9}, seed=3)
    jax_write(str(tmp_path / "jax"), **kwargs)
    assert write_synthetic_folder(str(tmp_path / "torch"), **kwargs) == ["gex", "cnv"]
    for split in ("train", "test"):
        for name in ("gex", "cnv", "clin"):
            a = pd.read_csv(tmp_path / "torch" / split / f"{name}.csv", index_col=0)
            b = pd.read_csv(tmp_path / "jax" / split / f"{name}.csv", index_col=0)
            pd.testing.assert_frame_equal(a, b, check_exact=True)
            assert a.isna().to_numpy().any() == b.isna().to_numpy().any()


def test_importer_matches_jax(trained):
    ours = DataImporterInference(trained["test"], trained["artifacts"]).import_data()
    theirs = JaxImporter(trained["test"], trained["artifacts"]).import_data()
    assert ours.samples == theirs.samples
    assert ours.features == theirs.features
    assert ours.variable_types == theirs.variable_types
    assert list(ours.dat) == list(theirs.dat)
    for m in ours.dat:
        assert ours.dat[m].dtype == np.float32
        np.testing.assert_array_equal(ours.dat[m], theirs.dat[m])
    assert ours.ann.keys() == theirs.ann.keys()
    for v in ours.ann:
        np.testing.assert_array_equal(ours.ann[v], theirs.ann[v])
    assert (ours.ann["subtype"] == -1).any()
    assert ours.label_mappings == theirs.label_mappings


@pytest.mark.parametrize("labelled", [True, False])
def test_default_layout_clis_agree(trained, tmp_path, labelled):
    """Without clin.csv the cohort is unlabeled: predictions, no metrics."""
    test = trained["test"]
    if not labelled:
        test = str(tmp_path / "unlabeled")
        os.makedirs(test)
        for name in ("gex.csv", "cnv.csv"):
            shutil.copy(os.path.join(trained["test"], name), test)
    args = (trained["weights"], trained["artifacts"], test)
    assert main(_infer_args(*args, str(tmp_path / "torch"))) == 0
    assert jax_main(_infer_args(*args, str(tmp_path / "jax"))) == 0
    _assert_tables_agree(str(tmp_path / "torch"), str(tmp_path / "jax"))


TARGETS = {
    "categorical": dict(target_variables=["subtype"]),
    "regression_and_survival": dict(
        target_variables=["age"], surv_event_var="OS_STATUS", surv_time_var="OS_MONTHS"
    ),
}


@pytest.mark.parametrize("targets", sorted(TARGETS))
def test_fused_layout_clis_agree(trained, tmp_path, targets):
    """A fused_kernels model written by the JAX package's save functions."""
    with open(trained["config"]) as fh:
        config = json.load(fh)
    if targets != "categorical":
        config["output_dims"] = {"age": 1, "OS_STATUS": 1}
        config["variable_types"] = {"age": "numerical", "OS_STATUS": "numerical"}
    artifacts = jax_inference.load_and_sniff_artifacts(trained["artifacts"])
    ds = jax_inference.build_dataset_namespace(config, artifacts)
    cfg = {k: config[k] for k in ("latent_dim", "hidden_dim_factor",
                                  "supervisor_hidden_dim", "lr", "epochs", "batch_size")}
    cfg["fused_kernels"] = True
    model = JaxDirectPred(cfg, ds, **TARGETS[targets])
    model.init_params(ds, seed=11)
    rng = np.random.default_rng(11)
    model.batch_stats = {
        blk: {"mean": rng.normal(0, 0.3, s["mean"].shape).astype(np.float32),
              "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
        for blk, s in model.batch_stats.items()
    }
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    weights = str(model_dir / "fused.final_model.safetensors")
    jax_inference.save_model(model, weights)
    jax_inference.save_model_config(model, str(model_dir / "fused.final_model_config.json"))
    art = str(model_dir / "fused.artifacts.json")
    jax_inference.write_artifacts(artifacts, art, as_json=True)

    assert main(_infer_args(weights, art, trained["test"], str(tmp_path / "torch"))) == 0
    assert jax_main(_infer_args(weights, art, trained["test"], str(tmp_path / "jax"))) == 0
    _assert_tables_agree(str(tmp_path / "torch"), str(tmp_path / "jax"))


def test_port_saved_model_loads_in_jax(trained, tmp_path):
    model = inference.reconstruct_model(
        trained["weights"], trained["config"], trained["artifacts"], device="cpu"
    )
    weights = str(tmp_path / "port.final_model.safetensors")
    config = str(tmp_path / "port.final_model_config.json")
    art = str(tmp_path / "port.artifacts.json")
    inference.save_model(model, weights)
    inference.save_model_config(model, config)
    inference.write_artifacts(inference.load_and_sniff_artifacts(trained["artifacts"]), art)
    assert inference.check_model_type(weights) == "safetensors"

    jax_model = jax_inference.reconstruct_model(weights, config, art)
    ours = model.predict(DataImporterInference(trained["test"], art).import_data())
    theirs = jax_model.predict(JaxImporter(trained["test"], art).import_data())
    assert ours.keys() == theirs.keys()
    for v in ours:
        np.testing.assert_allclose(ours[v], theirs[v], rtol=1e-4, atol=1e-5)
    with open(art) as a, open(trained["artifacts"]) as b:
        assert json.load(a) == json.load(b)


def test_unported_paths_raise(trained, tmp_path):
    args = _infer_args(trained["weights"], trained["artifacts"], trained["test"],
                       str(tmp_path))
    with pytest.raises(ValueError, match="tpu"):
        main(args[:-1] + ["tpu"])

    with open(trained["config"]) as fh:
        config = json.load(fh)
    config["model_class"] = "GNN"
    gnn_config = tmp_path / "gnn.final_model_config.json"
    gnn_config.write_text(json.dumps(config))
    # a GNN rebuilds its node tensor from the graph its weights embed
    with pytest.raises(ValueError, match="interaction graph"):
        inference.reconstruct_model(trained["weights"], str(gnn_config),
                                    trained["artifacts"], device="cpu")
