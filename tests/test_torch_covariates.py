"""Covariates and early fusion (``flexynesis_torch/data/covariates.py`` and
both importers) against the JAX package, which reads clin.csv with pandas:

* each clinical column's type is the one pandas' dtype gives it: numbers
  (blanks around them, NaN, inf, all-empty), booleans with and without a
  missing cell, text, text that looks numeric (exactly);
* ``create_covariate_matrix`` gives JAX's column names, values and groups
  for categorical (text, booleans with NaN, a missing level), numerical
  (median-filled, booleans as 0/1) and mixed covariate lists, on the whole
  table and on a subset of its rows typed by the whole file (values
  exactly: 0/1 and medians of the same float64 cells);
* the training importer with covariates and with early fusion gives JAX's
  features, ``covariate_columns`` (harmonised: a level only one split has
  goes) and, by sample, matrices (rtol/atol 1e-5, as the omics blocks);
* the inference importer, from JAX's artifacts, gives JAX's samples,
  features and matrices (rtol/atol 1e-5) for the same folder, rebuilding the
  covariates (a level the test cohort lacks zero-filled, an unseen one
  dropped), and both raise where a covariate's trained columns cannot be
  rebuilt at all;
* the CLI trains with ``--fusion_type early --covariates age`` (the config's
  layers name ``all``) and serves the model again, mirroring JAX's
  ``test_early_fusion_and_covariates``; the JAX inference CLI serves the
  port's model alike (rtol 1e-4, atol 1e-5)."""

import csv
import json
import os

import numpy as np
import pandas as pd
import pytest

from flexynesis_tpu import inference as jax_inference
from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_tpu.data import covariates as jax_cov
from flexynesis_tpu.data.importer import DataImporter as JaxImporter
from flexynesis_tpu.data.inference_importer import DataImporterInference as JaxInference
from flexynesis_torch import inference
from flexynesis_torch.__main__ import main
from flexynesis_torch.data import covariates
from flexynesis_torch.data.importer import Clinical, DataImporter
from flexynesis_torch.data.inference_importer import DataImporterInference
from flexynesis_torch.utils.csvio import read_matrix, read_table
from flexynesis_torch.utils.synthetic import write_synthetic_folder

CLIN = {
    "text": ["x", "y", "", "x", "z", "y", "x", "NA"],
    "number": ["1.5", "", "2.5", "3", " 4", "inf", "2", "0.5"],
    "integer": ["1", "2", "3", "4", "5", "6", "7", "8"],
    "boolean": ["True", "False", "TRUE", "false", "True", "True", "False", "true"],
    "boolean_na": ["True", "", "False", "True", "False", "NA", "True", "True"],
    "empty": [""] * 8,
    "numeric_text": ["1", "2", "1_000", "3", "4", "5", "6", "7"],
    "mixed": ["1", "2", "a", "3", "", "b", "1", "2"],
}
SAMPLES = [f"S{i}" for i in range(8)]


@pytest.fixture(scope="module")
def clin_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("clin") / "clin.csv"
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["", *CLIN])
        for i, s in enumerate(SAMPLES):
            w.writerow([s, *(CLIN[c][i] for c in CLIN)])
    return str(path)


def _tables(clin_file):
    return Clinical(*read_table(clin_file)), pd.read_csv(clin_file, index_col=0)


def test_variable_types_follow_pandas(clin_file):
    ours, df = _tables(clin_file)
    assert covariates.get_variable_types(ours) == jax_cov.get_variable_types(df)


COVARIATE_SETS = [["text"], ["number"], ["integer"], ["boolean"], ["boolean_na"],
                  ["mixed"], ["text", "number", "boolean_na"], ["boolean", "mixed", "integer"]]


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("covs", COVARIATE_SETS, ids="-".join)
def test_create_covariate_matrix_matches_jax(clin_file, covs, subset):
    ours, df = _tables(clin_file)
    types = covariates.get_variable_types(ours)
    jtypes = jax_cov.get_variable_types(df)
    if subset:  # rows dropped after reading: the whole file's types still hold
        rows = ["S1", "S2", "S4", "S6", "S7"]
        ours, df = ours.subset(rows), df.loc[rows]
    groups, jgroups = {}, {}
    names, values = covariates.create_covariate_matrix(covs, types, ours, groups_out=groups)
    want = jax_cov.create_covariate_matrix(covs, jtypes, df, groups_out=jgroups)
    assert names == list(want.index)
    np.testing.assert_array_equal(values, want.T.to_numpy(dtype=float))
    assert groups == jgroups


# ----------------------------------------------------------- the folder


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A synthetic folder whose clin.csv files gain a categorical ``site``
    (train A/B/C, test A/B/D), a boolean ``smoker`` with missing cells, and
    missing ages."""
    path = tmp_path_factory.mktemp("cov") / "data"
    write_synthetic_folder(str(path), n_train=50, n_test=24,
                           n_features={"gex": 40, "cnv": 24}, n_classes=3, seed=21)
    rng = np.random.default_rng(2)
    for split, levels in (("train", "ABC"), ("test", "ABD")):
        fp = path / split / "clin.csv"
        names, columns, rows = read_table(str(fp))
        with open(fp, "w", newline="") as fh:
            w = csv.writer(fh)
            w.writerow(["", *columns, "site", "smoker"])
            for i, (name, row) in enumerate(zip(names, rows)):
                if i % 7 == 3:
                    row[columns.index("age")] = ""
                smoker = "" if i % 5 == 2 else ("True" if rng.random() < 0.5 else "False")
                w.writerow([name, *row, levels[rng.integers(0, 3)], smoker])
    return path


OPTIONS = dict(data_types=["gex", "cnv"], top_percentile=50, min_features=10,
               correlation_threshold=0.5, variance_threshold=0.01)
IMPORTS = [(["age"], False), (["age"], True), (["site", "age"], False),
           (["site", "smoker", "age"], True)]


def _import(folder, covs, early):
    opts = dict(OPTIONS, covariates=covs, concatenate=early)
    ours = DataImporter(str(folder), device="cpu", **opts)
    theirs = JaxImporter(str(folder), **opts)
    return ours, ours.import_data(), theirs, theirs.import_data()


def _same_by_sample(ds, jds):
    assert sorted(ds.samples) == sorted(jds.samples)
    pos = {s: i for i, s in enumerate(jds.samples)}
    order = [pos[s] for s in ds.samples]
    assert set(ds.dat) == set(jds.dat)
    for layer, mat in ds.dat.items():
        assert ds.features[layer] == list(jds.features[layer]), layer
        np.testing.assert_allclose(mat, jds.dat[layer][order], rtol=1e-5, atol=1e-5,
                                   err_msg=layer)


@pytest.mark.parametrize("covs,early", IMPORTS)
def test_training_importer_matches_jax(folder, covs, early):
    ours, (train, test), theirs, (jtrain, jtest) = _import(folder, covs, early)
    _same_by_sample(train, jtrain)
    _same_by_sample(test, jtest)
    assert ours.covariate_columns == theirs.covariate_columns
    assert ours.train_features == {k: list(v) for k, v in theirs.train_features.items()}
    if early:
        assert list(train.dat) == ["all"] and train.features["all"][-1] == "age"
    else:
        assert "covariates" in train.dat
    if "site" in covs:  # C only in train, D only in test: neither is kept
        assert ours.covariate_columns["site"] == ["site_A", "site_B"]


@pytest.mark.parametrize("covs,early", IMPORTS)
def test_inference_importer_matches_jax(folder, covs, early, tmp_path):
    ours, _, theirs, _ = _import(folder, covs, early)
    args = (["gex", "cnv"], ["subtype"])
    a_path, b_path = str(tmp_path / "a.json"), str(tmp_path / "b.json")
    inference.write_artifacts(inference.build_artifacts(ours, *args, covariates=covs), a_path)
    jax_inference.write_artifacts(jax_inference.build_artifacts(theirs, *args, covariates=covs),
                                  b_path, as_json=True)
    a, b = (json.load(open(p)) for p in (a_path, b_path))
    for key in ("original_modalities", "feature_lists", "covariate_vars", "covariate_columns"):
        assert a[key] == b[key], key
    assert sorted(a["data_types"]) == sorted(b["data_types"])
    test = str(folder / "test")
    ds = DataImporterInference(test, b_path).import_data()
    jds = JaxInference(test, b_path).import_data()
    assert ds.samples == list(jds.samples)
    _same_by_sample(ds, jds)
    # the port's own artifacts give the same cohort
    mine = DataImporterInference(test, a_path).import_data()
    assert mine.samples == ds.samples
    for layer, mat in mine.dat.items():
        np.testing.assert_allclose(mat, ds.dat[layer], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("early", [False, True])
@pytest.mark.parametrize("rename", ["all", "B"])
def test_covariate_rebuild_against_jax(folder, tmp_path, early, rename):
    """Every test ``site`` renamed: both raise (none of its trained columns
    can be rebuilt); only B renamed: ``site_B`` zero-fills, as in JAX."""
    _, _, theirs, _ = _import(folder, ["site", "age"], early)
    path = str(tmp_path / "b.json")
    jax_inference.write_artifacts(
        jax_inference.build_artifacts(theirs, ["gex", "cnv"], ["subtype"],
                                      covariates=["site", "age"]), path, as_json=True)
    test = tmp_path / "test"
    test.mkdir()
    for name in ("gex.csv", "cnv.csv"):
        (test / name).write_text((folder / "test" / name).read_text())
    names, columns, rows = read_table(str(folder / "test" / "clin.csv"))
    j = columns.index("site")
    with open(test / "clin.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["", *columns])
        for name, row in zip(names, rows):
            if rename == "all" or row[j] == "B":
                row[j] = "X" + row[j]  # a level the training never saw
            w.writerow([name, *row])
    if rename == "all":
        for importer in (DataImporterInference, JaxInference):
            with pytest.raises(ValueError, match="none of 'site'"):
                importer(str(test), path).import_data()
        return
    ds = DataImporterInference(str(test), path).import_data()
    _same_by_sample(ds, JaxInference(str(test), path).import_data())
    layer = "all" if early else "covariates"
    assert not ds.dat[layer][:, ds.features[layer].index("site_B")].any()


# ---------------------------------------------------------------- the CLI


def test_cli_early_fusion_and_covariates(folder, tmp_path):
    space = tmp_path / "space.yaml"
    space.write_text(
        "DirectPred:\n"
        "  - {type: Categorical, categories: [16], name: latent_dim}\n"
        "  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}\n"
        "  - {type: Categorical, categories: [0.01], name: lr}\n"
        "  - {type: Categorical, categories: [8], name: supervisor_hidden_dim}\n"
        "  - {type: Categorical, categories: [5], name: epochs}\n"
        "  - {type: Categorical, categories: [32], name: batch_size}\n"
        "  - {type: Categorical, categories: [true], name: fused_kernels}\n")
    out = tmp_path / "fusion"
    assert main(["--data_path", str(folder), "--model_class", "DirectPred",
                 "--data_types", "gex,cnv", "--target_variables", "subtype",
                 "--fusion_type", "early", "--covariates", "age",
                 "--config_path", str(space), "--hpo_iter", "1", "--features_min", "10",
                 "--disable_marker_finding", "--safetensors", "--device", "cpu",
                 "--outdir", str(out), "--prefix", "job"]) == 0
    cfg = json.load(open(out / "job.final_model_config.json"))
    assert "all" in cfg["layers"]
    served = {}
    for name, entry in (("torch", main), ("jax", jax_main)):
        inf = tmp_path / f"inf_{name}"
        assert entry(["--pretrained_model", str(out / "job.final_model.safetensors"),
                      "--artifacts", str(out / "job.artifacts.json"),
                      "--data_path_test", str(folder / "test"), "--outdir", str(inf),
                      "--prefix", "inf", "--disable_marker_finding",
                      "--device", "cpu"]) == 0
        samples, _, emb = read_matrix(str(inf / "inf.embeddings_test.csv"))
        _, cols, rows = read_table(str(inf / "inf.predicted_labels.csv"))
        assert len(rows) > 0
        served[name] = (samples, emb, [float(r[cols.index("probability")]) for r in rows])
    (s1, e1, p1), (s2, e2, p2) = served["torch"], served["jax"]
    assert s1 == s2
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)
    assert os.path.exists(out / "job.artifacts.json")
