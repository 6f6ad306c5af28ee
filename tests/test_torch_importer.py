"""The port's training-mode DataImporter (numpy, Laplacian scores in torch)
against the JAX package's (pandas, sklearn, JAX) on one synthetic folder.

Samples are compared by ID: the JAX importer orders them by Python set
iteration, which changes with the hash seed. Checked: selected features (in
order), the merged feature logs, scaled matrices, encoded labels,
label_mappings and the JSON artifacts.

Tolerances: Laplacian scores rtol=1e-5 and atol 1e-5 times the largest
score (f32 on both sides, different summation orders; scores cross zero); variances rtol=1e-6 (float32 values); scaled matrices and
scaler state rtol=1e-5, atol=1e-5."""

import json
import math
import os

import numpy as np
import pytest

from flexynesis_tpu import inference as jax_inference
from flexynesis_tpu.data.importer import DataImporter as JaxImporter
from flexynesis_torch import inference
from flexynesis_torch.data.importer import DataImporter, merge_logs
from flexynesis_torch.utils.synthetic import write_synthetic_folder

OPTIONS = dict(data_types=["gex", "cnv"], top_percentile=50, min_features=10,
               correlation_threshold=0.5, variance_threshold=0.01)


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("importer") / "data")
    write_synthetic_folder(path, n_train=60, n_test=30,
                           n_features={"gex": 80, "cnv": 50}, n_classes=4, seed=11)
    ours = DataImporter(path, device="cpu", **OPTIONS)
    theirs = JaxImporter(path, **OPTIONS)
    return ours, ours.import_data(), theirs, theirs.import_data()


def _by_sample(ds):
    return {s: i for i, s in enumerate(ds.samples)}


def test_selected_features_match(imported):
    ours, (train, test), theirs, (jtrain, jtest) = imported
    assert set(train.features) == set(jtrain.features)
    for layer in jtrain.features:
        assert train.features[layer] == list(jtrain.features[layer])
        assert test.features[layer] == list(jtest.features[layer])
    assert ours.train_features == {k: list(v) for k, v in theirs.train_features.items()}


def _cell(v):
    if v is None or (isinstance(v, float) and math.isnan(v)):
        return None
    if isinstance(v, (bool, np.bool_)):
        return bool(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    return v


@pytest.mark.parametrize("layer", ["gex", "cnv"])
def test_feature_logs_match(imported, layer):
    ours, _, theirs, _ = imported
    rows = ours.feature_logs[layer]
    df = theirs.feature_logs[layer]
    assert list(rows[0]) == list(df.columns)
    assert [r["feature"] for r in rows] == list(df["feature"])
    for col in df.columns:
        got = [_cell(r[col]) for r in rows]
        want = [_cell(v) for v in df[col].tolist()]
        if col in ("laplacian_score", "variance", "na_percent", "correlation_score"):
            g = np.array([np.nan if v is None else v for v in got], dtype=float)
            w = np.array([np.nan if v is None else v for v in want], dtype=float)
            if col == "laplacian_score":  # normwise: scores cross zero
                tol = dict(rtol=1e-5, atol=1e-5 * np.nanmax(np.abs(w)))
            else:
                tol = dict(rtol=1e-6, atol=0)
            np.testing.assert_allclose(g, w, err_msg=col, **tol)
        else:
            assert got == want, col


def test_matrices_and_labels_match_by_sample(imported):
    _, (train, test), _, (jtrain, jtest) = imported
    for ds, jds in ((train, jtrain), (test, jtest)):
        assert sorted(ds.samples) == sorted(jds.samples)
        order = [_by_sample(jds)[s] for s in ds.samples]
        for layer, mat in ds.dat.items():
            assert mat.dtype == np.float32
            np.testing.assert_allclose(mat, jds.dat[layer][order], rtol=1e-5, atol=1e-5)
        assert set(ds.ann) == set(jds.ann)
        for var, codes in ds.ann.items():
            np.testing.assert_array_equal(codes, jds.ann[var][order], err_msg=var)
        assert ds.variable_types == jds.variable_types
        assert ds.label_mappings.keys() == jds.label_mappings.keys()
        for var, mapping in ds.label_mappings.items():
            assert [_cell(v) for v in mapping.values()] == \
                [_cell(v) for v in jds.label_mappings[var].values()]


def test_artifacts_match(imported, tmp_path):
    ours, _, theirs, _ = imported
    args = (["gex", "cnv"], ["subtype"])
    inference.write_artifacts(inference.build_artifacts(ours, *args), str(tmp_path / "a.json"))
    jax_inference.write_artifacts(jax_inference.build_artifacts(theirs, *args),
                                  str(tmp_path / "b.json"), as_json=True)
    a, b = (json.load(open(tmp_path / n)) for n in ("a.json", "b.json"))
    assert sorted(a["data_types"]) == sorted(b["data_types"])
    for key in ("original_modalities", "target_variables", "feature_lists",
                "label_encoders", "covariate_vars", "join_key", "schema_version"):
        assert a[key] == b[key], key
    for layer, s in a["transforms"].items():
        t = b["transforms"][layer]
        assert s["feature_names_in"] == t["feature_names_in"]
        assert s["n_samples_seen"] == t["n_samples_seen"]
        for key in ("mean", "scale", "var"):
            np.testing.assert_allclose(s[key], t[key], rtol=1e-5, atol=1e-5, err_msg=key)


def test_downsample_and_feature_restriction_match_jax(imported, tmp_path):
    ours, _, _, _ = imported
    keep = tmp_path / "keep.txt"
    keep.write_text("\n".join([f"gex_f{i}" for i in range(0, 80, 2)]
                           + [f"cnv_f{i}" for i in range(12)] + ["nope"]))
    opts = dict(OPTIONS, downsample=40, restrict_to_features=str(keep))
    (train, test) = DataImporter(ours.path, device="cpu", **opts).import_data()
    (jtrain, jtest) = JaxImporter(ours.path, **opts).import_data()
    for ds, jds in ((train, jtrain), (test, jtest)):
        assert sorted(ds.samples) == sorted(jds.samples)
        assert ds.features == {k: list(v) for k, v in jds.features.items()}
    assert len(train.samples) <= 40


def test_merge_logs_is_an_outer_merge():
    left = [{"feature": "b", "x": 1, "selected": True},
            {"feature": "a", "x": 2, "selected": False}]
    right = [{"feature": "b", "s": 0.5, "selected": True}]
    assert merge_logs(left, right) == [
        {"feature": "a", "x": 2, "selected_cleanup": False, "s": None,
         "selected_laplacian": None},
        {"feature": "b", "x": 1, "selected_cleanup": True, "s": 0.5,
         "selected_laplacian": True},
    ]


def test_not_ported_options_raise(tmp_path):
    """HDF5 folders raised here before they were ported: the CSV importer now
    asks for the CSV files (the CLI routes such folders to
    ``data/h5.py::H5DataImporter``, ``tests/test_torch_h5.py``), and the
    HDF5 importer refuses a file that is not HDF5."""
    from flexynesis_torch.data.h5 import H5DataImporter

    for split in ("train", "test"):
        os.makedirs(tmp_path / split)
        (tmp_path / split / "gex.h5").write_bytes(b"")
        (tmp_path / split / "clin.csv").write_text(",x\ns1,1\n")
    with pytest.raises(ValueError, match="gex.csv"):
        DataImporter(str(tmp_path), ["gex"], device="cpu").import_data()
    with pytest.raises(ValueError, match="HDF5"):
        H5DataImporter(str(tmp_path), ["gex"], device="cpu").import_data()


@pytest.mark.parametrize("device", ["auto", "cuda"])
def test_card_devices_raise_without_cuda(device, tmp_path, monkeypatch):
    """Feature selection runs on the card unless the caller asks for the CPU."""
    from flexynesis_torch.data import feature_selection

    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataImporter(str(tmp_path), ["gex"], device=device)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DataImporter(str(tmp_path), ["gex"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feature_selection.laplacian_score(np.ones((8, 3), dtype=np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        feature_selection.correlation_matrix(np.ones((8, 3), dtype=np.float32), device)
