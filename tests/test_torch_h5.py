"""The port's HDF5 path (``utils/hdf5.py``, ``data/h5.py``, ``csv_to_h5.py``)
against h5py and the JAX package:

* the reader gives h5py's arrays bit for bit on files from JAX's
  ``convert_csv_to_h5`` at several chunk sizes (one with more than 64
  chunks, whose chunk B-tree has two levels), on a contiguous file, on
  NULLTERM and NULLPAD strings and on an empty matrix; and the JAX
  importer's ``_read_h5_as_dataframe`` frames;
* it refuses a gzip file by the filter's name, and a file of another
  superblock version;
* the port's converter writes files h5py and the JAX importer read, with the
  bits the port's CSV reader gives, from a file or a folder (``--exclude``);
* the port's ``H5DataImporter`` imports what its CSV importer imports from
  the same folder (exactly) and what JAX's ``H5DataImporter`` imports
  (features equal, matrices within rtol/atol 1e-5), with a split falling
  back to CSV; ``folder_has_h5``;
* the training CLI on an ``.h5`` folder selects the features and predicts
  what it does on the same folder in CSV (exactly)."""

import os
import re
import shutil

import h5py
import numpy as np
import pytest

from flexynesis_tpu.csv_to_h5 import convert_csv_to_h5 as jax_convert
from flexynesis_tpu.data.h5 import H5DataImporter as JaxH5Importer
from flexynesis_torch.__main__ import main
from flexynesis_torch.csv_to_h5 import convert_csv_to_h5, main as convert_main
from flexynesis_torch.data.fastcsv import read_matrix_csv
from flexynesis_torch.data.h5 import H5DataImporter, folder_has_h5
from flexynesis_torch.data.importer import DataImporter
from flexynesis_torch.utils.csvio import read_table
from flexynesis_torch.utils.hdf5 import read_datasets, read_matrix_h5
from flexynesis_torch.utils.synthetic import write_synthetic_folder

N_SAMPLES, N_FEATURES = 37, 301


def _write_csv(path, n=N_SAMPLES, F=N_FEATURES, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(F, n)).astype(np.float32)
    with open(path, "w") as fh:
        fh.write("," + ",".join(f"S{i}" for i in range(n)) + "\n")
        for i in range(F):
            fh.write(f"g{i}," + ",".join(repr(float(v)) for v in X[i]) + "\n")
    return path


def _h5py_arrays(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][:] for k in f}


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.fixture(scope="module")
def csv_file(tmp_path_factory):
    return _write_csv(tmp_path_factory.mktemp("h5") / "m.csv")


def _chunk_btree_levels(path) -> set:
    """The levels of the file's chunk B-tree nodes ("TREE", node type 1)."""
    data = path.read_bytes()
    return {data[m.end()] for m in re.finditer(b"TREE\x01", data)}


@pytest.mark.parametrize("chunksize", [3, 7, 100, 2000])
def test_reader_matches_h5py_on_jax_files(csv_file, tmp_path, chunksize):
    dst = tmp_path / f"m{chunksize}.h5"
    jax_convert(csv_file, dst, chunksize=chunksize)
    _same(read_datasets(str(dst)), _h5py_arrays(dst))
    if chunksize == 3:  # 101 chunks: more than one node holds them
        with h5py.File(dst, "r") as f:
            assert f["matrix"].id.get_num_chunks() == 101
        assert _chunk_btree_levels(dst) == {0, 1}
    frame = JaxH5Importer._read_h5_as_dataframe(str(dst))
    features, samples, mat = read_matrix_h5(str(dst))
    assert features == list(frame.index) and samples == list(frame.columns)
    assert mat.tobytes() == np.ascontiguousarray(frame.to_numpy()).tobytes()


def test_reader_matches_h5py_contiguous_and_strings(tmp_path):
    rng = np.random.default_rng(1)
    path = tmp_path / "c.h5"
    names = [b"a", b"bb", b"", b"dddd"]
    with h5py.File(path, "w") as f:
        f.create_dataset("matrix", data=rng.normal(size=(5, 4)).astype(np.float32))
        f.create_dataset("nullpad", data=np.array(names, dtype="S"))
        tid = h5py.h5t.C_S1.copy()
        tid.set_size(5)
        tid.set_strpad(h5py.h5t.STR_NULLTERM)
        space = h5py.h5s.create_simple((4,))
        dset = h5py.h5d.create(f.id, b"nullterm", tid, space)
        dset.write(h5py.h5s.ALL, h5py.h5s.ALL, np.array(names, dtype="S5"))
        f.create_dataset("empty", shape=(0, 3), dtype=np.float32)
        f.create_dataset("unwritten", shape=(2, 3), dtype=np.float32)
        assert f["matrix"].chunks is None
    got, want = read_datasets(str(path)), _h5py_arrays(path)
    assert [s for s in got["nullterm"]] == names
    _same(got, want)


def test_reader_matches_h5py_on_an_empty_matrix(tmp_path):
    csv = tmp_path / "e.csv"
    csv.write_text(",S0,S1\n")
    jax_convert(csv, tmp_path / "jax.h5")
    convert_csv_to_h5(csv, tmp_path / "port.h5")
    for name in ("jax.h5", "port.h5"):
        got = read_datasets(str(tmp_path / name))
        _same(got, _h5py_arrays(tmp_path / name))
        assert got["matrix"].shape == (2, 0)


def test_filters_and_other_versions_are_refused(tmp_path):
    gz = tmp_path / "gz.h5"
    with h5py.File(gz, "w") as f:
        f.create_dataset("matrix", data=np.ones((10, 10), np.float32), compression="gzip")
    with pytest.raises(ValueError, match="deflate"):
        read_datasets(str(gz))
    latest = tmp_path / "latest.h5"
    with h5py.File(latest, "w", libver="latest") as f:
        f.create_dataset("matrix", data=np.ones((2, 2), np.float32))
    with pytest.raises(ValueError, match="superblock version"):
        read_datasets(str(latest))
    other = tmp_path / "f64.h5"
    with h5py.File(other, "w") as f:
        f.create_dataset("matrix", data=np.ones((2, 2), np.float64))
    with pytest.raises(ValueError, match="float32"):
        read_datasets(str(other))


@pytest.mark.parametrize("chunksize", [1, 50, 2000])
def test_port_files_read_by_h5py_and_jax(csv_file, tmp_path, chunksize):
    dst = convert_csv_to_h5(csv_file, tmp_path / "p.h5", chunksize=chunksize)
    features, samples, mat = read_matrix_csv(str(csv_file))
    with h5py.File(dst, "r") as f:
        assert f["matrix"].dtype == np.float32 and f["matrix"].shape == (N_SAMPLES, N_FEATURES)
        assert f["sample_ids"].dtype.kind == "S" and f["feature_names"].dtype.kind == "S"
        assert f["matrix"][:].tobytes() == np.ascontiguousarray(mat.T).tobytes()
    frame = JaxH5Importer._read_h5_as_dataframe(str(dst))
    assert list(frame.index) == features and list(frame.columns) == samples
    assert frame.to_numpy().tobytes() == mat.tobytes()
    jax_convert(csv_file, tmp_path / "j.h5")
    _same(read_datasets(str(dst)), _h5py_arrays(tmp_path / "j.h5"))
    assert not [p for p in tmp_path.iterdir() if p.name.startswith(".")]


def test_converter_cli_over_a_folder(tmp_path):
    src = tmp_path / "in"
    write_synthetic_folder(str(src), n_train=20, n_test=10,
                           n_features={"gex": 30, "cnv": 12}, seed=3)
    convert_main(["--input", str(src / "train"), "--output", str(tmp_path / "out"),
                  "--exclude", "clin,cnv", "--chunksize", "7"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == ["gex.h5"]
    features, samples, mat = read_matrix_h5(str(tmp_path / "out" / "gex.h5"))
    want = read_matrix_csv(str(src / "train" / "gex.csv"))
    assert (features, samples) == (want[0], want[1])
    assert mat.tobytes() == want[2].tobytes()


OPTIONS = dict(data_types=["gex", "cnv"], top_percentile=50, min_features=10,
               correlation_threshold=0.5, variance_threshold=0.01)


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    base = tmp_path_factory.mktemp("folders")
    csv = base / "csv"
    write_synthetic_folder(str(csv), n_train=60, n_test=30,
                           n_features={"gex": 80, "cnv": 50}, n_classes=4, seed=11)
    h5 = base / "h5"
    shutil.copytree(csv, h5)
    for split in ("train", "test"):
        for layer in ("gex", "cnv"):
            if (split, layer) == ("test", "cnv"):
                continue  # this layer of the test split falls back to CSV
            convert_csv_to_h5(h5 / split / f"{layer}.csv", h5 / split / f"{layer}.h5",
                              chunksize=16)
            os.remove(h5 / split / f"{layer}.csv")
    return csv, h5


def test_folder_has_h5(folders):
    csv, h5 = folders
    assert folder_has_h5(str(h5), ["gex"]) and folder_has_h5(str(h5), ["cnv"])
    assert not folder_has_h5(str(csv), ["gex", "cnv"])
    assert not folder_has_h5(str(h5), ["mut"])


def test_h5_importer_matches_the_csv_importer_and_jax(folders):
    csv, h5 = folders
    ours = H5DataImporter(str(h5), device="cpu", **OPTIONS).import_data()
    plain = DataImporter(str(csv), device="cpu", **OPTIONS).import_data()
    for a, b in zip(ours, plain):
        assert a.samples == b.samples and a.features == b.features
        for layer in a.dat:
            assert a.dat[layer].tobytes() == b.dat[layer].tobytes()
        for var in a.ann:
            np.testing.assert_array_equal(a.ann[var], b.ann[var])
    theirs = JaxH5Importer(str(h5), **OPTIONS).import_data()
    for a, b in zip(ours, theirs):
        assert a.features == {k: list(v) for k, v in b.features.items()}
        pos = {s: i for i, s in enumerate(b.samples)}
        order = [pos[s] for s in a.samples]
        for layer in a.dat:
            np.testing.assert_allclose(a.dat[layer], np.asarray(b.dat[layer])[order],
                                       rtol=1e-5, atol=1e-5)


def test_h5_validation_names_the_missing_layer(folders, tmp_path):
    _, h5 = folders
    broken = tmp_path / "broken"
    shutil.copytree(h5, broken)
    os.remove(broken / "train" / "gex.h5")
    with pytest.raises(ValueError, match="gex.h5 or gex.csv"):
        H5DataImporter(str(broken), device="cpu", **OPTIONS).import_data()


CONFIG = """DirectPred:
  - {type: Categorical, categories: [8], name: latent_dim}
  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.001], name: lr}
  - {type: Categorical, categories: [6], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [3], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
  - {type: Categorical, categories: [true], name: fused_kernels}
"""


def test_training_cli_on_h5_matches_csv(folders, tmp_path):
    csv, h5 = folders
    config = tmp_path / "hpo.yaml"
    config.write_text(CONFIG)
    out = {}
    for name, data in (("csv", csv), ("h5", h5)):
        out[name] = tmp_path / name
        assert main(["--data_path", str(data), "--model_class", "DirectPred",
                     "--data_types", "gex,cnv", "--target_variables", "subtype",
                     "--config_path", str(config), "--hpo_iter", "1", "--features_min", "10",
                     "--features_top_percentile", "50", "--safetensors",
                     "--disable_marker_finding", "--device", "cpu",
                     "--outdir", str(out[name]), "--prefix", "job"]) == 0
    for table in ("feature_logs.gex", "feature_logs.cnv", "predicted_labels", "stats"):
        a = read_table(str(out["csv"] / f"job.{table}.csv"))
        b = read_table(str(out["h5"] / f"job.{table}.csv"))
        assert a == b, table


FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "h5")


def test_h5py_fixture_reads_as_its_csv_twin():
    """``fixtures/h5/gex.h5`` (JAX's converter through h5py, 70 one-column
    chunks: a two-level chunk B-tree) against h5py and its CSV twin; the
    card's machine, which has no h5py, reads the same file in chip_smoke."""
    path = os.path.join(FIXTURE, "gex.h5")
    _same(read_datasets(path), _h5py_arrays(path))
    features, samples, mat = read_matrix_h5(path)
    want = read_matrix_csv(os.path.join(FIXTURE, "gex.csv"))
    assert (features, samples) == (want[0], want[1])
    assert mat.tobytes() == want[2].tobytes()
    with open(path, "rb") as fh:
        data = fh.read()
    assert {data[m.end()] for m in re.finditer(b"TREE\x01", data)} == {0, 1}
