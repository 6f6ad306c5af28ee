"""The port's CSV readers against the JAX package's, on the CPU.

* ``flexynesis_torch.data.fastcsv.read_matrix_csv`` (the port's build of the
  C++ parser, or its Python reader where the parser refuses a file) equals
  ``flexynesis_tpu.data.fastcsv.read_matrix_csv`` (the same parser, or pandas)
  exactly: row and column names, and the float32 bits of every value, on
  every file of ``tests/test_data_importer.py::TestFastCSV``, on the seeded
  fuzz tables the JAX parser accepts, and on a cell written with 17
  significant digits that lies just above a float32 rounding midpoint: one
  correctly rounded conversion gives 1.0000001, float64 then float32 gives 1.0;
* an R-style header (one cell shorter than the rows) reads as pandas reads
  it, in the training importer and in the inference importer;
* ``DataImporter.read_data`` gives the JAX importer's raw matrices bit for
  bit, and ``import_data`` its scaled matrices (rtol=1e-5, atol=1e-5, as
  tests/test_torch_importer.py), on a synthetic folder written with 17
  significant digits.
"""

import importlib.util
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from flexynesis_tpu.data import fastcsv as jax_fastcsv
from flexynesis_tpu.data.importer import DataImporter as JaxImporter
from flexynesis_torch.data.fastcsv import read_matrix_csv
from flexynesis_torch.data.importer import DataImporter
from flexynesis_torch.data.inference_importer import DataImporterInference
from flexynesis_torch.kernels import build
from flexynesis_torch.utils.csvio import read_matrix, read_table
from flexynesis_torch.utils.synthetic import write_synthetic_folder

MIDPOINT = "1.00000005960464478"  # 1 + 2**-24 + 4.6e-18


def _matrix_from(rng):
    df = pd.DataFrame(rng.normal(size=(200, 40)).astype(np.float32),
                      index=[f"g{i}" for i in range(200)],
                      columns=[f"S{j}" for j in range(40)])
    df.iloc[3, 5] = np.nan
    return df.to_csv()


# the files of tests/test_data_importer.py::TestFastCSV, and fault 1's cell
FILES = {
    "matches_pandas": _matrix_from(np.random.default_rng(0)),
    "na_strings": ",S1,S2\ng1,1.5,NA\ng2,,nan\n",
    "r_style_header": "S1,S2,S3\ng1,1.0,2.0,3.0\ng2,4.0,5.0,6.0\n",
    "quoted_fields": ',S1,"S2,x",S3\ng1,1.0,2.0,3.0\n"g2,b",4.0,5.0,6.0\n',
    "ragged_mid_file": ",S1,S2,S3\ng1,1.0,2.0,3.0\ng2,4.0,5.0\ng3,6.0,7.0,8.0\n",
    "quoted_mid_file": ',S1,S2,S3\ng1,1.0,2.0,3.0\n"g2,x",4.0,5.0,6.0\n',
    "padded_and_inf": ",S1,S2\ng1, 1.5 ,N/A\ng2,inf,-inf\n",
    "seventeen_digits": f",S1,S2\ng1,{MIDPOINT},0.1\ng2,-{MIDPOINT},3.4028234663852886e+38\n",
}


def _theirs(path):
    df = jax_fastcsv.read_matrix_csv(str(path))
    return ([str(i) for i in df.index], [str(c) for c in df.columns],
            df.to_numpy().astype(np.float32))


def assert_same_matrix(ours, theirs):
    names, columns, mat = ours
    assert (names, columns) == (theirs[0], theirs[1])
    assert mat.dtype == np.float32 and mat.shape == theirs[2].shape
    nan = np.isnan(mat)
    assert np.array_equal(nan, np.isnan(theirs[2]))
    assert np.array_equal(mat[~nan].view(np.uint32), theirs[2][~nan].view(np.uint32))


@pytest.mark.parametrize("name", sorted(FILES))
def test_reader_equals_the_jax_reader(name, tmp_path):
    path = tmp_path / f"{name}.csv"
    path.write_text(FILES[name])
    assert_same_matrix(read_matrix_csv(str(path)), _theirs(path))


def test_seventeen_digit_cell_is_rounded_once(tmp_path, capsys):
    path = tmp_path / "m.csv"
    path.write_text(FILES["seventeen_digits"])
    _, _, mat = read_matrix_csv(str(path))
    assert "[WARN]" not in capsys.readouterr().out  # the native parser read it
    assert mat[0, 0] == np.float32(1.0000001) and mat[1, 0] == -np.float32(1.0000001)
    assert np.float32(float(MIDPOINT)) == 1.0  # what float64 then float32 gives


def test_refused_file_goes_to_the_python_reader(tmp_path, capsys):
    path = tmp_path / "r.csv"
    path.write_text(FILES["r_style_header"])
    names, columns, mat = read_matrix_csv(str(path))
    assert f"using the Python reader for {path}" in capsys.readouterr().out
    assert (names, columns) == (["g1", "g2"], ["S1", "S2", "S3"])
    assert mat.dtype == np.float32 and mat.tolist() == [[1, 2, 3], [4, 5, 6]]


def test_reader_equals_the_jax_reader_on_fuzz_tables(tmp_path):
    """The seeded tables of TestFastCSVFuzz that the JAX parser accepts."""
    spec = importlib.util.spec_from_file_location(
        "jax_importer_tests", Path(__file__).with_name("test_data_importer.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    gen_table = module.TestFastCSVFuzz._gen_table
    rng = np.random.default_rng(2024)
    accepted = 0
    for t in range(120):
        path = tmp_path / f"fuzz_{t}.csv"
        path.write_text(gen_table(rng), encoding="utf-8")
        try:
            jax_fastcsv.read_matrix_csv(str(path), fallback=False)
        except RuntimeError:
            continue
        accepted += 1
        assert_same_matrix(read_matrix_csv(str(path)), _theirs(path))
    assert accepted >= 15, accepted


def test_reader_library_is_built_here_not_loaded_from_native():
    lib = build.library_path("fastcsv")
    assert lib.parent == build.BUILD_DIR and lib.name.startswith("fastcsv-")
    assert build.source("fastcsv").name == "fastcsv.cpp"
    assert "libfastcsv" not in str(build.load("fastcsv")._name)


def test_r_style_header_reads_as_pandas_in_both_readers(tmp_path):
    path = tmp_path / "r.csv"
    path.write_text(FILES["r_style_header"])
    ref = pd.read_csv(path, index_col=0)
    names, columns, mat = read_matrix(str(path))
    assert names == list(ref.index) and columns == list(ref.columns)
    np.testing.assert_array_equal(mat, ref.to_numpy())
    names, columns, rows = read_table(str(path))
    assert columns == ["S1", "S2", "S3"] and rows[1] == ["4.0", "5.0", "6.0"]


def _rewrite_17_digits(path, rng):
    """The matrix at ``path`` again, every value printed with 17 significant
    digits from float64 values near it, one of them fault 1's cell."""
    names, columns, mat = read_matrix(str(path))
    values = mat + rng.normal(0, 1e-3, mat.shape)
    values[0, 0] = float(MIDPOINT)
    lines = ["," + ",".join(columns)] + [n + "," + ",".join("%.17g" % v for v in row)
                        for n, row in zip(names, values)]
    path.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("fastcsv_importer") / "data"
    write_synthetic_folder(str(root), n_train=40, n_test=20,
                           n_features={"gex": 50, "cnv": 30}, n_classes=3, seed=7)
    rng = np.random.default_rng(1)
    for split in ("train", "test"):
        for layer in ("gex", "cnv"):
            _rewrite_17_digits(root / split / f"{layer}.csv", rng)
    return root


OPTIONS = dict(data_types=["gex", "cnv"], top_percentile=50, min_features=10,
               correlation_threshold=0.5, variance_threshold=0.01)


def test_importer_reads_the_jax_matrices_bit_for_bit(folder):
    ours = DataImporter(str(folder), device="cpu", **OPTIONS).read_data(str(folder / "train"))
    theirs = JaxImporter(str(folder), **OPTIONS).read_data(str(folder / "train"))
    for layer in ("gex", "cnv"):
        df = theirs[layer]
        assert_same_matrix((ours[layer].features, ours[layer].samples, ours[layer].values),
                           (list(df.index), list(df.columns), df.to_numpy(np.float32)))
    assert ours["gex"].values[0, 0] == np.float32(1.0000001)


def test_import_data_matches_the_jax_importer(folder):
    train, test = DataImporter(str(folder), device="cpu", **OPTIONS).import_data()
    jtrain, jtest = JaxImporter(str(folder), **OPTIONS).import_data()
    for ours, theirs in ((train, jtrain), (test, jtest)):
        pos = {s: i for i, s in enumerate(ours.samples)}
        order = [pos[s] for s in theirs.samples]
        for layer in theirs.dat:
            assert ours.features[layer] == list(theirs.features[layer])
            np.testing.assert_allclose(ours.dat[layer][order], np.asarray(theirs.dat[layer]),
                                       rtol=1e-5, atol=1e-5)


def _write_r_style(path):
    names, columns, mat = read_matrix(str(path))
    path.write_text(",".join(columns) + "\n" + "\n".join(
        n + "," + ",".join("%.17g" % v for v in row) for n, row in zip(names, mat)) + "\n")


def test_r_style_header_in_both_importers(folder, tmp_path):
    """Fault 2: the training importer and the inference importer read a
    matrix whose header lacks the index cell as pandas reads it."""
    from flexynesis_torch.inference import build_artifacts

    root = tmp_path / "data"
    shutil.copytree(folder, root)
    _write_r_style(root / "train" / "gex.csv")
    _write_r_style(root / "test" / "gex.csv")
    theirs = JaxImporter(str(root), **OPTIONS).read_data(str(root / "train"))["gex"]
    ours = DataImporter(str(root), device="cpu", **OPTIONS).read_data(str(root / "train"))["gex"]
    assert_same_matrix((ours.features, ours.samples, ours.values),
                       (list(theirs.index), list(theirs.columns), theirs.to_numpy(np.float32)))

    importer = DataImporter(str(folder), device="cpu", **OPTIONS)
    importer.import_data()
    artifacts = build_artifacts(importer, ["gex", "cnv"], ["subtype"])
    ds = DataImporterInference(str(root / "test"), artifacts, verbose=False).import_data()
    ref = DataImporterInference(str(folder / "test"), artifacts, verbose=False).import_data()
    assert ds.samples == ref.samples and ds.features == ref.features
    np.testing.assert_array_equal(ds.dat["gex"], ref.dat["gex"])
