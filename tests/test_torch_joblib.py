"""The port's joblib artifacts (``utils/joblib_io`` and the converters of
``data/preprocessing``) against joblib, scikit-learn and the JAX package, on
the CPU:

* the codec on fitted sklearn objects, both ways: the port's writer gives the
  bytes ``joblib.dump`` gives; the port reads ``joblib.dump`` output into the
  JSON state JAX's ``_scaler_to_json``/``_encoder_to_json`` give;
  ``joblib.load`` of the port's file gives objects whose ``vars()`` equal
  JAX's key for key (arrays bit for bit) and whose ``transform`` gives JAX's
  bits; a NaN category, a LabelEncoder, numpy 1's module names, Fortran
  order, big-endian data and joblib's older layouts;
* the refusal of a global off the allow-list, before it is called;
* the port's scaler fit is sklearn's arithmetic, bit for bit on the same rows;
* the CLI both ways: the port trains without ``--safetensors`` and JAX's CLI
  serves from the ``.joblib``; JAX trains with its defaults and the port
  serves from the ``.joblib``; a ``.joblib`` and the ``.json`` written from
  its state serve alike, bit for bit; the committed JAX-written fixture
  ``tests/fixtures/joblib`` (which ``chip_smoke.py`` serves on the card).

Tolerances: model outputs of the two packages rtol=1e-4, atol=1e-5 (f32, as
tests/test_torch_inference.py); the port importer's scaler state against the
JAX importer's rtol=1e-12, since the JAX importer orders samples by Python set
iteration and float64 sums over another row order part in the last bits (on
the same rows the port's fit is sklearn's bit for bit); everything else is
compared exactly."""

import io
import json
import os
import pickle
from pathlib import Path

import joblib
import numpy as np
import pandas as pd
import pytest
from sklearn.preprocessing import LabelEncoder, OrdinalEncoder, StandardScaler

from flexynesis_tpu import inference as jax_inference
from flexynesis_tpu.__main__ import main as jax_main
from flexynesis_tpu.data.importer import DataImporter as JaxImporter
from flexynesis_torch import inference
from flexynesis_torch.__main__ import main
from flexynesis_torch.data import preprocessing as prep
from flexynesis_torch.utils import joblib_io
from flexynesis_torch.utils.csvio import read_matrix, read_table
from flexynesis_torch.utils.synthetic import write_synthetic_folder

FIXTURE = Path(__file__).resolve().parent / "fixtures" / "joblib"
OPTIONS = dict(top_percentile=50, min_features=10)
CONFIG = """DirectPred:
  - {type: Categorical, categories: [16], name: latent_dim}
  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.003], name: lr}
  - {type: Categorical, categories: [8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [3], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
  - {type: Categorical, categories: [%s], name: fused_kernels}
"""
STAND_IN = {StandardScaler: joblib_io.StandardScaler, OrdinalEncoder: joblib_io.OrdinalEncoder,
            LabelEncoder: joblib_io.LabelEncoder}


def _blank_label(clin: Path, row: int) -> None:
    lines = clin.read_text().splitlines()
    col = lines[0].split(",").index("subtype")
    cells = lines[row + 1].split(",")
    cells[col] = ""
    lines[row + 1] = ",".join(cells)
    clin.write_text("\n".join(lines) + "\n")


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """A synthetic folder with one missing training label (the encoder's NaN
    category), the JAX importer over it and JAX's artifact dict."""
    root = tmp_path_factory.mktemp("joblib")
    write_synthetic_folder(str(root / "data"), n_train=48, n_test=20,
                           n_features={"gex": 40, "cnv": 30}, n_classes=3, seed=4)
    _blank_label(root / "data" / "train" / "clin.csv", 2)
    for fused in ("true", "false"):
        (root / f"hpo_{fused}.yaml").write_text(CONFIG % fused)
    importer = JaxImporter(str(root / "data"), ["gex", "cnv"], **OPTIONS)
    importer.import_data()
    artifacts = jax_inference.build_artifacts(importer, ["gex", "cnv"], ["subtype"])
    return root, importer, artifacts


def _stand_ins(obj):
    """``obj`` with each sklearn object replaced by its stand-in holding the
    object's pickled state; every other object stays the same object."""
    if type(obj) in STAND_IN:
        return STAND_IN[type(obj)](obj.__getstate__())
    if isinstance(obj, dict):
        return {k: _stand_ins(v) for k, v in obj.items()}
    return obj


def _port_bytes(obj, writer=joblib_io.Writer) -> bytes:
    buf = io.BytesIO()
    writer(buf).dump(obj)
    return buf.getvalue()


def _loads(data: bytes):
    return joblib_io.Reader(io.BytesIO(data)).load()


def _joblib_bytes(obj, tmp_path) -> bytes:
    joblib.dump(obj, tmp_path / "ref.joblib")
    return (tmp_path / "ref.joblib").read_bytes()


def _same(a, b) -> bool:
    """Equal values of equal types; arrays bit for bit (NaN-aware for objects)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        if type(a) is not type(b) or a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.hasobject:
            return all(_same(x, y) for x, y in zip(a.ravel(), b.ravel()))
        return a.tobytes() == b.tobytes()
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, dict):
        return type(a) is type(b) and list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float) and np.isnan(a) and np.isnan(b):
        return type(a) is type(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("what", ["scaler", "encoder", "label_encoder", "artifacts"])
def test_writer_gives_joblib_dumps_bytes(folder, tmp_path, what):
    _, importer, artifacts = folder
    obj = {"scaler": importer.scalers["gex"], "encoder": importer.label_encoders["subtype"],
           "label_encoder": LabelEncoder().fit(["b", "a", "c", "a"]),
           "artifacts": artifacts}[what]
    assert _port_bytes(_stand_ins(obj)) == _joblib_bytes(obj, tmp_path)


def test_reads_joblib_dump_as_jax_json_state(folder, tmp_path):
    _, importer, artifacts = folder
    path = tmp_path / "jax.artifacts.joblib"
    jax_inference.write_artifacts(artifacts, str(path), as_json=False)
    ours = inference.load_and_sniff_artifacts(str(path))
    assert ours["transforms"] == {m: jax_inference._scaler_to_json(s)
                                  for m, s in importer.scalers.items()}
    assert ours["label_encoders"] == {v: jax_inference._encoder_to_json(e)
                                      for v, e in importer.label_encoders.items()}
    assert "__NaN__" in ours["label_encoders"]["subtype"]["categories"][0]
    for key in artifacts.keys() - {"transforms", "label_encoders"}:
        assert ours[key] == artifacts[key], key
    # the JSON artifact of the same objects loads to the same state
    jax_inference.write_artifacts(artifacts, str(tmp_path / "jax.json"), as_json=True)
    assert inference.load_and_sniff_artifacts(str(tmp_path / "jax.json")) == ours


def test_port_file_loads_as_jax_objects(folder, tmp_path):
    root, importer, artifacts = folder
    jax_inference.write_artifacts(artifacts, str(tmp_path / "jax.json"), as_json=True)
    state = inference.load_and_sniff_artifacts(str(tmp_path / "jax.json"))
    inference.write_artifacts(state, str(tmp_path / "port.joblib"), as_json=False)
    theirs = joblib.load(tmp_path / "port.joblib")
    for key in ("transforms", "label_encoders"):
        for name, want in artifacts[key].items():
            got = theirs[key][name]
            assert type(got) is type(want)
            assert _same(vars(got), vars(want)), (key, name)
    for layer, scaler in importer.scalers.items():
        x = pd.read_csv(root / "data" / "test" / f"{layer}.csv", index_col=0)
        x = x.loc[list(scaler.feature_names_in_)].T.astype(np.float32)
        assert theirs["transforms"][layer].transform(x).tobytes() == \
            scaler.transform(x).tobytes()
    labels = pd.Series(["grp2", None, "grp0", "unseen", "grp1"], name="subtype").to_frame()
    want = importer.label_encoders["subtype"].transform(labels)
    assert theirs["label_encoders"]["subtype"].transform(labels).tobytes() == want.tobytes()
    # and back: the port reads its own file to the state it wrote
    assert inference.load_and_sniff_artifacts(str(tmp_path / "port.joblib")) == state


def test_label_encoder_reads_as_ordinal_state(folder, tmp_path):
    """Reference artifacts may hold a LabelEncoder: it loads as the
    OrdinalEncoder state of the same classes, as JAX normalises it."""
    _, _, artifacts = folder
    reference = dict(artifacts, label_encoders={
        "subtype": LabelEncoder().fit(["grp1", "grp0", "grp2", "grp0"])})
    joblib.dump(reference, tmp_path / "ref.joblib")
    ours = inference.load_and_sniff_artifacts(str(tmp_path / "ref.joblib"))
    state = ours["label_encoders"]["subtype"]
    assert state == prep.normalize_encoder_state(
        {"type": "LabelEncoder", "classes": ["grp0", "grp1", "grp2"]})
    codes = prep.encode_labels(state, ["grp2", "grp0", "", "other"])
    assert codes.tolist() == [2.0, 0.0, -1.0, -1.0]


class _Numpy1Writer(joblib_io.Writer):
    """Names numpy's reconstructors as numpy 1 did (``numpy.core``)."""

    def save_global(self, obj, name=None):
        module = getattr(obj, "__module__", "") or ""
        if not module.startswith("numpy._core"):
            return super().save_global(obj, name)
        self.save(module.replace("numpy._core", "numpy.core"))
        self.save(obj.__name__)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


class _Joblib11Writer(joblib_io.Writer):
    """joblib 1.1 and older: no alignment attribute and no padding."""

    alignment = None


@pytest.mark.parametrize("writer", [_Numpy1Writer, _Joblib11Writer])
def test_reads_older_layouts(folder, tmp_path, writer):
    _, _, artifacts = folder
    data = _port_bytes(_stand_ins(artifacts), writer)
    if writer is _Numpy1Writer:
        assert b"numpy.core.multiarray" in data and b"numpy._core" not in data
    else:
        assert b"numpy_array_alignment_bytes" not in data
    (tmp_path / "old.joblib").write_bytes(data)
    assert inference.load_and_sniff_artifacts(str(tmp_path / "old.joblib")) == \
        inference._from_pickled(_loads(_port_bytes(_stand_ins(artifacts))))
    if writer is _Joblib11Writer:  # joblib reads it too
        assert _same(vars(joblib.load(tmp_path / "old.joblib")["transforms"]["gex"]),
                     vars(artifacts["transforms"]["gex"]))


ARRAYS = {
    "fortran": np.asfortranarray(np.arange(12.0).reshape(3, 4)),
    "big_endian": np.arange(5, dtype=">f8") / 3,
    "int64": np.arange(-3, 4, dtype=np.int64),
    "float32_3d": np.linspace(-1, 1, 24, dtype=np.float32).reshape(2, 3, 4),
    "zero_d": np.array(2.5),
    "empty": np.zeros((0, 3)),
    "bool": np.array([True, False, True]),
    "objects": np.array(["a", np.nan, "c"], dtype=object),
    "strided": np.arange(20.0)[::3],
}


@pytest.mark.parametrize("name", list(ARRAYS))
def test_arrays_both_ways(tmp_path, name):
    value = {"x": ARRAYS[name], "after": np.arange(3.0), "n": np.float64(7.0)}
    joblib.dump(value, tmp_path / "a.joblib")
    native = {k: v.astype(v.dtype.newbyteorder("=")) if isinstance(v, np.ndarray) else v
              for k, v in value.items()}
    got = joblib_io.load(str(tmp_path / "a.joblib"))
    assert all(_same(got[k], v) for k, v in native.items())
    joblib_io.dump(value, str(tmp_path / "b.joblib"))
    back = joblib.load(tmp_path / "b.joblib")
    assert all(_same(back[k], v) for k, v in native.items())
    assert (tmp_path / "b.joblib").read_bytes() == _joblib_bytes(value, tmp_path)


def test_reads_unaligned_stream():
    """joblib writes no alignment where its file cannot tell its position."""

    class Stream(io.RawIOBase):
        def __init__(self):
            self.data = bytearray()

        def writable(self):
            return True

        def write(self, b):
            self.data += b
            return len(b)

    stream = Stream()
    value = {"x": np.arange(7.0), "names": np.array(["a", "b"], dtype=object)}
    joblib.numpy_pickle.NumpyPickler(stream).dump(value)
    got = _loads(bytes(stream.data))
    np.testing.assert_array_equal(got["x"], value["x"])
    assert got["names"].tolist() == ["a", "b"]


class _Evil:
    def __init__(self, marker):
        self.marker = marker

    def __reduce__(self):
        return os.system, (f"touch {self.marker}",)


@pytest.mark.parametrize("where", ["pickle", "joblib_artifact", "object_array"])
def test_refuses_globals_off_the_allow_list(tmp_path, where):
    marker = tmp_path / "ran"
    path = tmp_path / "evil.joblib"
    evil = _Evil(marker)
    if where == "pickle":
        path.write_bytes(pickle.dumps(evil, protocol=4))
    elif where == "joblib_artifact":
        joblib.dump({"schema_version": 1, "transforms": {"gex": evil}}, path)
    else:
        joblib.dump({"label_encoders": np.array([evil], dtype=object)}, path)
    with pytest.raises(pickle.UnpicklingError, match=r"global (posix|os)\.system"):
        inference.load_and_sniff_artifacts(str(path))
    assert not marker.exists()
    joblib.load(path)  # joblib itself runs it
    assert marker.exists()


@pytest.mark.parametrize("case", ["compressed", "truncated"])
def test_refuses_what_it_cannot_read(folder, tmp_path, case):
    _, _, artifacts = folder
    path = tmp_path / "a.joblib"
    if case == "compressed":
        joblib.dump(artifacts, path, compress=3)
        with pytest.raises(ValueError, match="not an uncompressed joblib pickle"):
            inference.load_and_sniff_artifacts(str(path))
    else:
        data = _port_bytes(_stand_ins(artifacts))
        path.write_bytes(data[: len(data) // 2])
        with pytest.raises(pickle.UnpicklingError):
            inference.load_and_sniff_artifacts(str(path))


@pytest.mark.parametrize("case", ["float32", "float64", "nan", "constant"])
def test_fit_standard_scaler_is_sklearns(case):
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 3.0, size=(57, 9))
    if case == "float32":
        x = np.asfortranarray(x.astype(np.float32))
    if case == "nan":
        x[[1, 5, 9], [0, 0, 4]] = np.nan
    if case == "constant":
        x[:, 2] = 0.1
    ours = prep.fit_standard_scaler(x, [f"f{i}" for i in range(x.shape[1])])
    want = jax_inference._scaler_to_json(StandardScaler().fit(x))  # the same array
    for key in ("mean", "var", "scale"):
        assert np.asarray(ours[key]).tobytes() == np.asarray(want[key]).tobytes(), key
    assert {k: v for k, v in ours.items() if k != "feature_names_in"} == want


def _train_args(root, out, fused, *extra):
    return ["--data_path", str(root / "data"), "--model_class", "DirectPred",
            "--data_types", "gex,cnv", "--target_variables", "subtype",
            "--config_path", str(root / f"hpo_{fused}.yaml"), "--hpo_iter", "1",
            "--features_top_percentile", "50", "--features_min", "10",
            "--outdir", str(out), "--prefix", "job", *extra]


def _serve(entry, weights, artifacts, test, out, *extra):
    assert entry(["--pretrained_model", str(weights), "--artifacts", str(artifacts),
                  "--data_path_test", str(test), "--outdir", str(out), "--prefix", "inf",
                  "--disable_marker_finding", *extra]) == 0
    samples, _, emb = read_matrix(str(out / "inf.embeddings_test.csv"))
    _, cols, rows = read_table(str(out / "inf.predicted_labels.csv"))
    prob = np.array([float(r[cols.index("probability")]) for r in rows])
    return samples, emb, prob


def _outputs_equal(a: Path, b: Path) -> None:
    for name in ("inf.embeddings_test.csv", "inf.predicted_labels.csv", "inf.stats.csv"):
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.fixture(scope="module")
def port_trained(folder):
    """The port's training CLI without --safetensors (fused, kernel B1)."""
    root = folder[0]
    out = root / "port_train"
    assert main(_train_args(root, out, "true", "--disable_marker_finding",
                            "--device", "cpu")) == 0
    return out


def test_port_training_writes_joblib_artifacts(folder, port_trained):
    _, importer, _ = folder
    assert (port_trained / "job.artifacts.joblib").exists()
    assert not (port_trained / "job.artifacts.json").exists()
    theirs = jax_inference.load_and_sniff_artifacts(str(port_trained / "job.artifacts.joblib"))
    assert theirs["feature_lists"] == {k: list(v) for k, v in importer.train_features.items()}
    for layer, want in importer.scalers.items():
        got = vars(theirs["transforms"][layer])
        want = vars(want)
        assert list(got) == list(want)
        for key in want:
            if key in ("mean_", "var_", "scale_"):
                assert got[key].dtype == want[key].dtype
                np.testing.assert_allclose(got[key], want[key], rtol=1e-12, atol=0)
            else:
                assert _same(got[key], want[key]), key
    assert _same(vars(theirs["label_encoders"]["subtype"]),
                 vars(importer.label_encoders["subtype"]))


def test_jax_cli_serves_the_port_model_from_joblib(folder, port_trained):
    root = folder[0]
    args = (port_trained / "job.final_model.safetensors", port_trained / "job.artifacts.joblib",
            root / "data" / "test")
    s1, e1, p1 = _serve(main, *args, root / "port_serves", "--device", "cpu")
    s2, e2, p2 = _serve(jax_main, *args, root / "jax_serves")
    assert s1 == s2
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)


def test_joblib_and_json_of_one_run_serve_alike(folder, port_trained, tmp_path):
    root = folder[0]
    state = inference.load_and_sniff_artifacts(str(port_trained / "job.artifacts.joblib"))
    inference.write_artifacts(state, str(tmp_path / "job.artifacts.json"))
    assert inference.load_and_sniff_artifacts(str(tmp_path / "job.artifacts.json")) == state
    weights, test = port_trained / "job.final_model.safetensors", root / "data" / "test"
    _serve(main, weights, port_trained / "job.artifacts.joblib", test, tmp_path / "a",
           "--device", "cpu")
    _serve(main, weights, tmp_path / "job.artifacts.json", test, tmp_path / "b",
           "--device", "cpu")
    _outputs_equal(tmp_path / "a", tmp_path / "b")


def test_port_serves_a_jax_default_run(folder, tmp_path):
    """JAX's CLI with its defaults (joblib artifacts; fused off here, the
    fixture below is fused)."""
    root = folder[0]
    out = tmp_path / "jax_train"
    assert jax_main(_train_args(root, out, "false", "--disable_marker_finding")) == 0
    assert (out / "job.artifacts.joblib").exists()
    args = (out / "job.final_model.safetensors", out / "job.artifacts.joblib",
            root / "data" / "test")
    s1, e1, p1 = _serve(main, *args, tmp_path / "port", "--device", "cpu")
    s2, e2, p2 = _serve(jax_main, *args, tmp_path / "jax")
    assert s1 == s2
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)


def test_fixture_loads_alike_in_jax():
    """JAX's own loader reads the fixture's two files to the same state."""
    a = jax_inference.load_and_sniff_artifacts(str(FIXTURE / "job.artifacts.joblib"))
    b = jax_inference.load_and_sniff_artifacts(str(FIXTURE / "job.artifacts.json"))
    assert a["feature_lists"] == b["feature_lists"]
    for key, to_json in (("transforms", jax_inference._scaler_to_json),
                         ("label_encoders", jax_inference._encoder_to_json)):
        assert {k: to_json(v) for k, v in a[key].items()} == \
            {k: to_json(v) for k, v in b[key].items()}
    versions = (FIXTURE / "VERSIONS.txt").read_text()
    assert f"scikit-learn {prep.SKLEARN_VERSION}\n" in versions


def test_port_serves_the_fixture(tmp_path):
    ours = inference.load_and_sniff_artifacts(str(FIXTURE / "job.artifacts.joblib"))
    assert ours == inference.load_and_sniff_artifacts(str(FIXTURE / "job.artifacts.json"))
    assert ours["label_encoders"]["subtype"]["categories"][0][-1] == "__NaN__"
    weights, test = FIXTURE / "job.final_model.safetensors", FIXTURE / "test"
    got = {}
    for kind in ("joblib", "json"):
        got[kind] = _serve(main, weights, FIXTURE / f"job.artifacts.{kind}", test,
                           tmp_path / kind, "--device", "cpu")
    _outputs_equal(tmp_path / "joblib", tmp_path / "json")
    s2, e2, p2 = _serve(jax_main, weights, FIXTURE / "job.artifacts.joblib", test,
                        tmp_path / "jax")
    s1, e1, p1 = got["joblib"]
    assert s1 == s2
    np.testing.assert_allclose(e1, e2, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-5)


def test_fixture_model_is_fused_and_trained_by_jax():
    config = json.loads((FIXTURE / "job.final_model_config.json").read_text())
    assert config["model_class"] == "DirectPred" and config["fused_kernels"] is True
    assert config["model_module"].startswith("flexynesis_tpu.")
