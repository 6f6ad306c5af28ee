"""The library options the port's CLI never sets, against the JAX package:

* the sequential CV fold path (``parallel_folds = False``): every fold fit's
  train and validation rows, lr, batch size, epochs, patience and seed equal
  JAX's, both captured by replacing each class's ``fit``, and the rows equal
  JAX's ``kfold_indices`` (no rows trimmed); the fold means of fixed
  stand-in results equal JAX's; a plot per fold under ``plot_losses``; no
  pipelined ask session is opened under ``batch_ask=2`` (as
  tests/test_hpo.py checks in JAX), and a whole search makes JAX's fits;
* ``laplacian_score(t=)``, ``filter_by_laplacian(t=)`` and
  ``laplacian_score_sharded`` on a mesh of 8 CPU devices (37 features
  padded to 40) against JAX's scores, rtol 1e-4 / atol 1e-6;
* ``evaluate_classifier(print_report=True)`` prints sklearn's
  ``classification_report(y_true, y_pred, zero_division=0)``, as JAX does;
* ``Trainer.fit(log_every=)`` prints JAX's lines on weights carried across
  by ``convert.from_flax`` (one full batch an epoch, dropout off on both
  sides, so the two fits see the same batches; lr 1e-6, since Adam's first
  steps are about lr whatever the gradient, and a larger lr lets f32
  rounding in tiny gradients move the fourth printed decimal);
* ``BaseModel.fit(checkpoint_dir=)``: a fit killed after its epoch-10
  checkpoint and rerun on the same directory ends in the uninterrupted
  fit's state, bit for bit on the CPU;
* ``SupervisedVAENet.encode`` against JAX's, rtol/atol 1e-5, in both modes;
* the facades: every name of JAX's ``data``, ``ops``, ``train`` and
  ``models`` ``__all__`` is the port's object; ``inference``'s registry;
  ``DataImporter(processed_dir=)``; ``read_matrix_csv``'s ``n_threads`` and
  ``fallback``."""

import importlib
from types import SimpleNamespace

import flax.linen as nn_flax
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
from sklearn.metrics import classification_report

from flexynesis_tpu.data import feature_selection as jax_fs
from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.data.importer import DataImporter as JaxDataImporter
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.models.supervised_vae import SupervisedVAE as JaxSupervisedVAE
from flexynesis_tpu.train import gp as jax_gp
from flexynesis_tpu.train import hpo as jax_hpo
from flexynesis_tpu.train import trainer as jax_trainer
from flexynesis_tpu.utils.metrics import evaluate_classifier as jax_evaluate_classifier
from flexynesis_torch.convert import from_flax
from flexynesis_torch.data import feature_selection
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.data.fastcsv import read_matrix_csv
from flexynesis_torch.data.importer import DataImporter
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.ops.mlp import MLP
from flexynesis_torch.parallel.mesh import get_mesh
from flexynesis_torch.train import gp, hpo, live_plot
from flexynesis_torch.train import trainer as port_trainer
from flexynesis_torch.utils.metrics import evaluate_classifier

N = 43
BASE = {"latent_dim": 8, "hidden_dim_factor": 0.4, "lr": 1e-3, "supervisor_hidden_dim": 4,
        "epochs": 3, "batch_size": 8}


def _arrays(n=N):
    rng = np.random.default_rng(0)
    return dict(dat={"gex": rng.normal(size=(n, 10)).astype(np.float32),
                     "cnv": rng.normal(size=(n, 6)).astype(np.float32)},
                ann={"y": rng.integers(0, 2, n).astype(np.float32)},
                variable_types={"y": "categorical"},
                features={"gex": [f"g{i}" for i in range(10)], "cnv": [f"c{i}" for i in range(6)]},
                samples=[str(i) for i in range(n)], label_mappings={"y": {0: "a", 1: "b"}})


# ------------------------------------------------------- sequential CV folds

FIT_KEYS = ("lr", "batch_size", "max_epochs", "early_stop_patience", "seed")


def _record_fits(monkeypatch, cls, calls):
    """Replace ``cls.fit`` by a stand-in that records its arguments and
    returns the i-th fixed result (val_loss, epochs_run)."""
    def fit(self, dataset, train_idx=None, val_idx=None, **kw):
        i = len(calls)
        calls.append(dict(train_idx=None if train_idx is None else np.asarray(train_idx),
                          val_idx=None if val_idx is None else np.asarray(val_idx),
                          on_epoch_end=kw.get("on_epoch_end"),
                          **{k: kw[k] for k in FIT_KEYS}))
        return SimpleNamespace(val_loss=0.5 + 0.37 * ((3 * i) % 5), epochs_run=1 + i % 3)

    monkeypatch.setattr(cls, "fit", fit)


def _sequential_tuners(k, **kw):
    ours = hpo.HyperparameterTuning(MultiOmicDataset(**_arrays()), DirectPred, "DirectPred",
                                    ["y"], device="cpu", use_cv=True, cv_splits=k,
                                    early_stop_patience=4, **kw)
    theirs = jax_hpo.HyperparameterTuning(JaxDataset(**_arrays()), JaxDirectPred, "DirectPred",
                                          ["y"], use_cv=True, cv_splits=k,
                                          early_stop_patience=4, **kw)
    assert ours.parallel_folds and theirs.parallel_folds
    ours.parallel_folds = theirs.parallel_folds = False
    return ours, theirs


def _same_fits(ours, theirs):
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        for key in ("train_idx", "val_idx") + FIT_KEYS:
            if a[key] is None or b[key] is None:
                assert a[key] is None and b[key] is None, key
            else:
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("k", [3, 5])
def test_sequential_folds_match_jax(k, monkeypatch):
    ours, theirs = _sequential_tuners(k, plot_losses=True)
    theirs.plot_losses = False  # JAX's plots are its own; the port's are checked below
    calls = {"ours": [], "theirs": []}
    _record_fits(monkeypatch, DirectPred, calls["ours"])
    _record_fits(monkeypatch, JaxDirectPred, calls["theirs"])
    got, want = ours.objective(BASE), theirs.objective(BASE)
    assert got[:2] == want[:2]
    losses = [0.5 + 0.37 * ((3 * i) % 5) for i in range(k)]
    assert got[:2] == (float(np.mean(losses)), int(np.mean([1 + i % 3 for i in range(k)])))
    assert isinstance(got[2], DirectPred) and isinstance(want[2], JaxDirectPred)
    _same_fits(calls["ours"], calls["theirs"])
    folds = jax_trainer.kfold_indices(N, k, seed=42)  # n % k rows are not trimmed
    for call, (tr, va) in zip(calls["ours"], folds):
        np.testing.assert_array_equal(call["train_idx"], tr)
        np.testing.assert_array_equal(call["val_idx"], va)
    assert sum(len(c["val_idx"]) for c in calls["ours"]) == N
    plots = [c["on_epoch_end"].__self__ for c in calls["ours"]]
    assert len({id(p) for p in plots}) == k
    assert all(isinstance(p, live_plot.LiveLossPlot) and p.hyperparams == BASE for p in plots)


@pytest.mark.parametrize("k", [3, 5])
def test_sequential_folds_search_opens_no_ask_session(k, monkeypatch):
    ours, theirs = _sequential_tuners(k, n_iter=4, batch_ask=2)
    for tuner in (ours, theirs):
        for d in tuner.space.dimensions:  # one architecture: suggestions group by two
            if d.name in ("latent_dim", "supervisor_hidden_dim"):
                d.low = d.high = 8
            if d.name == "hidden_dim_factor":
                d.low = d.high = 0.4
            if d.name in ("epochs", "batch_size"):
                d.categories = [3 if d.name == "epochs" else 8]
    sessions = {"ours": [], "theirs": []}
    for module, side in ((gp, "ours"), (jax_gp, "theirs")):
        real = module.BayesianOptimizer.ask_session

        def ask_session(self, *a, _real=real, _side=side, **kw):
            sessions[_side].append(a)
            return _real(self, *a, **kw)

        monkeypatch.setattr(module.BayesianOptimizer, "ask_session", ask_session)
    for name in ("_run_parallel_group_cv", "_objective_cv_parallel"):
        def engine(*a, _name=name, **kw):
            raise AssertionError(f"{_name} ran on the sequential path")

        monkeypatch.setattr(ours, name, engine)
    calls = {"ours": [], "theirs": []}
    _record_fits(monkeypatch, DirectPred, calls["ours"])
    _record_fits(monkeypatch, JaxDirectPred, calls["theirs"])
    model, best = ours.perform_tuning()
    jax_model, jax_best = theirs.perform_tuning()
    assert sessions == {"ours": [], "theirs": []}
    assert len(calls["ours"]) == 4 * k + 1  # k fold fits a suggestion, then the retrain
    _same_fits(calls["ours"], calls["theirs"])
    assert best == jax_best and isinstance(model, DirectPred)
    assert calls["ours"][-1]["train_idx"] is None  # the retrain takes every row


# ------------------------------------------------------------ Laplacian score

TOL = dict(rtol=1e-4, atol=1e-6)


def _matrix(n=40, f=37, seed=3):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, 4))
    return (base @ rng.normal(size=(4, f)) + 0.5 * rng.normal(size=(n, f))).astype(np.float32)


@pytest.mark.parametrize("t", [None, 20.0, 80.0])
def test_laplacian_score_heat_kernel_matches_jax(t):
    X = _matrix()
    np.testing.assert_allclose(feature_selection.laplacian_score(X, 5, t=t, device="cpu"),
                               jax_fs.laplacian_score(X, 5, t=t), **TOL)


@pytest.mark.parametrize("t", [None, 40.0])
def test_filter_by_laplacian_heat_kernel_matches_jax(t, capsys):
    X = _matrix(f=30)
    names = [f"f{i}" for i in range(30)]
    chosen, log = feature_selection.filter_by_laplacian(
        X, names, "gex", k=5, t=t, topN=10, correlation_threshold=0.8, device="cpu")
    frame = pd.DataFrame(X, columns=names)
    selected, jax_log = jax_fs.filter_by_laplacian(frame, "gex", k=5, t=t, topN=10,
                                                   correlation_threshold=0.8)
    assert set(chosen) == set(selected.columns) and len(chosen) == 10
    want = dict(zip(jax_log["feature"], jax_log["laplacian_score"]))
    np.testing.assert_allclose([row["laplacian_score"] for row in log],
                               [want[row["feature"]] for row in log], **TOL)


def test_laplacian_score_sharded_matches_jax():
    X = _matrix(f=37)
    mesh = get_mesh((("data", 8),), devices=[torch.device("cpu")] * 8)
    sharded = feature_selection.laplacian_score_sharded(X, 5, mesh=mesh, axis="data")
    assert sharded.shape == (37,)
    np.testing.assert_allclose(sharded, jax_fs.laplacian_score(X, 5), **TOL)
    np.testing.assert_allclose(sharded, feature_selection.laplacian_score(X, 5, device="cpu"),
                               **TOL)
    np.testing.assert_array_equal(
        feature_selection.laplacian_score_sharded(X, 5, mesh=None, device="cpu"),
        feature_selection.laplacian_score(X, 5, device="cpu"))


# ------------------------------------------------------- classification report

@pytest.mark.parametrize("case", ["float_labels", "int_labels", "no_true_positive"])
def test_print_report_is_sklearns(case, capsys):
    rng = np.random.default_rng(5)
    y_true = rng.integers(0, 4, 60)
    probs = rng.random((60, 4))
    if case == "float_labels":
        y_true = y_true.astype(np.float64)
    if case == "no_true_positive":
        y_true = (probs.argmax(axis=1) + 1) % 4
    ours = evaluate_classifier(y_true, probs, print_report=True)
    printed = capsys.readouterr().out
    assert printed == classification_report(y_true, probs.argmax(axis=1), zero_division=0) + "\n"
    theirs = jax_evaluate_classifier(y_true, probs, print_report=True)
    assert capsys.readouterr().out == printed
    assert evaluate_classifier(y_true, probs) == ours
    assert capsys.readouterr().out == ""
    for key in ("balanced_acc", "f1_score", "kappa"):
        np.testing.assert_allclose(ours[key], theirs[key], rtol=1e-12)


# ------------------------------------------------------------- log_every

def _direct_pair():
    cfg = {"latent_dim": 8, "hidden_dim_factor": 0.5, "lr": 1e-3, "supervisor_hidden_dim": 6}
    jax_ds = JaxDataset(**_arrays())
    jax_model = JaxDirectPred(cfg, jax_ds, target_variables=["y"])
    jax_model.init_params(jax_ds, seed=3)
    ds = MultiOmicDataset(**_arrays())
    model = DirectPred(cfg, ds, target_variables=["y"], device="cpu")
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    for m in model.module.modules():
        if isinstance(m, MLP):
            m.dropout_rate = 0.0
    return jax_model, jax_ds, model, ds


@pytest.mark.parametrize("validated", [True, False])
def test_log_every_prints_jaxs_lines(validated, monkeypatch, capsys):
    monkeypatch.setattr(nn_flax.Dropout, "__call__", lambda self, x, *a, **k: x)
    jax_model, jax_ds, model, ds = _direct_pair()
    train_idx, val_idx = np.arange(35), np.arange(35, N)
    kw = dict(n_samples=35, batch_size=35, max_epochs=5, log_every=2)
    jt = jax_trainer.Trainer(jax_model.loss_fn, lr=1e-6)
    jt.fit(jax_model.params, jax_model.batch_stats, jax_model.make_batch(jax_ds, train_idx),
           jax_model.make_batch(jax_ds, val_idx) if validated else None,
           rng=jax.random.key(0), **kw)
    want = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[epoch")]
    pt = port_trainer.Trainer(model.module, model.loss_fn, lr=1e-6)
    pt.fit(model.make_batch(ds, train_idx),
           model.make_batch(ds, val_idx) if validated else None, **kw)
    got = [line for line in capsys.readouterr().out.splitlines() if line.startswith("[epoch")]
    assert [line.split()[1] for line in want] == ["0]", "2]", "4]"]
    assert got == want


# ----------------------------------------------------- resumable model fit

@pytest.mark.parametrize("cls", [DirectPred, SupervisedVAE])
def test_killed_fit_resumes_to_the_uninterrupted_state(cls, tmp_path, capsys):
    ds = MultiOmicDataset(**_arrays())
    kw = dict(lr=1e-2, batch_size=8, max_epochs=14, seed=7)
    train_idx, val_idx = np.arange(35), np.arange(35, N)
    whole = cls(BASE, ds, target_variables=["y"], device="cpu")
    want = whole.fit(ds, train_idx, val_idx, **kw)

    def kill(epoch, train_loss, val_loss):
        if epoch == 11:
            raise KeyboardInterrupt

    first = cls(BASE, ds, target_variables=["y"], device="cpu")
    with pytest.raises(KeyboardInterrupt):
        first.fit(ds, train_idx, val_idx, checkpoint_dir=str(tmp_path), on_epoch_end=kill, **kw)
    rerun = cls(BASE, ds, target_variables=["y"], device="cpu")
    got = rerun.fit(ds, train_idx, val_idx, checkpoint_dir=str(tmp_path), **kw)
    assert "[INFO] Resumed training from epoch 10" in capsys.readouterr().out
    assert got.val_loss == want.val_loss and got.epochs_run == want.epochs_run == 14
    assert got.history["val_loss"] == want.history["val_loss"][10:]
    mine, theirs = rerun.module.state_dict(), whole.module.state_dict()
    assert set(mine) == set(theirs)
    for name in mine:
        assert torch.equal(mine[name], theirs[name]), name


# --------------------------------------------------------- VAE encode

@pytest.mark.parametrize("train", [False, True])
def test_vae_encode_matches_jax(train):
    cfg = {"latent_dim": 6, "hidden_dim_factor": 0.5, "supervisor_hidden_dim": 4}
    jax_ds = JaxDataset(**_arrays())
    jax_model = JaxSupervisedVAE(cfg, jax_ds, target_variables=["y"])
    jax_model.init_params(jax_ds, seed=2)
    ds = MultiOmicDataset(**_arrays())
    model = SupervisedVAE(cfg, ds, target_variables=["y"], device="cpu")
    model.module.load_state_dict(from_flax(jax_model.params, jax_model.batch_stats))
    x = {k: v[:20] for k, v in _arrays()["dat"].items()}
    variables = {"params": jax_model.params, "batch_stats": jax_model.batch_stats}
    if train:
        (mean, log_var), _ = jax_model.module.apply(
            variables, {k: jnp.asarray(v) for k, v in x.items()}, train=True,
            method="encode", mutable=["batch_stats"])
    else:
        mean, log_var = jax_model.module.apply(
            variables, {k: jnp.asarray(v) for k, v in x.items()}, train=False, method="encode")
    model.module.eval()
    with torch.no_grad():
        got = model.module.encode({k: torch.from_numpy(v) for k, v in x.items()}, train=train)
    for a, b in zip(got, (mean, log_var)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    if not train:  # eval mode: forward's embeddings are encode's mean
        with torch.no_grad():
            out = model.module({k: torch.from_numpy(v) for k, v in x.items()})
        torch.testing.assert_close(out["embeddings"], got[0], rtol=0, atol=0)


# ------------------------------------------------- facades and small options

@pytest.mark.parametrize("package", ["data", "ops", "train", "models"])
def test_facade_names_are_the_ports_objects(package):
    jax_pkg = importlib.import_module(f"flexynesis_tpu.{package}")
    port_pkg = importlib.import_module(f"flexynesis_torch.{package}")
    assert set(jax_pkg.__all__) <= set(port_pkg.__all__)
    for name in jax_pkg.__all__:
        value = getattr(port_pkg, name)
        if name == "MODEL_REGISTRY":
            assert set(value) == set(getattr(jax_pkg, name))
            assert all(v.__module__.startswith("flexynesis_torch.") for v in value.values())
            continue
        jax_value = getattr(jax_pkg, name)
        port_home = importlib.import_module(
            jax_value.__module__.replace("flexynesis_tpu", "flexynesis_torch", 1))
        assert value is getattr(port_home, name), name
    with pytest.raises(AttributeError):
        getattr(port_pkg, "not_a_name")


def test_model_registry_matches_jax():
    from flexynesis_tpu import inference as jax_inference
    from flexynesis_torch import inference

    assert inference.MODEL_CLASS_NAMES == jax_inference.MODEL_CLASS_NAMES
    ours, theirs = inference.get_model_registry(), jax_inference.get_model_registry()
    assert set(ours) == set(theirs)
    assert {k: v.__name__ for k, v in ours.items()} == {k: v.__name__ for k, v in theirs.items()}
    assert ours["SupervisedVAE"] is SupervisedVAE


def test_processed_dir_is_stored_as_in_jax(tmp_path):
    for sub in ("processed", "cache"):
        ours = DataImporter(str(tmp_path), ["gex"], processed_dir=sub, device="cpu")
        theirs = JaxDataImporter(str(tmp_path), ["gex"], processed_dir=sub)
        assert ours.processed_dir == theirs.processed_dir == str(tmp_path / sub)


def test_read_matrix_csv_threads_and_fallback(tmp_path):
    good = tmp_path / "good.csv"
    good.write_text("gene,s1,s2,s3\ng1,1.5,2,3\ng2,4,5,6.25\n")
    names, columns, mat = read_matrix_csv(str(good), n_threads=1)
    assert names == ["g1", "g2"] and columns == ["s1", "s2", "s3"]
    for n_threads in (0, 3):
        np.testing.assert_array_equal(read_matrix_csv(str(good), n_threads=n_threads)[2], mat)
    quoted = tmp_path / "quoted.csv"
    quoted.write_text('gene,s1,s2\n"g1",1,2\n"g2",3,4\n')
    np.testing.assert_array_equal(read_matrix_csv(str(quoted))[2], [[1, 2], [3, 4]])
    with pytest.raises(RuntimeError):
        read_matrix_csv(str(quoted), fallback=False)
