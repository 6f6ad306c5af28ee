"""The CV fold engine behind ``--use_cv`` (``flexynesis_torch/train/hpo.py``:
``_objective_cv_parallel`` and ``_run_parallel_group_cv``) against
``flexynesis_tpu/train/hpo.py``:

* what each hands to ``vmapped_grid_fit`` equals JAX's, both captured with
  monkeypatch, at ``cv_splits`` 3 and 5: the fold tables, lrs, seeds, epochs,
  batch size and patience;
  for a mixed-architecture group the stacked element masks and ``aux``
  (exactly), for DirectPred, supervised_vae and CrossModalPred;
* the fold-mean reduction of the engine's (given) per-trial results equals
  JAX's (exactly: the same numpy code);
* in a group of K suggestions x k folds, the trials of one fold share its
  seed's noise, so each suggestion trains as in a k-fold run of its own (as
  in JAX, whose trials with one seed share one key);
* the pipelined ask runs only where a group trains on the engine (JAX's
  ``drains``), and a CV run retrains the best configuration on the full set;
* per-trial splits give each trial its own training rows in the epoch table;
* ``--use_cv`` through the CLI on the CPU writes every table for the three
  classes."""

import os

import jax
import numpy as np
import pytest
import torch

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.models.crossmodal_pred import CrossModalPred as JaxCrossModalPred
from flexynesis_tpu.models.direct_pred import DirectPred as JaxDirectPred
from flexynesis_tpu.models.supervised_vae import SupervisedVAE as JaxSupervisedVAE
from flexynesis_tpu.parallel import trials as jax_trials
from flexynesis_tpu.train import hpo as jax_hpo
from flexynesis_torch.__main__ import main
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.models.crossmodal_pred import CrossModalPred
from flexynesis_torch.models.direct_pred import DirectPred
from flexynesis_torch.models.supervised_vae import SupervisedVAE
from flexynesis_torch.parallel import trials
from flexynesis_torch.parallel.trials import _init_stacked, _Round
from flexynesis_torch.train import gp, hpo
from flexynesis_torch.utils.synthetic import write_synthetic_folder

CLASSES = {
    "DirectPred": (JaxDirectPred, DirectPred, {}),
    "supervised_vae": (JaxSupervisedVAE, SupervisedVAE, {}),
    "CrossModalPred": (JaxCrossModalPred, CrossModalPred,
                       {"input_layers": ["gex"], "output_layers": ["cnv"]}),
}
N = 43  # 43 % 5 = 3 rows trimmed from the folds


def _arrays(n=N):
    rng = np.random.default_rng(0)
    return dict(dat={"gex": rng.normal(size=(n, 10)).astype(np.float32),
                     "cnv": rng.normal(size=(n, 6)).astype(np.float32)},
                ann={"y": rng.integers(0, 2, n).astype(np.float32)},
                variable_types={"y": "categorical"},
                features={"gex": [f"g{i}" for i in range(10)], "cnv": [f"c{i}" for i in range(6)]},
                samples=[str(i) for i in range(n)], label_mappings={"y": {0: "a", 1: "b"}})


def _tuners(name, **kw):
    jcls, pcls, layers = CLASSES[name]
    ours = hpo.HyperparameterTuning(MultiOmicDataset(**_arrays()), pcls, name, ["y"],
                                    device="cpu", use_cv=True, early_stop_patience=4,
                                    **layers, **kw)
    theirs = jax_hpo.HyperparameterTuning(JaxDataset(**_arrays()), jcls, name, ["y"],
                                          use_cv=True, early_stop_patience=4, **layers, **kw)
    return ours, theirs


BASE = {"latent_dim": 8, "hidden_dim_factor": 0.4, "lr": 1e-3, "supervisor_hidden_dim": 4,
        "epochs": 3, "batch_size": 8}


def _capture(monkeypatch, module, T, calls):
    """Replace ``module.vmapped_grid_fit`` by a stand-in that records its
    keyword arguments and returns fixed per-trial results."""
    def fake(model, dataset, **kw):
        calls.append(kw)
        return {"best_val_loss": np.linspace(0.5, 2.0, T) ** 2,
                "best_epoch": np.arange(T) % 3 + 1, "epochs_run": 3}

    monkeypatch.setattr(module, "vmapped_grid_fit", fake)


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
    elif isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _same(a[k], b[k], f"{what}.{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


KEYS = ("lrs", "seeds", "train_idx", "val_idx", "batch_size", "max_epochs",
        "early_stop_patience")


# k = 5 keeps the ids the cases had before cv_splits; k = 3 adds "-cv3"
@pytest.mark.parametrize("name,cv_splits", [
    pytest.param(n, k, id=n if k == 5 else f"{n}-cv3") for k in (5, 3) for n in sorted(CLASSES)])
def test_objective_cv_parallel_matches_jax(name, cv_splits, monkeypatch, capsys):
    k = cv_splits
    ours, theirs = _tuners(name, cv_splits=k)
    calls = {"ours": [], "theirs": []}
    _capture(monkeypatch, trials, k, calls["ours"])
    _capture(monkeypatch, jax_trials, k, calls["theirs"])
    got = ours.objective(BASE)
    want = theirs.objective(BASE)
    assert got == want and got[2] is None
    (a,), (b,) = calls["ours"], calls["theirs"]
    for key in KEYS:
        _same(a[key], b[key], key)
    assert a["train_idx"].shape == (k, N // k * (k - 1)) and a["val_idx"].shape == (k, N // k)
    assert a.get("start_params") is None and b["start_params"] is None
    assert f"[INFO] {k}-fold CV (stacked, concurrent)" in capsys.readouterr().out


@pytest.mark.parametrize("name,mixed,cv_splits", [
    pytest.param(n, m, k, id=f"{n}-{m}" if k == 5 else f"{n}-{m}-cv3") for k in (5, 3)
    for n, m in [("DirectPred", False), ("DirectPred", True), ("supervised_vae", False),
                 ("CrossModalPred", False), ("CrossModalPred", True)]])
def test_run_parallel_group_cv_matches_jax(name, mixed, cv_splits, monkeypatch, capsys):
    k = cv_splits
    ours, theirs = _tuners(name, batch_ask=3, cv_splits=k)
    group = [dict(BASE, lr=lr) for lr in (1e-4, 1e-3, 1e-2)]
    if mixed:
        group[1].update(latent_dim=12, supervisor_hidden_dim=6)
        group[2].update(latent_dim=6, hidden_dim_factor=0.6)
    calls = {"ours": [], "theirs": []}
    _capture(monkeypatch, trials, 3 * k, calls["ours"])
    _capture(monkeypatch, jax_trials, 3 * k, calls["theirs"])
    got = ours._run_parallel_group_cv(group)
    want = theirs._run_parallel_group_cv(group)
    assert got == want and len(got) == 3  # the fold means
    (a,), (b,) = calls["ours"], calls["theirs"]
    for key in KEYS:
        _same(a[key], b[key], key)
    assert a["train_idx"].shape == (3 * k, N // k * (k - 1))
    assert f"Training 3 suggestions x {k} CV folds = {3 * k} trials" in capsys.readouterr().out
    if mixed:
        masks = jax.tree.leaves(b["masks"])
        assert len(a["masks"]) == len(masks)
        for m, w in zip(a["masks"], masks):
            np.testing.assert_array_equal(m.numpy(), np.asarray(w))
        _same(None if a["aux"] is None else {k: v.numpy() for k, v in a["aux"].items()},
              None if b["aux"] is None else jax.tree.map(np.asarray, b["aux"]), "aux")
        assert all(t.shape[0] == 3 * k for t in a["start_params"].values())
    else:
        for key in ("start_params", "start_stats", "masks", "aux"):
            assert a.get(key) is None and b.get(key) is None, key


@pytest.mark.parametrize("name", ["DirectPred", "supervised_vae"])
def test_cv_group_trials_share_noise_by_seed(name):
    """A CV group of 3 suggestions x 5 folds, one architecture: a suggestion's
    fold takes the seed, and so the initialisation, rows, dropout, eps,
    priors and SR seeds, of that fold in a 5-fold run of the suggestion
    alone, so one stacked step of the group equals one step of each
    suggestion's own 5-fold round (rtol 1e-6, atol 1e-7)."""
    ds = MultiOmicDataset(**_arrays())
    model = CLASSES[name][1](BASE, ds, target_variables=["y"], device="cpu")
    data = model.make_batch(ds)
    tr, _ = trials.equal_kfold_indices(N, 5, seed=42)
    lrs = (1e-4, 1e-3, 1e-2)

    def one_step(lrs, K):
        seeds = np.tile(np.arange(42, 47), K)
        params, buffers = _init_stacked(model, seeds)
        r = _Round(model, params, buffers, lrs=np.repeat(lrs, 5), seeds=seeds)
        assert r.noise.n_draws == 5
        table = r.epoch_rows(np.tile(tr, (K, 1)), 1, 8)[0]
        loss = r.step(trials._gather(data, table))
        return table, loss, {n: t.float() for n, t in r.params.items()}

    g_table, g_loss, g_params = one_step(lrs, 3)
    for i, lr in enumerate(lrs):
        table, loss, params = one_step([lr], 1)
        folds = slice(5 * i, 5 * i + 5)
        np.testing.assert_array_equal(g_table[folds].numpy(), table.numpy())
        torch.testing.assert_close(g_loss[folds], loss, rtol=1e-6, atol=1e-7)
        for n, t in params.items():
            torch.testing.assert_close(g_params[n][folds], t, rtol=1e-6, atol=1e-7,
                                       msg=lambda m: f"{n}: {m}")


@pytest.mark.parametrize("grouped,sessions", [(True, 1), (False, 0)])
def test_pipelined_ask_drains_only_on_the_engine(grouped, sessions, monkeypatch):
    ours, _ = _tuners("DirectPred", batch_ask=2, n_iter=4)
    for d in ours.space.dimensions:  # one bucket per round
        if d.name in ("epochs", "batch_size"):
            d.categories = [3 if d.name == "epochs" else 8]
    if not grouped:  # each suggestion alone: no group trains on the engine
        monkeypatch.setattr(ours, "_bucket_by_architecture", lambda s: [[p] for p in s])
    opened = []
    real = gp.BayesianOptimizer.ask_session

    def ask_session(self, *a, **kw):
        opened.append(a)
        return real(self, *a, **kw)

    monkeypatch.setattr(gp.BayesianOptimizer, "ask_session", ask_session)
    monkeypatch.setattr(ours, "_run_parallel_group_cv",
                        lambda group: [(1.0 + i, 2, None) for i in range(len(group))])
    monkeypatch.setattr(ours, "_objective_cv_parallel", lambda params, n: (1.0, 2, None))
    monkeypatch.setattr(ours, "objective", lambda params, full_train=False: (
        "retrained" if full_train else hpo.HyperparameterTuning.objective(ours, params)))
    model, best = ours.perform_tuning()
    assert len(opened) == sessions
    assert model == "retrained"  # CV keeps no model: the best retrains on the full set


def test_per_trial_splits_give_each_trial_its_rows():
    ds = MultiOmicDataset(**_arrays())
    model = DirectPred(BASE, ds, target_variables=["y"], device="cpu")
    tr, _ = trials.equal_kfold_indices(N, 5, seed=42)
    for seeds in ([0] * 5, list(range(5))):
        params, buffers = _init_stacked(model, seeds)
        r = _Round(model, params, buffers, lrs=[1e-3] * 5, seeds=seeds)
        table = r.epoch_rows(tr, 4, 8).numpy()
        assert table.shape == (4, 5, 8)
        for k in range(5):
            assert set(table[:, k].ravel()) <= set(tr[k])
            assert len(set(table[:, k].ravel())) == 32
        if seeds[0] == seeds[1]:  # one seed: one permutation, each trial's own rows
            pos = [np.searchsorted(np.sort(tr[k]), table[:, k].ravel()) for k in range(2)]
            orders = [np.argsort(tr[k])[p] for k, p in enumerate(pos)]
            np.testing.assert_array_equal(orders[0], orders[1])


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("cv")
    write_synthetic_folder(str(root / "data"), n_train=60, n_test=20,
                           n_features={"gex": 30, "cnv": 20}, n_classes=3, seed=4)
    return root


CONFIG = """%s:
  - {type: Integer, low: 8, high: 16, name: latent_dim}
  - {type: Real, low: 0.2, high: 0.5, name: hidden_dim_factor}
  - {type: Real, low: 0.0001, high: 0.01, prior: log-uniform, name: lr}
  - {type: Categorical, categories: [4, 8], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
"""


@pytest.mark.parametrize("model_class,extra", [
    ("DirectPred", ()), ("supervised_vae", ()),
    ("CrossModalPred", ("--input_layers", "gex", "--output_layers", "cnv")),
])
def test_cli_use_cv_writes_the_tables(model_class, extra, folder, tmp_path, capsys):
    config = tmp_path / "hpo.yaml"
    config.write_text(CONFIG % model_class)
    out = tmp_path / "out"
    assert main(["--data_path", str(folder / "data"), "--model_class", model_class,
                 "--data_types", "gex,cnv", "--target_variables", "subtype", "--hpo_iter", "3",
                 "--hpo_batch", "3", "--use_cv", "--features_top_percentile", "50",
                 "--features_min", "10", "--safetensors", "--disable_marker_finding",
                 "--device", "cpu", "--config_path", str(config), "--outdir", str(out),
                 "--prefix", "job", *extra]) == 0
    printed = capsys.readouterr().out
    assert ("x 5 CV folds" in printed) or ("5-fold CV (stacked, concurrent)" in printed)
    assert "Final full-data training with best params" in printed
    names = ["stats.csv", "predicted_labels.csv", "embeddings_train.csv", "embeddings_test.csv",
             "final_model.safetensors", "final_model_config.json", "artifacts.json"]
    if model_class == "CrossModalPred":
        names.append("cnv_decoded.csv")
    for name in names:
        assert os.path.exists(out / f"job.{name}"), name
