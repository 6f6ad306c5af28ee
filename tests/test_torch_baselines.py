"""The classical baselines (``utils/classical``, ``utils/baselines.py``, the
CLI's ``--model_class RandomForest|SVM|XGBoost|RandomSurvivalForest`` and
``--evaluate_baseline_performance``) against sklearn, as the JAX package
uses it (``flexynesis_tpu/utils/baselines.py``):

* ``KFold`` gives sklearn's folds index for index; ``GridSearchCV`` iterates
  sklearn's candidate order and picks the first of the best rank on a grid
  with a tie, and the same SVR candidate as sklearn on data; the batched
  grid scores of the forests and boosters equal separate fits exactly;
* ``PCA.transform`` within rtol 1e-5 (float32, the same LAPACK routine);
* SVR predictions and SVC one-vs-one decision values within atol 5e-3 of
  JAX's ``_grids`` estimators at each kernel and C (5 x the solver's
  ``tol``: only the stopping point of the convex problem parts them), and
  SVC's votes equal;
* GradientBoosting regressor (continuous, tie-free targets) at each grid
  depth: predictions on the training rows within 1e-9 of JAX's estimator.
  On held-out rows a split that sets apart the same training rows through
  another feature (an equal-partition tie, which sklearn breaks by its
  random feature order and the port by the lowest feature index) routes
  new rows differently, so there the bound is R² within 0.05;
* the Nelson-Aalen cumulative hazard and martingale residuals equal JAX's
  bit for bit (float64);
* random forests and Platt probabilities cannot match sklearn draw for
  draw: on the ``TestBaselines`` data (``tests/test_aux_utils.py``), fed to
  both packages as the same arrays, the forest with PCA keeps balanced
  accuracy above 0.8, the classifiers' metrics lie within 0.1 of JAX's,
  the regressors' R² within 0.1 and the survival forest's C-index within
  0.05;
* the output tables carry JAX's columns, and the CLI writes them for each
  classical ``--model_class`` and beside a deep model, skipping with a
  warning a target without labels and a degenerate survival column (the
  CLI runs use a reduced grid; the grids themselves are compared above)."""

import numpy as np
import pytest

import sklearn.decomposition as skd
import sklearn.model_selection as skms
from sklearn.base import BaseEstimator

from flexynesis_tpu.data.dataset import MultiOmicDataset as JaxDataset
from flexynesis_tpu.utils import baselines as jax_baselines
from flexynesis_torch.__main__ import main
from flexynesis_torch.data.importer import DataImporter
from flexynesis_torch.utils import baselines, classical
from flexynesis_torch.utils.classical.model_selection import Estimator
from flexynesis_torch.utils.csvio import read_table
from flexynesis_torch.utils.synthetic import write_synthetic_folder


def _data(n=120, F=12, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, F)).astype(np.float32)
    yc = (X[:, 0] + 0.5 * X[:, 1] + 0.3 * rng.normal(size=n) > 0).astype(int) + (X[:, 2] > 0.8)
    yr = 2 * X[:, 0] + X[:, 3] ** 2 + 0.1 * rng.normal(size=n)
    Xt = rng.normal(size=(40, F)).astype(np.float32)
    return X, yc, yr.astype(np.float64), Xt


@pytest.mark.parametrize("n", [5, 23, 80, 81])
def test_kfold_matches_sklearn(n):
    want = list(jax_baselines.KFold(n_splits=5, shuffle=True, random_state=42).split(np.zeros(n)))
    got = list(classical.KFold(n_splits=5, shuffle=True, random_state=42).split(np.zeros(n)))
    assert len(got) == len(want)
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


class _SkScored(BaseEstimator):
    """A deterministic estimator whose score is fixed by its parameters."""

    def __init__(self, a=0, b="x"):
        self.a, self.b = a, b

    def fit(self, X, y):
        return self

    def score(self, X, y):
        return -((self.a - 1) ** 2) + (0.5 if self.b == "y" else 0.0)


class _PortScored(Estimator):
    def fit(self, X, y):
        return self

    def score(self, X, y):
        return -((self.params["a"] - 1) ** 2) + (0.5 if self.params["b"] == "y" else 0.0)


def test_grid_order_and_ties_match_sklearn():
    grid = {"b": ["x", "y"], "a": [0, 2, 1, 3]}  # a = 0 and 2 tie
    X, y = np.zeros((10, 2)), np.zeros(10)
    sk = skms.GridSearchCV(_SkScored(), grid, cv=skms.KFold(5)).fit(X, y)
    ours = classical.GridSearchCV(_PortScored(a=0, b="x"), grid,
                                  cv=classical.KFold(5)).fit(X, y)
    assert ours.cv_results_["params"] == list(sk.cv_results_["params"])
    assert list(classical.ParameterGrid(grid)) == list(skms.ParameterGrid(grid))
    np.testing.assert_array_equal(ours.cv_results_["rank_test_score"],
                                  sk.cv_results_["rank_test_score"])
    assert ours.best_index_ == sk.best_index_ and ours.best_params_ == sk.best_params_
    tied = {"a": [0, 2]}  # the earliest of the best rank
    sk = skms.GridSearchCV(_SkScored(), tied, cv=skms.KFold(5)).fit(X, y)
    ours = classical.GridSearchCV(_PortScored(a=0, b="x"), tied, cv=classical.KFold(5)).fit(X, y)
    assert ours.best_params_ == sk.best_params_ == {"a": 0}


def test_svr_grid_picks_sklearns_candidate():
    X, _, yr, _ = _data()
    est, grid = jax_baselines._grids("SVM", "numerical")
    kf = dict(n_splits=5, shuffle=True, random_state=42)
    sk = skms.GridSearchCV(est, grid, cv=skms.KFold(**kf)).fit(X, yr)
    pest, pgrid = baselines._grids("SVM", "numerical", device="cpu")
    ours = classical.GridSearchCV(pest, pgrid, cv=classical.KFold(**kf)).fit(X, yr)
    assert ours.best_params_ == sk.best_params_
    np.testing.assert_allclose(ours.cv_results_["mean_test_score"],
                               sk.cv_results_["mean_test_score"], atol=5e-3)


@pytest.mark.parametrize("name,kind", [("RandomForest", "categorical"),
                                       ("RandomForest", "numerical"),
                                       ("XGBoost", "categorical"), ("XGBoost", "numerical")])
def test_batched_grid_scores_equal_separate_fits(name, kind):
    X, yc, yr, _ = _data(n=45, F=6)
    y = yc if kind == "categorical" else yr
    est, _ = baselines._grids(name, kind, device="cpu")
    grid = ({"n_estimators": [3, 6], "max_depth": [2, None]} if name == "RandomForest" else
            {"n_estimators": [3, 6], "max_depth": [2, 3], "learning_rate": [0.1, 0.2]})
    cv = classical.KFold(3, shuffle=True, random_state=42)
    batched = classical.GridSearchCV(est, grid, cv).fit(X, y).cv_results_["split_scores"]
    separate = est.clone()
    separate.grid_scores = lambda *a: None
    alone = classical.GridSearchCV(separate, grid, cv).fit(X, y).cv_results_["split_scores"]
    np.testing.assert_array_equal(batched, alone)


def test_pca_matches_sklearn():
    X, _, _, Xt = _data(n=60, F=20)
    ours, theirs = classical.PCA(7).fit(X), skd.PCA(7).fit(X)
    np.testing.assert_allclose(ours.transform(Xt), theirs.transform(Xt), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="n_components"):
        classical.PCA(30).fit(X[:10])


@pytest.mark.parametrize("kernel", ["rbf", "poly"])
@pytest.mark.parametrize("C", [0.1, 1, 10])
def test_svm_matches_sklearn(kernel, C):
    X, yc, yr, Xt = _data()
    svr, _ = jax_baselines._grids("SVM", "numerical")
    svc, _ = jax_baselines._grids("SVM", "categorical")
    svr.set_params(C=C, kernel=kernel).fit(X, yr)
    svc.set_params(C=C, kernel=kernel, decision_function_shape="ovo").fit(X, yc)
    psvr, _ = baselines._grids("SVM", "numerical", device="cpu")
    psvc, _ = baselines._grids("SVM", "categorical", device="cpu")
    psvr = psvr.clone(C=C, kernel=kernel).fit(X, yr)
    psvc = psvc.clone(C=C, kernel=kernel).fit(X, yc)
    np.testing.assert_allclose(psvr.predict(Xt), svr.predict(Xt), atol=5e-3)
    np.testing.assert_allclose(psvc.decision_values(Xt), svc.decision_function(Xt), atol=5e-3)
    np.testing.assert_array_equal(psvc.predict(Xt), svc.predict(Xt))
    proba = psvc.predict_proba(Xt)
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-6)
    assert (proba >= 0).all()


@pytest.mark.parametrize("depth", [3, 6, 9])
def test_gradient_boosting_regressor_matches_sklearn(depth):
    X, _, yr, Xt = _data(n=150, F=10, seed=2)
    theirs, _ = jax_baselines._grids("XGBoost", "numerical")
    theirs.set_params(n_estimators=100, max_depth=depth, learning_rate=0.1).fit(X, yr)
    ours, _ = baselines._grids("XGBoost", "numerical", device="cpu")
    ours = ours.clone(n_estimators=100, max_depth=depth, learning_rate=0.1).fit(X, yr)
    np.testing.assert_allclose(ours.predict(X), theirs.predict(X), rtol=0, atol=1e-9)
    rng = np.random.default_rng(3)
    y_new = 2 * Xt[:, 0] + Xt[:, 3] ** 2 + 0.1 * rng.normal(size=len(Xt))
    r2 = lambda p: 1 - np.sum((y_new - p) ** 2) / np.sum((y_new - y_new.mean()) ** 2)  # noqa: E731
    assert abs(r2(ours.predict(Xt)) - r2(theirs.predict(Xt))) < 0.05


@pytest.mark.parametrize("K", [2, 3])
def test_gradient_boosting_classifier_probabilities(K):
    """Log-loss boosting: probabilities are distributions, the prior's link
    starts them (zero stages give the class frequencies, as sklearn's
    ``init``), and the training fit separates the classes as sklearn's does."""
    X, yc, _, _ = _data(n=90, F=8, seed=4)
    y = np.minimum(yc, K - 1)
    ours, _ = baselines._grids("XGBoost", "categorical", device="cpu")
    base = ours.clone(n_estimators=0).fit(X, y)
    freq = np.bincount(y) / len(y)
    np.testing.assert_allclose(base.predict_proba(X[:3]), np.tile(freq, (3, 1)), rtol=1e-12)
    fitted = ours.clone(n_estimators=30, max_depth=3).fit(X, y)
    theirs, _ = jax_baselines._grids("XGBoost", "categorical")
    theirs.set_params(n_estimators=30, max_depth=3).fit(X, y)
    proba = fitted.predict_proba(X)
    np.testing.assert_allclose(proba.sum(1), 1.0, atol=1e-12)
    assert abs(np.mean(fitted.predict(X) == y) - np.mean(theirs.predict(X) == y)) <= 0.05


def test_nelson_aalen_bit_for_bit():
    rng = np.random.default_rng(5)
    d = np.round(rng.exponential(10, 200), 1)  # ties included
    e = (rng.random(200) < 0.6).astype(np.float64)
    t = np.linspace(-1, 40, 77)
    np.testing.assert_array_equal(baselines.nelson_aalen_cumhaz(d, e)(t),
                                  jax_baselines.nelson_aalen_cumhaz(d, e)(t))
    np.testing.assert_array_equal(baselines._martingale_residuals(d, e),
                                  jax_baselines._martingale_residuals(d, e))


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """The TestBaselines cohort (tests/test_aux_utils.py), imported by the
    port; the JAX baselines get the same arrays."""
    p = tmp_path_factory.mktemp("bl")
    write_synthetic_folder(str(p), n_train=80, n_test=40, seed=15)
    train, test = DataImporter(str(p), ["gex"], top_percentile=50, min_features=20,
                               device="cpu").import_data()
    def as_jax(ds):
        return JaxDataset(dat=ds.dat, ann=ds.ann, variable_types=ds.variable_types,
                          features=ds.features, samples=ds.samples,
                          label_mappings=ds.label_mappings)

    return (train, test), (as_jax(train), as_jax(test))


def _metrics(rows):
    return {r["metric"]: float(r["value"]) for r in rows}


@pytest.mark.parametrize("method,var,pca", [("RandomForest", "subtype", True),
                                            ("SVM", "subtype", False),
                                            ("RandomForest", "age", False),
                                            ("SVM", "age", False)])
def test_baseline_metrics_near_jax(split, method, var, pca):
    check_metrics_near_jax(split, method, var, pca)


def check_metrics_near_jax(split, method, var, pca):
    """The port's baseline tables against JAX's on the same arrays: the same
    columns and rows, the metrics within the module docstring's margins."""
    (train, test), (jtrain, jtest) = split
    kw = dict(n_folds=3, n_jobs=2, use_pca=pca, n_components=10)
    stats, preds = baselines.evaluate_baseline_performance(train, test, var, [method],
                                                           device="cpu", **kw)
    jstats, jpreds = jax_baselines.evaluate_baseline_performance(jtrain, jtest, var, [method],
                                                                 **kw)
    assert list(stats[0]) == list(jstats.columns)
    assert list(preds[0]) == list(jpreds.columns) and len(preds) == len(jpreds)
    assert [r["method"] for r in stats] == list(jstats["method"])
    ours, theirs = _metrics(stats), dict(zip(jstats["metric"], jstats["value"]))
    assert ours.keys() == theirs.keys()
    if var == "subtype":
        if pca:
            assert ours["balanced_acc"] > 0.8
        for m in ("balanced_acc", "f1_score", "kappa", "average_auroc"):
            assert abs(ours[m] - theirs[m]) <= 0.1, m
    else:
        assert abs(ours["r2"] - theirs["r2"]) <= 0.1


def test_survival_baseline_near_jax(split):
    (train, test), (jtrain, jtest) = split
    stats, preds = baselines.evaluate_baseline_survival_performance(
        train, test, "OS_MONTHS", "OS_STATUS", n_folds=3, n_jobs=2, device="cpu")
    jstats, jpreds = jax_baselines.evaluate_baseline_survival_performance(
        jtrain, jtest, "OS_MONTHS", "OS_STATUS", n_folds=3, n_jobs=2)
    assert list(stats[0]) == list(jstats.columns) and stats[0]["metric"] == "cindex"
    assert list(preds[0]) == list(jpreds.columns)
    assert all(r["method"] == "RandomSurvivalForest" for r in preds)
    assert abs(stats[0]["value"] - float(jstats["value"].iloc[0])) <= 0.05


def test_n_jobs_sets_torch_threads_on_the_cpu(split, monkeypatch):
    """On the CPU the baselines fit with ``n_jobs`` torch threads (the CLI's
    ``--threads``) and give the count back after."""
    import torch

    (train, test), _ = split
    seen = []

    class Grid(baselines.GridSearchCV):
        def fit(self, X, y):
            seen.append(torch.get_num_threads())
            return super().fit(X, y)

    class Forest(baselines.RandomForestRegressor):
        def fit(self, X, y):
            seen.append(torch.get_num_threads())
            return super().fit(X, y)

    monkeypatch.setattr(baselines, "GridSearchCV", Grid)
    monkeypatch.setattr(baselines, "RandomForestRegressor", Forest)
    monkeypatch.setattr(baselines, "_grids", lambda m, v, device: (
        baselines.SVR(device=device), {"C": [1]}))
    before = torch.get_num_threads()
    want = 1 if before > 1 else 2
    baselines.evaluate_baseline_performance(train, test, "age", ["SVM"], n_folds=3,
                                            n_jobs=want, device="cpu")
    baselines.evaluate_baseline_survival_performance(train, test, "OS_MONTHS", "OS_STATUS",
                                                     n_folds=3, n_jobs=want, device="cpu")
    assert seen == [want] * 5
    assert torch.get_num_threads() == before


def test_unlabeled_target_raises(split):
    (train, test), _ = split
    train.ann["empty"] = np.full(len(train), np.nan, dtype=np.float32)
    train.variable_types["empty"] = "numerical"
    try:
        with pytest.raises(ValueError, match="No labeled samples"):
            baselines.evaluate_baseline_performance(train, test, "empty", ["SVM"], device="cpu")
    finally:
        del train.ann["empty"], train.variable_types["empty"]


# ------------------------------------------------------------------ the CLI


SMALL = {"RandomForest": {"n_estimators": [4, 8], "max_depth": [3, None]},
         "SVM": {"C": [1, 10], "kernel": ["rbf"]},
         "XGBoost": {"n_estimators": [3, 5], "max_depth": [2], "learning_rate": [0.1]}}


@pytest.fixture
def small_grids(monkeypatch):
    real = baselines._grids

    def grids(method, variable_type, device="auto"):
        return real(method, variable_type, device)[0], SMALL[method]

    monkeypatch.setattr(baselines, "_grids", grids)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "data"
    write_synthetic_folder(str(p), n_train=50, n_test=20, n_features={"gex": 30}, seed=7)
    return p


def _cli(folder, out, *extra):
    return ["--data_path", str(folder), "--data_types", "gex",
            "--features_top_percentile", "50", "--features_min", "10",
            "--device", "cpu", "--outdir", str(out), "--prefix", "job", *extra]


@pytest.mark.parametrize("model_class", ["RandomForest", "SVM", "XGBoost"])
def test_cli_classical_model_class(folder, tmp_path, small_grids, model_class):
    assert main(_cli(folder, tmp_path, "--model_class", model_class,
                     "--target_variables", "subtype,age")) == 0
    assert sorted(p.name for p in tmp_path.iterdir() if p.name.startswith("job.")) == [
        "job.feature_logs.gex.csv", "job.predicted_labels.csv", "job.stats.csv"]
    names, cols, rows = read_table(str(tmp_path / "job.stats.csv"))
    assert cols == ["var", "variable_type", "metric", "value"]
    assert set(names) == {f"{model_class}Classifier", f"{model_class}Regressor"}
    _, pcols, prows = read_table(str(tmp_path / "job.predicted_labels.csv"))
    assert pcols == ["variable", "class_label", "probability", "known_label",
                     "predicted_label", "split", "method"]
    assert {r[-1] for r in prows} == {model_class}


def test_cli_survival_forest(folder, tmp_path):
    assert main(_cli(folder, tmp_path, "--model_class", "RandomSurvivalForest",
                     "--surv_event_var", "OS_STATUS", "--surv_time_var", "OS_MONTHS")) == 0
    names, cols, rows = read_table(str(tmp_path / "job.stats.csv"))
    assert names == ["RandomSurvivalForest"] and rows[0][2] == "cindex"
    assert 0.0 <= float(rows[0][3]) <= 1.0


CONFIG = """DirectPred:
  - {type: Categorical, categories: [8], name: latent_dim}
  - {type: Categorical, categories: [0.3], name: hidden_dim_factor}
  - {type: Categorical, categories: [0.001], name: lr}
  - {type: Categorical, categories: [6], name: supervisor_hidden_dim}
  - {type: Categorical, categories: [2], name: epochs}
  - {type: Categorical, categories: [16], name: batch_size}
"""


def test_cli_evaluate_baseline_performance(folder, tmp_path, small_grids, capsys):
    config = tmp_path / "hpo.yaml"
    config.write_text(CONFIG)
    assert main(_cli(folder, tmp_path / "out", "--model_class", "DirectPred",
                     "--target_variables", "subtype", "--surv_event_var", "OS_STATUS",
                     "--surv_time_var", "OS_MONTHS", "--config_path", str(config),
                     "--hpo_iter", "1", "--safetensors", "--disable_marker_finding",
                     "--evaluate_baseline_performance")) == 0
    names, _, rows = read_table(str(tmp_path / "out" / "job.baseline.stats.csv"))
    assert set(names) == {"RandomForestClassifier", "SVMClassifier", "XGBoostClassifier",
                          "RandomSurvivalForest"}
    _, _, prows = read_table(str(tmp_path / "out" / "job.baseline.predicted_labels.csv"))
    assert {r[-1] for r in prows} == {"RandomForest", "SVM", "XGBoost", "RandomSurvivalForest"}
    assert (tmp_path / "out" / "job.stats.csv").exists()


def test_baseline_comparison_skips_with_warnings(split, tmp_path, small_grids, capsys):
    """``--evaluate_baseline_performance``'s comparison skips a target with no
    labels and a survival column without an admissible pair (all censored)
    with the JAX CLI's warnings, and writes the rest."""
    import argparse

    from flexynesis_torch.__main__ import _run_baseline_comparison

    (train, test), _ = split
    for ds in (train, test):
        ds.ann["blank"] = np.full(len(ds), np.nan, dtype=np.float32)
        ds.ann["never"] = np.zeros(len(ds), dtype=np.float32)
        ds.variable_types.update(blank="numerical", never="numerical")
    args = argparse.Namespace(target_variables="subtype,blank", surv_event_var="never",
                              surv_time_var="OS_MONTHS", threads=2, outdir=str(tmp_path),
                              prefix="job")
    try:
        _run_baseline_comparison(args, train, test, "cpu")
    finally:
        for ds in (train, test):
            del ds.ann["blank"], ds.ann["never"]
    out = capsys.readouterr().out
    assert "[WARN] Skipping baseline comparison for 'blank'" in out
    assert "[WARN] Skipping survival baseline comparison" in out
    names, _, _ = read_table(str(tmp_path / "job.baseline.stats.csv"))
    assert set(names) == {"RandomForestClassifier", "SVMClassifier", "XGBoostClassifier"}
