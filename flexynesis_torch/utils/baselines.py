"""Classical-ML baselines, without sklearn or pandas.

Counterpart of ``flexynesis_tpu/utils/baselines.py`` (reference
utils.py:837-1099) on the port's own estimators (``utils/classical``):
RandomForest, SVM and "XGBoost" (GradientBoosting, as in the JAX package,
which keeps the name) classifiers and regressors tuned by 5-fold
``GridSearchCV`` over the same grids, optional PCA, and a
"RandomSurvivalForest": a ``RandomForestRegressor`` on Nelson-Aalen
martingale residuals, scored by the C-index in 5-fold CV and on the test
set. The tables are lists of row dicts with the JAX package's columns
(``method``, ``var``, ``variable_type``, ``metric``, ``value``; the
prediction rows of ``metrics.get_predicted_labels``). The trees and the SVM
kernel matrices run on ``device`` (the CLI's), PCA and the SMO solver on the
host; on the CPU ``n_jobs`` is torch's thread count for the call.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .classical import (
    PCA,
    SVC,
    SVR,
    GradientBoostingClassifier,
    GradientBoostingRegressor,
    GridSearchCV,
    KFold,
    RandomForestClassifier,
    RandomForestRegressor,
)
from .device import host_threads
from .metrics import (
    concordance_index,
    evaluate_classifier,
    evaluate_regressor,
    get_predicted_labels,
)

BASELINE_METHODS = ("RandomForest", "SVM", "XGBoost")


def _prepare_xy(dataset, variable_name, use_pca=False, pca_model=None, fit_pca=False):
    X = np.concatenate([m for m in dataset.dat.values()], axis=1)
    y = np.asarray(dataset.ann[variable_name], dtype=np.float64)
    valid = ~np.isnan(y)
    if dataset.variable_types.get(variable_name) == "categorical":
        # -1 encodes a missing or unseen label; metrics mask it the same way
        valid &= y != -1
    if not valid.any():
        raise ValueError(
            f"No labeled samples for '{variable_name}' after dropping "
            "missing values — cannot fit/evaluate a baseline on an "
            "entirely unlabeled cohort."
        )
    X, y = X[valid], y[valid]
    if use_pca and pca_model is not None:
        if fit_pca:
            pca_model.fit(X)
        X = pca_model.transform(X)
    return X, y, np.where(valid)[0]


def _grids(method: str, variable_type: str, device="auto"):
    trees = {"n_estimators": [100, 200, 300], "max_depth": [10, 20, None]}
    svm = {"C": [0.1, 1, 10], "kernel": ["rbf", "poly"]}
    boost = {"n_estimators": [100, 200, 300], "max_depth": [3, 6, 9],
             "learning_rate": [0.01, 0.1, 0.2]}
    if variable_type == "categorical":
        if method == "RandomForest":
            return RandomForestClassifier(random_state=42, device=device), trees
        if method == "SVM":
            return SVC(probability=True, random_state=42, device=device), svm
        if method == "XGBoost":
            return GradientBoostingClassifier(random_state=42, device=device), boost
    else:
        if method == "RandomForest":
            return RandomForestRegressor(random_state=42, device=device), trees
        if method == "SVM":
            return SVR(device=device), svm
        if method == "XGBoost":
            return GradientBoostingRegressor(random_state=42, device=device), boost
    raise ValueError(f"Unknown baseline method: {method}")


def evaluate_baseline_performance(
    train_dataset,
    test_dataset,
    variable_name: str,
    methods: List[str],
    n_folds: int = 5,
    n_jobs: int = 4,
    use_pca: bool = False,
    n_components: int = 100,
    device="auto",
) -> Tuple[List[dict], List[dict]]:
    pca_model = PCA(n_components=n_components) if use_pca else None
    variable_type = train_dataset.variable_types[variable_name]

    X_train, y_train, _ = _prepare_xy(
        train_dataset, variable_name, use_pca, pca_model, fit_pca=True
    )
    X_test, y_test, test_idx = _prepare_xy(
        test_dataset, variable_name, use_pca, pca_model, fit_pca=False
    )

    with host_threads(n_jobs, device):
        kf = KFold(n_splits=n_folds, shuffle=True, random_state=42)
        metrics_rows, predictions = [], []
        for method in methods:
            model, params = _grids(method, variable_type, device)
            print(f"[INFO] Baseline grid search: {method} ({variable_type})")
            gs = GridSearchCV(model, params, cv=kf)
            gs.fit(X_train, y_train.astype(int) if variable_type == "categorical" else y_train)
            best = gs.best_estimator_

            if variable_type == "categorical":
                y_probs = best.predict_proba(X_test)
                metrics = evaluate_classifier(y_test.astype(int), y_probs)
                y_pred_dict = {variable_name: y_probs}
            else:
                y_pred = best.predict(X_test)
                metrics = evaluate_regressor(y_test, y_pred)
                y_pred_dict = {variable_name: y_pred}

            predictions += get_predicted_labels(
                y_pred_dict, test_dataset.subset(test_idx), "test", method
            )
            suffix = "Classifier" if variable_type == "categorical" else "Regressor"
            for metric, value in metrics.items():
                metrics_rows.append({
                    "method": method + suffix,
                    "var": variable_name,
                    "variable_type": variable_type,
                    "metric": metric,
                    "value": value,
                })
    return metrics_rows, predictions


def nelson_aalen_cumhaz(durations: np.ndarray, events: np.ndarray):
    """Nelson-Aalen cumulative hazard H0(t) as a step function (per-row
    increments over the time-sorted rows, as the JAX package computes it)."""
    order = np.argsort(durations)
    t_sorted = durations[order]
    e_sorted = events[order]
    n = len(durations)
    at_risk = n - np.arange(n)
    H = np.cumsum(e_sorted / at_risk)

    def H0(t):
        idx = np.searchsorted(t_sorted, t, side="right") - 1
        return np.where(idx >= 0, H[np.clip(idx, 0, n - 1)], 0.0)

    return H0


def _martingale_residuals(durations, events):
    H0 = nelson_aalen_cumhaz(durations, events)
    return events - H0(durations)


def evaluate_baseline_survival_performance(
    train_dataset,
    test_dataset,
    duration_col: str,
    event_col: str,
    n_folds: int = 5,
    n_jobs: int = 4,
    device="auto",
) -> Tuple[List[dict], List[dict]]:
    """Martingale-residual forest survival baseline; reports the C-index."""
    print("[INFO] Evaluating baseline survival prediction performance")

    def prep(ds):
        X = np.concatenate([m for m in ds.dat.values()], axis=1)
        d = np.asarray(ds.ann[duration_col], dtype=np.float64)
        e = np.asarray(ds.ann[event_col], dtype=np.float64)
        valid = ~np.isnan(d) & ~np.isnan(e)
        return X[valid], d[valid], e[valid], np.where(valid)[0]

    X_train, d_train, e_train, _ = prep(train_dataset)
    X_test, d_test, e_test, test_idx = prep(test_dataset)
    if len(d_train) < n_folds or len(d_test) == 0:
        raise ValueError(
            f"Too few samples with observed '{duration_col}'/'{event_col}' "
            f"({len(d_train)} train, {len(d_test)} test) for the survival "
            "baseline."
        )

    def fit_rsf(X, d, e):
        rf = RandomForestRegressor(
            n_estimators=100, max_depth=5, min_samples_split=10, min_samples_leaf=15,
            max_features="sqrt", random_state=42, device=device,
        )
        return rf.fit(X, _martingale_residuals(d, e))

    with host_threads(n_jobs, device):
        kf = KFold(n_splits=n_folds, shuffle=True, random_state=42)
        cv_scores = []
        for tr, te in kf.split(X_train):
            rf = fit_rsf(X_train[tr], d_train[tr], e_train[tr])
            risk = rf.predict(X_train[te])
            cv_scores.append(concordance_index(d_train[te], -risk, e_train[te]))
        print(f"[INFO] Average C-index in cross-validation: {np.mean(cv_scores):.4f}")

        rf = fit_rsf(X_train, d_train, e_train)
        test_risk = rf.predict(X_test)
    test_c = concordance_index(d_test, -test_risk, e_test)
    print(f"[INFO] C-index on test data: {test_c:.4f}")

    predicted = get_predicted_labels(
        {event_col: test_risk}, test_dataset.subset(test_idx), "test", "RandomSurvivalForest",
    )
    metrics = [{
        "method": "RandomSurvivalForest",
        "var": event_col,
        "variable_type": "numerical",
        "metric": "cindex",
        "value": test_c,
    }]
    return metrics, predicted
