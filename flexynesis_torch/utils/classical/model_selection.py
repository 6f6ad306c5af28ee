"""``KFold``, ``ParameterGrid`` and ``GridSearchCV`` as sklearn 1.9 runs them
for the baselines."""

from __future__ import annotations

import itertools
from typing import Dict, List

import numpy as np
from scipy.stats import rankdata


class KFold:
    """sklearn's ``KFold``: the indices shuffled by
    ``np.random.RandomState(random_state)``, the first ``n % n_splits`` folds
    one longer, train and test indices each in ascending order."""

    def __init__(self, n_splits: int = 5, shuffle: bool = False, random_state=None):
        self.n_splits, self.shuffle, self.random_state = n_splits, shuffle, random_state

    def split(self, X):
        n = len(X)
        if self.n_splits > n:
            raise ValueError(f"Cannot have number of splits n_splits={self.n_splits} "
                             f"greater than the number of samples: n_samples={n}.")
        indices = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.random_state).shuffle(indices)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        start = 0
        for size in sizes:
            test = np.zeros(n, dtype=bool)
            test[indices[start:start + size]] = True
            start += size
            yield np.flatnonzero(~test), np.flatnonzero(test)


class ParameterGrid:
    """The candidates of a grid in sklearn's order: keys sorted, the last key
    varying fastest."""

    def __init__(self, grid: Dict[str, list]):
        self.grid = grid

    def __iter__(self):
        keys = sorted(self.grid)
        for values in itertools.product(*(self.grid[k] for k in keys)):
            yield dict(zip(keys, values))

    def __len__(self):
        return int(np.prod([len(v) for v in self.grid.values()]))


class GridSearchCV:
    """Each candidate's mean score (the estimator's ``score``: accuracy or R²)
    over the folds of ``cv``; the best is the first candidate of rank 1 (ties
    go to the earliest in grid order), refitted on all of X. An estimator
    with ``grid_scores`` scores every candidate on every fold in one call
    (the forests and the boosters fit the folds side by side and nested
    candidates once); the scores are those of separate fits."""

    def __init__(self, estimator, param_grid: Dict[str, list], cv: KFold):
        self.estimator, self.param_grid, self.cv = estimator, param_grid, cv

    def fit(self, X, y):
        candidates: List[dict] = list(ParameterGrid(self.param_grid))
        splits = list(self.cv.split(X))
        scores = None
        if hasattr(self.estimator, "grid_scores"):
            scores = self.estimator.grid_scores(X, y, splits, candidates)
        if scores is None:
            scores = np.zeros((len(candidates), len(splits)))
            for k, (tr, te) in enumerate(splits):
                for c, params in enumerate(candidates):
                    est = self.estimator.clone(**params).fit(X[tr], y[tr])
                    scores[c, k] = est.score(X[te], y[te])
        means = scores.mean(axis=1)
        if np.isnan(means).all():
            rank = np.ones(len(means), dtype=np.int32)
        else:
            filled = np.nan_to_num(means, nan=np.nanmin(means) - 1)
            rank = rankdata(-filled, method="min").astype(np.int32)
        self.cv_results_ = {"params": candidates, "mean_test_score": means,
                            "rank_test_score": rank, "split_scores": scores}
        self.best_index_ = int(rank.argmin())
        self.best_params_ = candidates[self.best_index_]
        self.best_estimator_ = self.estimator.clone(**self.best_params_).fit(X, y)
        return self


def accuracy(y_true, y_pred) -> float:
    return float(np.mean(np.asarray(y_true) == np.asarray(y_pred)))


def r2(y_true, y_pred) -> float:
    """sklearn's ``r2_score`` (``force_finite``: 1 for a perfect fit of a
    constant target, else 0)."""
    y_true = np.asarray(y_true, dtype=np.float64)
    num = float(np.sum((y_true - np.asarray(y_pred, dtype=np.float64)) ** 2))
    den = float(np.sum((y_true - y_true.mean()) ** 2))
    if den == 0:
        return 1.0 if num == 0 else 0.0
    return 1.0 - num / den


class Estimator:
    """Constructor arguments kept for ``clone``; ``score`` by the kind."""

    classifier = False

    def __init__(self, **params):
        self.params = params

    def clone(self, **params):
        return type(self)(**{**self.params, **params})

    def score(self, X, y) -> float:
        return accuracy(y, self.predict(X)) if self.classifier else r2(y, self.predict(X))
