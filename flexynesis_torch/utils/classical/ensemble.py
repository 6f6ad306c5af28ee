"""Random forests and gradient boosting on the batched CART builder
(``tree.py``), in torch on the estimator's device.

* ``RandomForestClassifier``/``Regressor``: sklearn's bootstrap draws
  exactly (each tree's seed from ``RandomState(random_state)``, its sample
  counts from ``RandomState(seed).randint(0, n, n)``), every tree of the
  forest grown at once, ``max_features`` drawn per node (``tree.py``; not
  sklearn's draws), leaf class fractions or means averaged over the trees.
* ``GradientBoostingClassifier``/``Regressor``: log-loss (one tree per
  stage for two classes, one per class and stage above; the class prior's
  link as the initial score; Newton leaf values sum(g)/sum(p(1-p)), times
  (K-1)/K above two classes) or squared error (the mean as the initial
  score); ``subsample`` 1.0, so nothing is drawn.

``grid_scores`` scores every candidate of a grid on every fold in one fit:
the folds train side by side as trees whose samples outside the fold weigh
0 (left out of every node, as in a separate fit); a forest of the most trees
grown to the deepest ``max_depth`` holds every smaller, shallower forest of
the grid as its first trees and top levels; a booster's first stages are the
booster of fewer estimators, and its learning rates and depths train side by
side as more trees of one batch. Each score is that of the candidate's own
fit on the fold.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ..device import resolve_device
from .model_selection import Estimator, accuracy, r2
from .tree import feature_importances, grow, predict, presort


def _max_features(value, F: int) -> int:
    if value is None:
        return F
    if value == "sqrt":
        return max(1, int(np.sqrt(F)))
    if isinstance(value, float):
        return max(1, int(value * F))
    return int(value)


class _Torch(Estimator):
    def _device(self):
        return resolve_device(self.params.get("device", "auto"))

    def _x(self, X) -> torch.Tensor:
        return torch.as_tensor(np.asarray(X, dtype=np.float32), device=self._device())

    def _param(self, candidate: dict, name: str):
        return candidate.get(name, self.params[name])

    def _codes(self, y):
        """(target values, n_classes) the trees fit; a classifier's classes."""
        if not self.classifier:
            return np.asarray(y, dtype=np.float64), 0
        self.classes_, codes = np.unique(y, return_inverse=True)
        return codes, len(self.classes_)

    def _scores(self, y, splits, n_cand: int, out) -> np.ndarray:
        """(candidates, folds) scores of ``out(c, k)``: candidate c's class
        codes or values of every row, taken at fold k's test rows."""
        scores = np.zeros((n_cand, len(splits)))
        for k, (_, te) in enumerate(splits):
            for c in range(n_cand):
                pred = out(c, k)[te]
                scores[c, k] = (accuracy(y[te], self.classes_[pred]) if self.classifier
                                else r2(y[te], pred))
        return scores


class _Forest(_Torch):
    DEFAULTS = dict(n_estimators=100, max_depth=None, min_samples_split=2, min_samples_leaf=1,
                    random_state=None, device="auto")

    def __init__(self, **params):
        super().__init__(**{**self.DEFAULTS, **params})

    def _grow(self, X, target, n_classes, folds, n_estimators: int, max_depth):
        """The forests of ``n_estimators`` trees, one per fold (its training
        rows), side by side: T = folds x n_estimators trees."""
        p = self.params
        seeds = np.random.RandomState(p["random_state"]).randint(
            np.iinfo(np.int32).max, size=n_estimators)
        n = len(target)
        w = np.zeros((len(folds), n_estimators, n))
        for f, rows in enumerate(folds):
            for t, s in enumerate(seeds):
                draws = np.random.RandomState(s).randint(0, len(rows), len(rows), dtype=np.int32)
                w[f, t, rows] = np.bincount(draws, minlength=len(rows))
        Xd = self._x(X)
        dev = Xd.device
        T = len(folds) * n_estimators
        yt = torch.as_tensor(np.broadcast_to(np.asarray(target, dtype=np.float64), (T, n)).copy(),
                             device=dev)
        levels, _ = grow(Xd, presort(Xd), yt, torch.as_tensor(w.reshape(T, n), device=dev),
                         n_classes=n_classes, max_depth=max_depth,
                         min_samples_split=p["min_samples_split"],
                         min_samples_leaf=p["min_samples_leaf"],
                         max_features=_max_features(p["max_features"], X.shape[1]),
                         seeds=torch.as_tensor(np.tile(seeds, len(folds)), dtype=torch.long,
                                               device=dev))
        return levels

    def fit(self, X, y):
        target, n_classes = self._codes(y)
        self.n_features_in_ = np.shape(X)[1]
        self.levels_ = self._grow(X, target, n_classes, [np.arange(len(target))],
                                  self.params["n_estimators"], self.params["max_depth"])
        return self

    @property
    def feature_importances_(self) -> np.ndarray:
        """sklearn's: the mean over the trees with a split of each tree's
        normalised impurity decreases, normalised to sum 1."""
        per_tree = feature_importances(self.levels_, self.n_features_in_).cpu().numpy()
        grown = per_tree[(self.levels_[0].feature >= 0).cpu().numpy()[:, 0]]
        if not len(grown):
            return np.zeros(self.n_features_in_)
        mean = np.mean(grown, axis=0, dtype=np.float64)
        return mean / np.sum(mean)

    def _mean(self, X) -> np.ndarray:
        """(m, V) node values of X averaged over the trees (on the host, so
        every fold of ``grid_scores`` sums in the same order)."""
        return predict(self.levels_, self._x(X)).cpu().numpy().mean(0)

    def grid_scores(self, X, y, splits, candidates: List[dict]) -> Optional[np.ndarray]:
        target, n_classes = self._codes(y)
        depths = [self._param(c, "max_depth") for c in candidates]
        most = max(self._param(c, "n_estimators") for c in candidates)
        levels = self._grow(X, target, n_classes, [tr for tr, _ in splits], most,
                            None if None in depths else max(depths))
        by_depth = {d: predict(levels, self._x(X), d).view(len(splits), most, len(y), -1)
                    .cpu().numpy() for d in set(depths)}

        def out(c, k):
            mean = by_depth[depths[c]][k, : self._param(candidates[c], "n_estimators")].mean(0)
            return mean.argmax(-1) if self.classifier else mean[:, 0]

        return self._scores(np.asarray(y), splits, len(candidates), out)


class RandomForestClassifier(_Forest):
    classifier = True
    DEFAULTS = dict(_Forest.DEFAULTS, max_features="sqrt")

    def predict_proba(self, X) -> np.ndarray:
        return self._mean(X)

    def predict(self, X):
        return self.classes_[self.predict_proba(X).argmax(1)]


class RandomForestRegressor(_Forest):
    DEFAULTS = dict(_Forest.DEFAULTS, max_features=1.0)

    def predict(self, X) -> np.ndarray:
        return self._mean(X)[:, 0]


def _safe_divide(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return torch.where(den.abs() < 1e-150, 0.0, num / torch.where(den == 0, 1.0, den))


class _Boosting(_Torch):
    DEFAULTS = dict(n_estimators=100, learning_rate=0.1, max_depth=3, min_samples_split=2,
                    min_samples_leaf=1, subsample=1.0, random_state=None, device="auto")

    def __init__(self, **params):
        super().__init__(**{**self.DEFAULTS, **params})
        if self.params["subsample"] != 1.0:
            raise ValueError("only subsample=1.0 is supported")

    def _init(self, codes, n_classes, rows) -> np.ndarray:
        """The initial raw scores of a booster fitted on ``rows``."""
        if not self.classifier:
            return np.array([codes[rows].mean()])
        eps = np.finfo(np.float64).eps
        prior = np.clip(np.bincount(codes[rows], minlength=n_classes) / len(rows), eps, 1 - eps)
        if n_classes == 2:
            return np.log(prior[1:] / (1 - prior[1:]))
        return np.log(prior) - np.log(prior).mean()

    def _boost(self, X, target, n_classes, groups, stages: int, checkpoints=()):
        """Fit one booster per group (training rows, max_depth, learning
        rate) side by side, K = the outputs' trees per group and stage;
        returns the stages' trees and {checkpoint: raw scores of every row of
        X (G, n, K)}."""
        p = self.params
        Xd = self._x(X)
        dev = Xd.device
        order = presort(Xd)
        G, n = len(groups), len(target)
        K = 1 if n_classes <= 2 else n_classes
        if self.classifier:
            yt = torch.as_tensor(np.eye(n_classes)[target][:, -K:], device=dev).unsqueeze(0)
        else:
            yt = torch.as_tensor(target, device=dev).view(1, n, 1)
        w = np.zeros((G, n))
        for g, (rows, _, _) in enumerate(groups):
            w[g, rows] = 1.0
        w = torch.as_tensor(np.repeat(w, K, axis=0), device=dev)  # (G * K, n)
        lr = torch.as_tensor([g[2] for g in groups], dtype=torch.float64, device=dev)
        lr = lr.view(G, 1, 1)
        depths = [g[1] for g in groups for _ in range(K)]
        init = np.stack([self._init(target, n_classes, rows) for rows, _, _ in groups])
        raw = torch.as_tensor(init, device=dev).view(G, 1, K).repeat(1, n, 1)
        trees, out = [], {}
        for stage in range(1, stages + 1):
            if self.classifier:
                prob = torch.sigmoid(raw) if K == 1 else torch.softmax(raw, dim=-1)
                neg_g = yt - prob
            else:
                neg_g = yt - raw
            targets = neg_g.permute(0, 2, 1).reshape(G * K, n)
            levels, leaf = grow(Xd, order, targets, w, max_depth=depths,
                                min_samples_split=p["min_samples_split"],
                                min_samples_leaf=p["min_samples_leaf"])
            if self.classifier:  # one Newton step per leaf
                sizes = [lv.feature.shape[1] for lv in levels]
                total = sum(sizes)
                cell = torch.where(leaf < 0, total, leaf)  # rows out of the fit
                prob_t = (yt.expand(G, n, K).permute(0, 2, 1).reshape(G * K, n) - targets)
                num = torch.zeros((G * K, total + 1), dtype=torch.float64, device=dev)
                den = torch.zeros_like(num)
                num.scatter_add_(1, cell, targets)
                den.scatter_add_(1, cell, prob_t * (1 - prob_t))
                value = _safe_divide(num, den)[:, :total]  # the counts cancel
                if K > 2:
                    value = value * ((K - 1) / K)
                for lv, part in zip(levels, torch.split(value, sizes, dim=1)):
                    lv.value = torch.where((lv.feature < 0).unsqueeze(-1),
                                           part.unsqueeze(-1), lv.value)
            step = predict(levels, Xd)[..., 0].view(G, K, n).permute(0, 2, 1)
            raw = raw + lr * step
            if stage in checkpoints:
                out[stage] = raw.clone()
            trees.append(levels)
        return init, trees, out

    def fit(self, X, y):
        p = self.params
        target, n_classes = self._codes(y)
        self.n_classes_ = n_classes
        self.init_, self.trees_, _ = self._boost(
            X, target, n_classes, [(np.arange(len(target)), p["max_depth"], p["learning_rate"])],
            p["n_estimators"])
        return self

    def _raw(self, X) -> torch.Tensor:
        Xd = self._x(X)
        raw = torch.as_tensor(self.init_[0], device=Xd.device).view(1, -1).repeat(len(Xd), 1)
        lr = self.params["learning_rate"]
        for levels in self.trees_:
            raw = raw + lr * predict(levels, Xd)[..., 0].t()
        return raw

    @staticmethod
    def _codes_of(raw: torch.Tensor) -> torch.Tensor:
        return (raw[..., 0] > 0).long() if raw.shape[-1] == 1 else raw.argmax(-1)

    def grid_scores(self, X, y, splits, candidates: List[dict]) -> Optional[np.ndarray]:
        target, n_classes = self._codes(y)
        if self.classifier and any(len(np.unique(target[tr])) < n_classes for tr, _ in splits):
            return None  # a fold without a class fits fewer outputs: fit it alone
        keys = sorted({(self._param(c, "max_depth"), self._param(c, "learning_rate"))
                       for c in candidates}, key=str)
        groups = [(tr, d, lr) for tr, _ in splits for d, lr in keys]
        ns = {self._param(c, "n_estimators") for c in candidates}
        _, _, raws = self._boost(X, target, n_classes, groups, max(ns), ns)

        def out(c, k):
            cand = candidates[c]
            g = k * len(keys) + keys.index((self._param(cand, "max_depth"),
                                            self._param(cand, "learning_rate")))
            raw = raws[self._param(cand, "n_estimators")][g]
            return (self._codes_of(raw) if self.classifier else raw[:, 0]).cpu().numpy()

        return self._scores(np.asarray(y), splits, len(candidates), out)


class GradientBoostingClassifier(_Boosting):
    classifier = True

    def predict_proba(self, X) -> np.ndarray:
        raw = self._raw(X)
        if raw.shape[-1] == 1:
            prob = torch.sigmoid(raw).cpu().numpy()
            return np.concatenate([1 - prob, prob], axis=1)
        return torch.softmax(raw, dim=-1).cpu().numpy()

    def predict(self, X):
        return self.classes_[self._codes_of(self._raw(X)).cpu().numpy()]


class GradientBoostingRegressor(_Boosting):
    def predict(self, X) -> np.ndarray:
        return self._raw(X)[:, 0].cpu().numpy()
