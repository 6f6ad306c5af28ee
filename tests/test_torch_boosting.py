"""The port's GradientBoostingClassifier (the CLI's categorical "XGBoost"
baseline) against JAX's ``_grids("XGBoost", "categorical")`` estimator,
sklearn's, on the same arrays:

* two and three classes at each grid depth (learning rate 0.1, 100
  stages): the probabilities of the training rows after every stage within
  1e-9 of sklearn's ``staged_predict_proba``. Log-loss residuals take few
  distinct values, so two splits that set apart different rows can gain
  exactly as much; sklearn breaks such a tie by its random feature order,
  the port by the lowest feature index, and from there the two fits follow
  different trees. The test holds every stage up to the first that differs,
  and that stage to a tie: a tree that partitions the training rows
  otherwise than sklearn's, at the same squared-error gain of the stage's
  residuals (rtol 1e-12), with both sides' probabilities those of one
  Newton step from sklearn's previous stage on their own partitions
  (1e-9; the step is checked on sklearn's side first). Readings on these
  data: at depth 3 the fits part at stage 3 (two classes) and stage 4
  (three: a 32-row node of class 0's tree split 1/31 through another row);
  the other cases agree over all 100 stages within 2.3e-16;
* the XGBoost baseline's tables on the ``TestBaselines`` data, with PCA (10
  components; without it the grid takes 40 s on this CPU), within the
  margins of ``test_torch_baselines.py``'s other baselines."""

from dataclasses import replace

import numpy as np
import pytest
import torch

from flexynesis_tpu.utils import baselines as jax_baselines
from flexynesis_torch.utils import baselines
from flexynesis_torch.utils.classical.tree import predict
from test_torch_baselines import _data, check_metrics_near_jax, split  # noqa: F401

STAGES = 100


def _leaf_ids(levels, X):
    """(trees, rows) the node each training row ends in: the levels with each
    node's value replaced by a number of its own."""
    marked = [replace(lv, value=(depth * 1e6 + torch.arange(lv.feature.shape[1],
                                                            dtype=torch.float64))
                      .expand(lv.feature.shape).unsqueeze(-1))
              for depth, lv in enumerate(levels)]
    return predict(marked, torch.as_tensor(X))[..., 0].numpy()


def _gain(leaf, target):
    """The squared-error gain of a partition: sum over leaves of (sum t)^2 / n."""
    return sum(target[leaf == i].sum() ** 2 / np.sum(leaf == i) for i in np.unique(leaf))


def _newton_step(raw, leaves, residual, target, K, lr=0.1):
    """The probabilities after one log-loss stage from the raw scores ``raw``
    (rows, outputs) on the trees' partitions ``leaves`` (outputs, rows):
    each leaf's value sum(r) / sum(p (1 - p)), times (K - 1) / K above two
    classes, with r the residuals and p = target - r."""
    raw = raw.copy()
    for k in range(raw.shape[1]):
        r = residual[:, k]
        p = target[:, k] - r
        for leaf in np.unique(leaves[k]):
            rows = leaves[k] == leaf
            value = r[rows].sum() / (p[rows] * (1 - p[rows])).sum()
            raw[rows, k] += lr * value * ((K - 1) / K if K > 2 else 1.0)
    if K == 2:
        p1 = 1 / (1 + np.exp(-raw[:, 0]))
        return np.stack([1 - p1, p1], 1)
    e = np.exp(raw - raw.max(1, keepdims=True))
    return e / e.sum(1, keepdims=True)


def _same_partition(a, b):
    return len(set(zip(a, b))) == len(set(a)) == len(set(b))


@pytest.mark.parametrize("depth", [3, 6, 9])
@pytest.mark.parametrize("K", [2, 3])
def test_gradient_boosting_classifier_matches_sklearn(K, depth):
    X, yc, _, _ = _data(n=90, F=8, seed=4)
    y = np.minimum(yc, K - 1)
    params = dict(n_estimators=STAGES, max_depth=depth, learning_rate=0.1)
    theirs, _ = jax_baselines._grids("XGBoost", "categorical")
    theirs.set_params(**params).fit(X, y)
    ours, _ = baselines._grids("XGBoost", "categorical", device="cpu")
    ours = ours.clone(**params).fit(X, y)
    trees = ours.trees_
    onehot = np.eye(K)[y]
    prev = np.tile(np.bincount(y) / len(y), (len(y), 1))  # the prior: sklearn's init
    for stage, want in enumerate(theirs.staged_predict_proba(X), 1):
        ours.trees_ = trees[:stage]
        if np.abs(ours.predict_proba(X) - want).max() <= 1e-9:
            prev = want
            continue
        target = onehot[:, -1:] if K == 2 else onehot
        residual = target - (prev[:, -1:] if K == 2 else prev)
        raw = np.asarray(list(theirs.staged_decision_function(X))[stage - 1]).reshape(len(y), -1)
        raw = raw - 0.1 * np.stack([t.predict(X) for t in theirs.estimators_[stage - 1]], 1)
        leaves = _leaf_ids(trees[stage - 1], X)
        tied = 0
        for k in range(residual.shape[1]):
            sk = theirs.estimators_[stage - 1, k].apply(X)
            if not _same_partition(leaves[k], sk):
                np.testing.assert_allclose(_gain(leaves[k], residual[:, k]),
                                           _gain(sk, residual[:, k]), rtol=1e-12)
                tied += 1
        assert tied, f"stage {stage}: the same trees, other probabilities"
        sk_leaves = np.stack([t.apply(X) for t in theirs.estimators_[stage - 1]])
        np.testing.assert_allclose(_newton_step(raw, sk_leaves, residual, target, K), want,
                                   rtol=0, atol=1e-9)
        np.testing.assert_allclose(_newton_step(raw, leaves, residual, target, K),
                                   ours.predict_proba(X), rtol=0, atol=1e-9)
        return
    assert stage == STAGES


@pytest.mark.parametrize("var", ["subtype", "age"])
def test_xgboost_baseline_metrics_near_jax(split, var):  # noqa: F811
    check_metrics_near_jax(split, "XGBoost", var, pca=True)
