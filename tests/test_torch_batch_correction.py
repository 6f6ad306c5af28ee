"""The port's batch-correction toolkit against
flexynesis_tpu.utils.batch_correction, and the classical screens it uses.

Held: the Sinkhorn plan within 1e-5 relative to its largest entry and the
divergence within 1e-5 relative (float32 in both; logsumexp in another
order); ``optimal_transport_align`` and ``reciprocal_pca_mnn`` within 1e-4;
the correlation loss within 1e-5. ``remove_batch_associated_variables`` is
random in JAX itself (no seed reaches its forest or its mutual-information
jitter), so both packages are held by planted features: every planted
target feature kept, every planted batch feature dropped. The forests'
``feature_importances_`` sum to 1 and rank the planted features first; the
KSG mutual information equals sklearn's with one ``random_state`` within
1e-10."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from flexynesis_torch.utils import batch_correction as pb
from flexynesis_torch.utils.classical import feature_selection as pfs
from flexynesis_torch.utils.classical.ensemble import (
    RandomForestClassifier,
    RandomForestRegressor,
)
from flexynesis_torch.utils.csvio import Table
from flexynesis_tpu.utils import batch_correction as jb
from torch_one_thread import one_torch_thread  # noqa: F401

SINKHORN_RTOL = 1e-5
ALIGN_TOL = 1e-4


def _shifted(seed, n=60, d=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2 * n, d))
    x[n:] = 1.5 * x[n:] + 2.0
    labels = np.array([0] * n + [1] * n)
    return x, labels


def test_sinkhorn_plan_and_divergence():
    rng = np.random.default_rng(0)
    cost = rng.random((30, 40)).astype(np.float32)
    want = np.asarray(jb.sinkhorn_plan(jnp.asarray(cost), eps=0.05, n_iters=200))
    got = pb.sinkhorn_plan(torch.as_tensor(cost), eps=0.05, n_iters=200).numpy()
    np.testing.assert_allclose(got, want, rtol=SINKHORN_RTOL, atol=SINKHORN_RTOL * want.max())
    np.testing.assert_allclose(got.sum(1), 1 / 30, rtol=1e-4)
    x, labels = _shifted(1)
    want = float(jb.compute_transport_cost(x, labels))
    got = pb.compute_transport_cost(x, labels, device="cpu")
    np.testing.assert_allclose(got, want, rtol=SINKHORN_RTOL)
    assert got > pb.compute_transport_cost(x, np.random.default_rng(2).permutation(labels),
                                           device="cpu")


def test_correlation_loss():
    x, labels = _shifted(3)
    np.testing.assert_allclose(pb.compute_correlation_loss(x, labels, device="cpu"),
                               float(jb.compute_correlation_loss(x, labels)), rtol=1e-5)


@pytest.mark.parametrize("standardize", [False, True])
def test_optimal_transport_align(standardize):
    x, labels = _shifted(4)
    df = pd.DataFrame(x, columns=[f"e{i}" for i in range(x.shape[1])])
    want, _ = jb.optimal_transport_align(df, labels, standardize_by_labels=standardize)
    got, got_labels = pb.optimal_transport_align(
        Table([str(i) for i in df.index], list(df.columns), x), labels,
        standardize_by_labels=standardize, device="cpu")
    np.testing.assert_allclose(got.values, want.values, atol=ALIGN_TOL, rtol=ALIGN_TOL)
    np.testing.assert_array_equal(got_labels, labels)
    assert got.columns == list(want.columns)


@pytest.mark.parametrize("standardize", [False, True])
def test_reciprocal_pca_mnn(standardize):
    x, labels = _shifted(5, n=80, d=12)
    df = pd.DataFrame(x)
    want, _ = jb.reciprocal_pca_mnn(df, labels, n_components=4,
                                    standardize_by_labels=standardize)
    got, _ = pb.reciprocal_pca_mnn(Table([str(i) for i in df.index], [str(c) for c in df.columns],
                                         x), labels, n_components=4,
                                   standardize_by_labels=standardize, device="cpu")
    assert got.columns == list(want.columns)
    np.testing.assert_allclose(got.values, want.values, atol=ALIGN_TOL, rtol=ALIGN_TOL)


def _planted(seed, n=160, F=14):
    """Features 0-1 carry the target, 2-3 the batch, the rest noise."""
    rng = np.random.default_rng(seed)
    target = rng.integers(0, 2, n)
    batch = rng.integers(0, 2, n)
    X = rng.normal(size=(n, F))
    X[:, 0] += 3.0 * target
    X[:, 1] -= 3.0 * target
    X[:, 2] += 3.0 * batch
    X[:, 3] -= 3.0 * batch
    return X, target.astype(float), batch.astype(float)


@pytest.mark.parametrize("package", ["jax", "port"])
def test_remove_batch_associated_variables_planted(package):
    X, target, batch = _planted(6)
    target_like_batch = X[:, 2] > 0  # the batch features also predict this target
    cols = [f"f{i}" for i in range(X.shape[1])]
    types = {"y": "categorical", "b": "categorical", "age": "numerical"}
    targets = {"y": target, "age": np.where(target_like_batch, 1.0, 0.0) + X[:, 0]}
    if package == "jax":
        kept = list(jb.remove_batch_associated_variables(
            pd.DataFrame(X, columns=cols), types, targets, {"b": batch}).columns)
    else:
        kept = pb.remove_batch_associated_variables(
            Table([str(i) for i in range(len(X))], cols, X), types, targets, {"b": batch},
            device="cpu").columns
    assert {"f0", "f1"} <= set(kept)
    assert not {"f2", "f3"} & set(kept)
    assert kept == [c for c in cols if c in kept]  # the columns' order


@pytest.mark.parametrize("kind", ["classifier", "regressor"])
def test_forest_importances_rank_planted_features(kind):
    X, target, _ = _planted(7)
    y = target if kind == "classifier" else 2.0 * X[:, 0] - X[:, 1]
    forest = (RandomForestClassifier if kind == "classifier" else RandomForestRegressor)(
        n_estimators=30, random_state=0, device="cpu").fit(X, y)
    imp = forest.feature_importances_
    np.testing.assert_allclose(imp.sum(), 1.0, rtol=1e-12)
    assert set(np.argsort(-imp)[:2]) == {0, 1}
    assert (imp >= 0).all()


def test_forest_importances_match_sklearn_without_subsampling():
    """One CART regressor on unit weights, every feature at every node: the
    importances follow sklearn's formula. Depth 3 keeps each node large
    enough that no two features give the same partition: the port breaks
    such ties by feature index, sklearn by its random feature order (a
    recorded departure of the classical estimators)."""
    from sklearn.tree import DecisionTreeRegressor

    rng = np.random.default_rng(8)
    X = rng.normal(size=(80, 5))
    y = X[:, 0] + 0.5 * X[:, 1] ** 2 + 0.1 * rng.normal(size=80)
    from flexynesis_torch.utils.classical import tree

    Xt = torch.as_tensor(X, dtype=torch.float32)
    levels, _ = tree.grow(Xt, tree.presort(Xt), torch.as_tensor(y[None, :]),
                          torch.ones((1, 80), dtype=torch.float64), max_depth=3)
    got = tree.feature_importances(levels, 5).numpy()[0]
    want = DecisionTreeRegressor(max_depth=3, random_state=0).fit(
        X.astype(np.float32), y).feature_importances_
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("kind", ["classif", "regression"])
def test_mutual_info_equals_sklearn(kind):
    from sklearn import feature_selection as skfs

    X, target, _ = _planted(9, n=120, F=6)
    y = target if kind == "classif" else X[:, 0] + 0.3 * np.random.default_rng(1).normal(size=120)
    want = getattr(skfs, f"mutual_info_{kind}")(X, y, random_state=3)
    got = getattr(pfs, f"mutual_info_{kind}")(X, y, random_state=3, device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    assert set(np.argsort(-got)[:1]) <= {0, 1}


def test_select_from_model_rule():
    from sklearn.ensemble import RandomForestClassifier as SkForest
    from sklearn.feature_selection import SelectFromModel

    X, target, _ = _planted(10, n=80)
    sk = SkForest(n_estimators=10, random_state=0).fit(X, target)
    np.testing.assert_array_equal(pfs.select_from_model(sk.feature_importances_),
                                  SelectFromModel(sk, prefit=True).get_support())


def test_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    x, labels = _shifted(0, n=10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pb.compute_transport_cost(x, labels)
