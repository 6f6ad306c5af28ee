"""The port's numpy/scipy metrics against flexynesis_tpu.utils.metrics (which
uses sklearn) on seeded binary, multiclass, regression and survival inputs,
including labels of -1 and NaN. Tolerance: rtol=1e-10, atol=1e-12 (both
sides compute in float64; only summation order differs)."""

import warnings
import zlib

import numpy as np
import pytest

from flexynesis_tpu.utils import metrics as ref
from flexynesis_torch.data.dataset import MultiOmicDataset
from flexynesis_torch.utils import metrics


def assert_same(ours, theirs):
    assert ours.keys() == theirs.keys()
    for k in ours:
        if theirs[k] is None:
            assert ours[k] is None, k
        else:
            np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-10, atol=1e-12,
                                       err_msg=k)


def _probs(rng, n, k, tie=False):
    logits = rng.normal(size=(n, k))
    if tie:
        logits = np.round(logits, 1)
    p = np.exp(logits)
    return p / p.sum(axis=1, keepdims=True)


@pytest.mark.parametrize("case", [
    "binary", "binary_one_class", "multiclass3", "multiclass4",
    "multiclass_missing_class", "ties", "all_one_class",
])
def test_evaluate_classifier(case):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    n = 60
    if case == "binary":
        y, p = rng.integers(0, 2, n), _probs(rng, n, 2)
    elif case == "binary_one_class":
        y, p = np.ones(n), _probs(rng, n, 2)
    elif case == "multiclass3":
        y, p = rng.integers(0, 3, n), _probs(rng, n, 3)
    elif case == "multiclass4":
        y, p = rng.integers(0, 4, n), _probs(rng, n, 4)
    elif case == "multiclass_missing_class":
        y, p = rng.integers(0, 3, n), _probs(rng, n, 4)
    elif case == "ties":
        y, p = rng.integers(0, 3, n), _probs(rng, n, 3, tie=True)
    else:
        y, p = np.zeros(n), np.tile([0.9, 0.05, 0.05], (n, 1))
    y = y.astype(np.float64)
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore")
        theirs = ref.evaluate_classifier(y, p)
        ours = metrics.evaluate_classifier(y, p)
    assert_same(ours, theirs)


def test_evaluate_regressor_and_survival():
    rng = np.random.default_rng(7)
    y = rng.normal(size=50)
    pred = y + rng.normal(0, 0.5, 50)
    assert_same(metrics.evaluate_regressor(y, pred), ref.evaluate_regressor(y, pred))

    t = rng.exponential(10, 80).round(0)  # rounded: tied times
    e = (rng.random(80) < 0.6).astype(float)
    risk = np.round(rng.normal(size=80), 1)  # tied scores
    t[3], e[5] = np.nan, np.nan
    assert_same(metrics.evaluate_survival(risk, t, e), ref.evaluate_survival(risk, t, e))


def _dataset(rng, n=40):
    sub = rng.integers(0, 3, n).astype(np.float32)
    sub[:4] = -1  # unknown / missing level
    age = rng.normal(50, 5, n).astype(np.float32)
    age[4:7] = np.nan
    time = rng.exponential(10, n).astype(np.float32)
    event = (rng.random(n) < 0.7).astype(np.float32)
    return MultiOmicDataset(
        dat={"gex": np.zeros((n, 2), np.float32)},
        ann={"subtype": sub, "age": age, "OS_MONTHS": time, "OS_STATUS": event},
        variable_types={"subtype": "categorical", "age": "numerical",
                        "OS_MONTHS": "numerical", "OS_STATUS": "numerical"},
        features={"gex": ["a", "b"]},
        samples=[f"S{i}" for i in range(n)],
        label_mappings={"subtype": {0: "grp0", 1: "grp1", 2: float("nan"), -1: "Unknown"}},
    )


def test_wrapper_and_predicted_labels_rows():
    rng = np.random.default_rng(3)
    ds = _dataset(rng)
    preds = {
        "subtype": _probs(rng, 40, 3).astype(np.float32),
        "age": rng.normal(50, 5, (40, 1)).astype(np.float32),
        "OS_STATUS": rng.normal(size=(40, 1)).astype(np.float32),
        "unlabeled": _probs(rng, 40, 2).astype(np.float32),
    }
    ours = metrics.evaluate_wrapper("DirectPred", preds, ds, "OS_STATUS", "OS_MONTHS")
    theirs = ref.evaluate_wrapper("DirectPred", preds, ds, "OS_STATUS", "OS_MONTHS")
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs.to_dict("records")):
        assert {k: a[k] for k in a if k != "value"} == {k: b[k] for k in b if k != "value"}
        if b["value"] is None:
            assert a["value"] is None
        else:
            np.testing.assert_allclose(a["value"], b["value"], rtol=1e-10, atol=1e-12)

    ours = metrics.get_predicted_labels(preds, ds, "test", "DirectPred")
    theirs = ref.get_predicted_labels(preds, ds, "test", "DirectPred").to_dict("records")
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(b[k], float) and np.isnan(b[k]):
                assert isinstance(a[k], float) and np.isnan(a[k]), k
            else:
                assert a[k] == b[k], k
