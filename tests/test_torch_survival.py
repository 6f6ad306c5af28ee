"""The port's survival toolkit against flexynesis_tpu.utils.survival.

Tolerances: the host-numpy steps (Kaplan-Meier, log-rank, cut-offs,
recursive splits, time-dependent AUC) run the same arithmetic as JAX, so
within 1e-10 relative, or equal (cut-offs, groups). ``CoxPH`` runs in
float64 in the port (lifelines' dtype); against JAX's fit inside
``jax.enable_x64`` every fitted quantity is within 1e-6 relative, against
JAX's default float32 fit the coefficients are within 1e-3 (the dtype gap).
``build_cox_model``'s folds and dropped features are equal, its C-indices
within 1e-8."""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from flexynesis_torch.utils import survival as ps
from flexynesis_torch.utils.csvio import Table
from flexynesis_tpu.utils import survival as js
from torch_one_thread import one_torch_thread  # noqa: F401

RTOL = 1e-10
COX_RTOL = 1e-6
F32_COEF_RTOL = 1e-3


def _cohort(seed, n=120, p=3, ties=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, p))
    t = rng.exponential(np.exp(-(X[:, 0] - 0.5 * X[:, 1])))
    if ties:
        t = np.ceil(t * 4) / 4
    e = (rng.random(n) < 0.7).astype(float)
    cols = [f"x{i}" for i in range(p)]
    df = pd.DataFrame(X, columns=cols, index=[f"s{i}" for i in range(n)])
    df["time"], df["event"] = t, e
    return df


def _table(df) -> Table:
    return Table(list(df.index), list(df.columns), df.to_numpy(dtype=float))


@pytest.mark.parametrize("seed", [0, 1])
def test_kaplan_meier_and_logrank(seed):
    df = _cohort(seed, ties=True)
    t, e = df["time"].values, df["event"].values
    kj, kp = js.KaplanMeier().fit(t, e), ps.KaplanMeier().fit(t, e)
    np.testing.assert_array_equal(kp.timeline, kj.timeline)
    np.testing.assert_allclose(kp.survival, kj.survival, rtol=RTOL)
    grid = np.linspace(0, t.max() * 1.1, 37)
    np.testing.assert_allclose(kp.survival_at(grid), kj.survival_at(grid), rtol=RTOL)
    g = df["x0"].values > 0
    rj = js.logrank_test(t[g], t[~g], e[g], e[~g])
    rp = ps.logrank_test(t[g], t[~g], e[g], e[~g])
    np.testing.assert_allclose([rp.test_statistic, rp.p_value],
                               [rj.test_statistic, rj.p_value], rtol=RTOL)
    groups = np.array(["a", "b", "c"], dtype=object)[np.digitize(df["x1"].values, [-0.4, 0.4])]
    groups[3] = np.nan
    mj = js.multivariate_logrank_test(t, groups, e)
    mp = ps.multivariate_logrank_test(t, groups, e)
    np.testing.assert_allclose([mp.test_statistic, mp.p_value],
                               [mj.test_statistic, mj.p_value], rtol=RTOL)


@pytest.mark.parametrize("seed", [2, 3])
def test_cutoffs_and_recursive_split(seed):
    df = _cohort(seed, n=200, ties=True)
    score = df["x0"].values.copy()
    score[:40] = np.round(score[:40], 1)  # repeated quantiles
    cj = js.find_optimal_cutoff(score, df["time"], df["event"])
    cp = ps.find_optimal_cutoff(score, df["time"].values, df["event"].values)
    assert cp[0] == cj[0]
    np.testing.assert_allclose(cp[1], cj[1], rtol=RTOL)
    np.testing.assert_array_equal(ps.split_by_median(score), js.split_by_median(score))

    df = df.assign(pred_risk=score)
    want = js.recursive_binary_split_minN(df, "pred_risk", "time", "event",
                                          min_samples_per_group=20)
    got = ps.recursive_binary_split_minN(_table(df), "pred_risk", "time", "event",
                                         min_samples_per_group=20)
    assert got.columns == list(want.columns)
    assert list(got.column("auto_group")) == list(want["auto_group"])
    assert want["auto_group"].nunique() > 1


@pytest.mark.parametrize("times", [[0.5], [0.3, 0.7, 1.2]])
def test_cumulative_dynamic_auc(times):
    tr, te = _cohort(4), _cohort(5, n=90)
    risk = np.exp(te["x0"].values)
    aj, mj = js.cumulative_dynamic_auc(tr["time"], tr["event"], te["time"], te["event"],
                                       risk, times)
    ap, mp = ps.cumulative_dynamic_auc(tr["time"].values, tr["event"].values,
                                       te["time"].values, te["event"].values, risk, times)
    np.testing.assert_allclose(ap, aj, rtol=RTOL)
    np.testing.assert_allclose(mp, mj, rtol=RTOL)


def _jax_cox_x64(df, **kw):
    with jax.enable_x64(True):
        return js.CoxPH(**kw).fit(df, "time", "event")


@pytest.mark.parametrize("seed,penalizer,ties", [(6, 0.0, False), (7, 0.05, True)])
def test_coxph_matches_jax_x64(seed, penalizer, ties):
    df = _cohort(seed, ties=ties)
    df["x2"] *= 50.0  # unequal scales: the standardisation matters
    want = _jax_cox_x64(df, penalizer=penalizer)
    got = ps.CoxPH(penalizer=penalizer, device="cpu").fit(_table(df), "time", "event")
    assert got.features_ == want.features_
    np.testing.assert_allclose(got.params_, want.params_.values, rtol=COX_RTOL)
    np.testing.assert_allclose(got.standard_errors_, want.standard_errors_.values,
                               rtol=COX_RTOL)
    assert got.summary.columns == list(want.summary.columns)
    assert got.summary.index == list(want.summary.index)
    np.testing.assert_allclose(got.summary.values, want.summary.values, rtol=COX_RTOL)
    new = _cohort(seed + 100, n=30)
    new["x2"] *= 50.0
    np.testing.assert_allclose(got.predict_partial_hazard(_table(new)),
                               want.predict_partial_hazard(new).values, rtol=COX_RTOL)
    grid = np.linspace(0, df["time"].max(), 25)
    np.testing.assert_allclose(got.baseline_cumulative_hazard_at(grid),
                               want.baseline_cumulative_hazard_at(grid), rtol=COX_RTOL)
    sf_got = got.predict_survival_function(_table(new), grid)
    sf_want = want.predict_survival_function(new, grid)
    assert sf_got.columns == list(sf_want.columns)
    np.testing.assert_allclose(sf_got.values, sf_want.values, rtol=COX_RTOL)


def test_coxph_against_jax_float32_states_the_dtype_gap():
    df = _cohort(8)
    want = js.CoxPH().fit(df, "time", "event")  # JAX's default dtype: float32
    got = ps.CoxPH(device="cpu").fit(_table(df), "time", "event")
    np.testing.assert_allclose(got.params_, want.params_.values, rtol=F32_COEF_RTOL)


def test_breslow_nll_matches_exact_formula():
    """The oracle of tests/test_survival_utils.py, on the port: each of the
    three events at t=5 sees the full 5-row risk set."""
    t = np.array([5.0, 5.0, 5.0, 8.0, 10.0])
    e = np.array([1.0, 1.0, 1.0, 0.0, 1.0])
    x = np.array([[1.0], [0.0], [2.0], [1.0], [0.0]])
    beta = np.array([0.3])
    r = np.exp(x[:, 0] * beta[0])
    ll = (x[0, 0] + x[1, 0] + x[2, 0]) * beta[0] - 3 * np.log(r.sum()) \
        + x[4, 0] * beta[0] - np.log(r[4])
    nll = float(ps.CoxPH()._neg_log_partial_likelihood(
        *(torch.as_tensor(a, dtype=torch.float64) for a in (beta, x, t, e))))
    np.testing.assert_allclose(nll, -ll, rtol=1e-12)
    with jax.enable_x64(True):
        nll_jax = float(js.CoxPH()._neg_log_partial_likelihood(
            *(jnp.asarray(a) for a in (beta, x, t, e))))
    np.testing.assert_allclose(nll, nll_jax, rtol=1e-12)


def test_fit_is_row_order_invariant_under_ties():
    rng = np.random.default_rng(0)
    n = 60
    df = pd.DataFrame({"x": rng.normal(size=n), "t": rng.integers(1, 8, size=n).astype(float),
                       "e": rng.integers(0, 2, size=n).astype(float)})
    c1 = ps.CoxPH(device="cpu").fit(_table(df), "t", "e").params_
    c2 = ps.CoxPH(device="cpu").fit(_table(df.sample(frac=1.0, random_state=7)),
                                    "t", "e").params_
    np.testing.assert_allclose(c1, c2, rtol=1e-10)


def _jax_fold_cindices(df, eval_time):
    """JAX's build_cox_model loop, with its fold C-indices kept."""
    from sklearn.model_selection import KFold

    from flexynesis_tpu.utils.metrics import concordance_index

    out, folds = [], []
    for tr, te in KFold(n_splits=5, shuffle=True, random_state=42).split(df):
        with jax.enable_x64(True):
            m = js.CoxPH(penalizer=0.05).fit(df.iloc[tr], "time", "event")
        risk = m.predict_partial_hazard(df.iloc[te]).values
        out.append(concordance_index(df.iloc[te]["time"].values, -risk,
                                     df.iloc[te]["event"].astype(int).values))
        folds.append(te)
    return out, folds


def test_build_cox_model_matches_jax(capsys):
    df = _cohort(9, n=150, p=4)
    df["const_ish"] = 1.0 + 1e-3 * np.random.default_rng(1).normal(size=len(df))
    eval_time = float(df["time"].median())
    with jax.enable_x64(True):
        jm, jmetrics = js.build_cox_model(df, "time", "event", eval_time=eval_time)
    jax_dropped = capsys.readouterr().out
    pm, pmetrics = ps.build_cox_model(_table(df), "time", "event", eval_time=eval_time,
                                      device="cpu")
    assert capsys.readouterr().out == jax_dropped
    assert "const_ish" in jax_dropped and pm.features_ == jm.features_
    want, jax_folds = _jax_fold_cindices(df.drop(columns=["const_ish"]), eval_time)
    from flexynesis_torch.utils.classical.model_selection import KFold

    port_folds = [te for _, te in KFold(5, shuffle=True, random_state=42).split(df.index)]
    for a, b in zip(port_folds, jax_folds):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(pmetrics["cv_cindex"], want, rtol=1e-8)
    np.testing.assert_allclose(pmetrics["cv_cindex_mean"], jmetrics["cv_cindex_mean"], rtol=1e-8)
    np.testing.assert_allclose(pmetrics["cv_auc_mean"], jmetrics["cv_auc_mean"], rtol=1e-8)
    np.testing.assert_allclose(pm.params_, jm.params_.values, rtol=COX_RTOL)


def test_coxph_card_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ps.CoxPH().fit(_table(_cohort(0, n=20)), "time", "event")
