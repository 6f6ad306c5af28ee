"""Survival analysis: Kaplan-Meier, log-rank tests, the Cox model, cut-offs.

Counterpart of ``flexynesis_tpu/utils/survival.py`` without pandas,
lifelines or sksurv. Tables come in and go out as ``utils.csvio.Table``
(sample rows, named columns) where the JAX package uses DataFrames.

* ``KaplanMeier``, ``logrank_test``, ``multivariate_logrank_test``,
  ``cumulative_dynamic_auc``, ``split_by_median``, ``find_optimal_cutoff``
  and ``recursive_binary_split_minN`` are sequential host steps in numpy,
  as in JAX.
* ``CoxPH`` fits on the caller's device (the card unless ``device="cpu"``)
  in float64, as lifelines does: Newton with step-halving on the Breslow
  partial likelihood, whose denominator at a tied event time is the full
  risk set; gradient and Hessian from ``torch.func``. (The training loss
  ``ops/losses.cox_ph_loss`` keeps the naive per-row cumsum over ties, as
  in JAX; the two are different functions on purpose.)
* ``build_cox_model``: the low-variance filter, the K-fold CV C-index over
  ``classical.KFold`` (sklearn's folds) and the horizon AUC.
"""

from __future__ import annotations

import warnings
from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch
from scipy import stats as scipy_stats

from .csvio import Table
from .device import resolve_device

# ------------------------------------------------------------ Kaplan-Meier


class KaplanMeier:
    """Product-limit survival estimator."""

    def __init__(self):
        self.timeline = None
        self.survival = None

    def fit(self, durations, events=None):
        durations = np.asarray(durations, dtype=float)
        events = (np.ones_like(durations) if events is None
                  else np.asarray(events, dtype=float))
        order = np.argsort(durations)
        t, e = durations[order], events[order]
        uniq = np.unique(t[e == 1]) if (e == 1).any() else np.array([])
        surv = []
        s = 1.0
        for ti in uniq:
            d = np.sum((t == ti) & (e == 1))
            at_risk = np.sum(t >= ti)
            s *= 1.0 - d / at_risk
            surv.append(s)
        self.timeline = uniq
        self.survival = np.asarray(surv)
        return self

    def survival_at(self, times):
        """S(t) evaluated with right-continuous steps."""
        if self.timeline is None or len(self.timeline) == 0:
            return np.ones_like(np.asarray(times, dtype=float))
        idx = np.searchsorted(self.timeline, np.asarray(times, float), side="right")
        s = np.concatenate([[1.0], self.survival])
        return s[idx]


class LogRankResult:
    def __init__(self, statistic: float, p_value: float):
        self.test_statistic = statistic
        self.p_value = p_value


def logrank_test(t1, t2, e1, e2, alpha: float = 0.95) -> LogRankResult:
    """Two-group log-rank test (chi-square, 1 df)."""
    t1, t2 = np.asarray(t1, float), np.asarray(t2, float)
    e1, e2 = np.asarray(e1, float), np.asarray(e2, float)
    t = np.concatenate([t1, t2])
    e = np.concatenate([e1, e2])
    g = np.concatenate([np.zeros(len(t1)), np.ones(len(t2))])
    O1 = E1 = V = 0.0
    for ti in np.unique(t[e == 1]):
        at_risk = t >= ti
        n = at_risk.sum()
        n1 = (at_risk & (g == 0)).sum()
        d = ((t == ti) & (e == 1)).sum()
        d1 = ((t == ti) & (e == 1) & (g == 0)).sum()
        O1 += d1
        E1 += d * n1 / n
        if n > 1:
            V += d * (n1 / n) * (1 - n1 / n) * (n - d) / (n - 1)
    stat = (O1 - E1) ** 2 / V if V > 0 else 0.0
    return LogRankResult(float(stat), float(scipy_stats.chi2.sf(stat, df=1)))


def _is_nan(value) -> bool:
    return isinstance(value, float) and np.isnan(value)


def unique_labels(values) -> list:
    """The distinct labels in first-seen order, NaN left out (``pd.unique``)."""
    return [v for v in dict.fromkeys(np.asarray(values).tolist()) if not _is_nan(v)]


def multivariate_logrank_test(durations, groups, events) -> LogRankResult:
    """K-group log-rank test (chi-square, K-1 df): the quadratic form
    Z' V^-1 Z over the hypergeometric covariance of (O - E), as
    lifelines.statistics.multivariate_logrank_test computes it."""
    t = np.asarray(durations, float)
    e = np.asarray(events, float)
    g = np.asarray(groups)
    labels = unique_labels(g)
    K = len(labels)
    if K < 2:
        return LogRankResult(0.0, 1.0)
    O = np.zeros(K)
    E = np.zeros(K)
    V = np.zeros((K, K))
    for ti in np.unique(t[e == 1]):
        at_risk = t >= ti
        n = at_risk.sum()
        d = ((t == ti) & (e == 1)).sum()
        nk = np.array([(at_risk & (g == lb)).sum() for lb in labels], float)
        dk = np.array([((t == ti) & (e == 1) & (g == lb)).sum() for lb in labels], float)
        O += dk
        E += d * nk / n
        if n > 1:
            frac = nk / n
            V += d * (n - d) / (n - 1) * (np.diag(frac) - np.outer(frac, frac))
    z = (O - E)[:-1]
    Vsub = V[:-1, :-1]
    try:
        stat = float(z @ np.linalg.solve(Vsub, z))
    except np.linalg.LinAlgError:
        stat = float(z @ np.linalg.pinv(Vsub) @ z)
    stat = max(stat, 0.0)
    return LogRankResult(stat, float(scipy_stats.chi2.sf(stat, df=K - 1)))


# ------------------------------------------------------------------ Cox PH

SUMMARY_COLUMNS = ["coef", "exp(coef)", "se(coef)", "coef lower 95%", "coef upper 95%",
                   "exp(coef) lower 95%", "exp(coef) upper 95%", "z", "p"]


def breslow_ties(t: torch.Tensor):
    """(order, group_end) of the descending-time sort (stable): each sorted
    row's tie group ends at ``group_end``, so the cumulative sum there is the
    full risk set {j : t_j >= t_i}."""
    order = torch.argsort(-t, stable=True)
    a = -t[order]  # ascending view of the descending-time sort
    return order, torch.searchsorted(a, a, right=True) - 1


class CoxPH:
    """Cox proportional hazards via Newton-Raphson (Breslow ties) + L2, in
    float64 on ``device``.

    ``fit(table, duration_col, event_col)`` takes a ``Table`` whose other
    columns are the covariates; ``params_``, ``standard_errors_`` and
    ``hazard_ratios_`` are arrays over ``features_``, ``summary`` a Table
    with lifelines' nine columns."""

    def __init__(self, penalizer: float = 0.0, max_iter: int = 100, tol: float = 1e-7,
                 device="auto"):
        self.penalizer = penalizer
        self.max_iter = max_iter
        self.tol = tol
        self.device = device

    def _neg_log_partial_likelihood(self, beta, X, t, e, ties=None):
        order, grp_end = breslow_ties(t) if ties is None else ties
        risk_s = (X @ beta)[order]
        e_s = e[order]
        m = torch.max(risk_s)
        csum = torch.cumsum(torch.exp(risk_s - m), 0)
        log_cum = torch.log(csum[grp_end]) + m
        ll = torch.sum(e_s * (risk_s - log_cum))
        return -ll + 0.5 * self.penalizer * torch.sum(beta ** 2) * X.shape[0]

    def fit(self, table: Table, duration_col: str, event_col: str):
        dev = resolve_device(self.device)
        feats = [c for c in table.columns if c not in (duration_col, event_col)]
        X_raw = np.column_stack([table.column(c) for c in feats]).astype(np.float64)
        self._norm_mean = X_raw.mean(axis=0)
        std = X_raw.std(axis=0, ddof=1)
        self._norm_std = np.where(std == 0, 1.0, std)
        Xn = (X_raw - self._norm_mean) / self._norm_std
        X = torch.as_tensor(Xn, dtype=torch.float64, device=dev)
        t = torch.as_tensor(table.column(duration_col).astype(np.float64), device=dev)
        e = torch.as_tensor(table.column(event_col).astype(np.float64), device=dev)
        ties = breslow_ties(t)

        def f(b):
            return self._neg_log_partial_likelihood(b, X, t, e, ties)

        grad = torch.func.grad(f)
        hess = torch.func.hessian(f)
        eye = torch.eye(len(feats), dtype=torch.float64, device=dev)

        # Newton with step-halving (lifelines-style): a full step can
        # overshoot under monotone likelihood or collinearity; halve until the
        # NLL improves, warn and stop if it never does
        beta = torch.zeros(len(feats), dtype=torch.float64, device=dev)
        nll = float(f(beta))
        converged = False
        accepted = True
        for _ in range(self.max_iter):
            step = torch.linalg.solve(hess(beta) + 1e-9 * eye, grad(beta))
            accepted = False
            scale = 1.0
            slack = 1e-6 * (1.0 + abs(nll))
            for _h in range(8):
                cand = beta - scale * step
                nll_c = float(f(cand))
                if np.isfinite(nll_c) and nll_c <= nll + slack:
                    accepted = True
                    break
                scale *= 0.5
            if not accepted:
                if float(torch.max(torch.abs(step))) < 10 * self.tol:
                    converged = True  # the step is negligible: at the optimum
                else:
                    warnings.warn(
                        "CoxPH Newton step failed to improve the likelihood "
                        "(possible monotone likelihood or collinearity); "
                        "stopping at the last stable iterate."
                    )
                break
            delta = float(torch.max(torch.abs(cand - beta)))
            beta, nll = cand, nll_c
            if delta < self.tol:
                converged = True
                break
        if not converged and accepted:
            warnings.warn(f"CoxPH did not converge in {self.max_iter} iterations.")

        H = hess(beta).cpu().numpy()
        cov = np.linalg.inv(H + 1e-9 * np.eye(len(feats)))
        coef = beta.cpu().numpy() / self._norm_std  # on the covariates' own scale
        se = np.sqrt(np.maximum(np.diag(cov), 0)) / self._norm_std

        self.features_ = feats
        self.duration_col = duration_col
        self.event_col = event_col
        self.params_ = coef
        self.standard_errors_ = se
        self.hazard_ratios_ = np.exp(coef)
        z = np.divide(coef, se, out=np.zeros_like(coef), where=se > 0)
        p = 2 * scipy_stats.norm.sf(np.abs(z))
        ci = 1.959963984540054
        self.summary = Table(list(feats), list(SUMMARY_COLUMNS), np.column_stack([
            coef, np.exp(coef), se, coef - ci * se, coef + ci * se,
            np.exp(coef - ci * se), np.exp(coef + ci * se), z, p]))
        self._fit_baseline(table)
        return self

    def predict_partial_hazard(self, table: Table) -> np.ndarray:
        """exp((X - mean) @ params_): exp(X @ coef) up to a constant factor,
        as lifelines reports it."""
        X = np.column_stack([table.column(c) for c in self.features_]).astype(np.float64)
        return np.exp((X - self._norm_mean) @ self.params_)

    def _fit_baseline(self, table: Table) -> None:
        """Breslow baseline cumulative hazard H0(t) at the mean covariates."""
        t = table.column(self.duration_col).astype(np.float64)
        e = table.column(self.event_col).astype(np.float64)
        risk = self.predict_partial_hazard(table)
        order = np.argsort(t)
        t_s, e_s, r_s = t[order], e[order], risk[order]
        rev_cumsum = np.cumsum(r_s[::-1])[::-1]
        event_times = np.unique(t_s[e_s == 1])
        H = []
        h = 0.0
        for ti in event_times:
            d = np.sum((t_s == ti) & (e_s == 1))
            at_risk = rev_cumsum[np.searchsorted(t_s, ti, side="left")]
            h += d / max(at_risk, 1e-12)
            H.append(h)
        self._baseline_times = event_times
        self._baseline_cumhaz = np.asarray(H)

    def baseline_cumulative_hazard_at(self, times) -> np.ndarray:
        if not hasattr(self, "_baseline_times"):
            raise RuntimeError("Call fit() first.")
        idx = np.searchsorted(self._baseline_times, np.asarray(times, float), side="right")
        return np.concatenate([[0.0], self._baseline_cumhaz])[idx]

    def predict_survival_function(self, table: Table, times=None) -> Table:
        """S(t | x) = exp(-H0(t) exp(lp(x))), Breslow: a (times x samples)
        Table, lifelines' orientation."""
        if times is None:
            times = self._baseline_times
        H0 = self.baseline_cumulative_hazard_at(times)
        surv = np.exp(-np.outer(H0, self.predict_partial_hazard(table)))
        return Table(list(np.asarray(times, float)), list(table.index), surv)


# lifelines-compatible alias used in notebooks
CoxPHFitter = CoxPH


# -------------------------------------------------- time-dependent AUC


def cumulative_dynamic_auc(train_durations, train_events, test_durations, test_events,
                           risk, times):
    """IPCW cumulative/dynamic AUC(t), as sksurv.metrics.cumulative_dynamic_auc.

    Returns (auc_per_time, mean_auc): the AUC(t) curve integrated against the
    Kaplan-Meier estimate of the test survival function, normalised by
    1 - S(times[-1]); NaN horizons (no cases or no controls) are left out
    with their weights renormalised."""
    km_cens = KaplanMeier().fit(np.asarray(train_durations, float),
                                1.0 - np.asarray(train_events, float))
    t = np.asarray(test_durations, float)
    e = np.asarray(test_events, float)
    r = np.asarray(risk, float)
    aucs = []
    for tau in np.atleast_1d(times):
        is_case = (t <= tau) & (e == 1)
        is_ctrl = t > tau
        if is_case.sum() == 0 or is_ctrl.sum() == 0:
            aucs.append(np.nan)
            continue
        G = km_cens.survival_at(np.minimum(t, tau))
        w = np.where(is_case, 1.0 / np.maximum(G, 1e-12), 0.0)
        num = 0.0
        for i in np.where(is_case)[0]:
            gt = (r[i] > r[is_ctrl]).sum() + 0.5 * (r[i] == r[is_ctrl]).sum()
            num += w[i] * gt
        den = w[is_case].sum() * is_ctrl.sum()
        aucs.append(num / den if den > 0 else np.nan)
    aucs = np.asarray(aucs)

    times_arr = np.atleast_1d(np.asarray(times, float))
    if len(times_arr) == 1:
        return aucs, float(aucs[0])
    s_times = KaplanMeier().fit(t, e).survival_at(times_arr)
    d = -np.diff(np.concatenate([[1.0], s_times]))
    finite = np.isfinite(aucs)
    wsum = d[finite].sum()
    mean_auc = float(np.sum(aucs[finite] * d[finite]) / wsum) if wsum > 0 else float("nan")
    return aucs, mean_auc


# ---------------------------------------------------- cutoffs / stratification


def split_by_median(v):
    """Binary split of a vector by its median."""
    v = np.asarray(v, dtype=float)
    return (v > np.nanmedian(v)).astype(float)


def find_optimal_cutoff(expression, time, event, min_percent=0.1, max_percent=0.9,
                        step=0.01) -> Tuple[Optional[float], float]:
    """Best expression cut-off by log-rank p-value over a quantile grid: the
    linear quantiles of the non-NaN values, distinct values in first-seen
    order (pandas' ``quantile(...).unique()``)."""
    expression = np.asarray(expression, float)
    time = np.asarray(time, float)
    event = np.asarray(event, float)
    quantiles = np.arange(min_percent, max_percent, step)
    cutoffs = list(dict.fromkeys(np.quantile(expression[~np.isnan(expression)], quantiles)))
    best_p, best_cutoff = 1.0, None
    for cutoff in cutoffs:
        group = expression > cutoff
        if group.all() or (~group).all():
            continue
        res = logrank_test(time[group], time[~group], event[group], event[~group])
        if res.p_value < best_p:
            best_p, best_cutoff = res.p_value, float(cutoff)
    return best_cutoff, best_p


def recursive_binary_split_minN(table: Table, score: str = "pred_risk", time: str = "OS.time",
                                event: str = "OS", alpha: float = 0.05,
                                min_samples_per_group: int = 25) -> Table:
    """Recursive risk stratification into G1..Gk by optimal log-rank
    cut-offs: the table with an ``auto_group`` column (values as objects),
    G1 the group of lowest mean score among its early (time <= median)
    samples."""
    s_all = table.column(score).astype(float)
    t_all = table.column(time).astype(float)
    e_all = table.column(event).astype(float)
    groups = np.zeros(len(table.index), dtype=int)
    next_gid = 0
    queue = deque([np.arange(len(table.index))])
    while queue:
        node = queue.popleft()
        if len(node) < 2 * min_samples_per_group:
            groups[node] = next_gid
            next_gid += 1
            continue
        try:
            cutoff, pval = find_optimal_cutoff(s_all[node], t_all[node], e_all[node])
        except Exception:
            cutoff, pval = None, 1.0
        if cutoff is None or pval >= alpha:
            groups[node] = next_gid
            next_gid += 1
            continue
        left = node[s_all[node] <= cutoff]
        right = node[s_all[node] > cutoff]
        if len(left) < min_samples_per_group or len(right) < min_samples_per_group:
            groups[node] = next_gid
            next_gid += 1
            continue
        queue.append(left)
        queue.append(right)

    early = t_all <= np.nanmedian(t_all)
    risk_by_gid = {}
    for g in sorted(np.unique(groups)):
        in_g = groups == g
        sel = in_g & early if (in_g & early).any() else in_g
        risk_by_gid[g] = float(np.nanmean(s_all[sel]))
    ordered = sorted(risk_by_gid, key=lambda x: (risk_by_gid[x], x))
    names = {old: f"G{i + 1}" for i, old in enumerate(ordered)}
    values = np.empty((len(table.index), len(table.columns) + 1), dtype=object)
    values[:, :-1] = table.values
    values[:, -1] = [names[g] for g in groups]
    return Table(list(table.index), list(table.columns) + ["auto_group"], values)


# ------------------------------------------------------------ model builder


def _group_var(v: np.ndarray) -> float:
    """pandas' ``var()``: ddof 1 over the non-NaN values, NaN below two."""
    v = v[~np.isnan(v)]
    return float(np.var(v, ddof=1)) if len(v) > 1 else float("nan")


def build_cox_model(table: Table, duration_col: str, event_col: str, n_splits: int = 5,
                    random_state: int = 42, eval_time: Optional[float] = None,
                    low_variance_threshold: float = 0.01, cox_penalizer: float = 0.05,
                    return_metrics: bool = True, device="auto"):
    """Fit CoxPH with a K-fold CV C-index (and the AUC at ``eval_time``);
    covariates whose variance among the events or the non-events is below
    ``low_variance_threshold`` are dropped first."""
    from .classical.model_selection import KFold
    from .metrics import concordance_index

    events = table.column(event_col).astype(float) != 0  # NaN counts as an event, as astype(bool)
    covariates = [c for c in table.columns if c not in (duration_col, event_col)]
    low_var = [c for c in covariates
               if _group_var(table.column(c)[events].astype(float)) < low_variance_threshold
               or _group_var(table.column(c)[~events].astype(float)) < low_variance_threshold]
    if low_var:
        print("Removed low variance features:", low_var)
        keep = [j for j, c in enumerate(table.columns) if c not in low_var]
        table = Table(list(table.index), [table.columns[j] for j in keep],
                      table.values[:, keep])

    metrics = {"cv_cindex_mean": None, "cv_auc_mean": None}
    kf = KFold(n_splits=n_splits, shuffle=True, random_state=random_state)
    c_indices: List[float] = []
    aucs: List[float] = []
    for tr, te in kf.split(table.index):
        train, test = table.take(tr), table.take(te)
        model = CoxPH(penalizer=cox_penalizer, device=device).fit(train, duration_col, event_col)
        risk = model.predict_partial_hazard(test)
        test_t = test.column(duration_col).astype(float)
        test_e = test.column(event_col).astype(float)
        c_indices.append(concordance_index(test_t, -risk, test_e.astype(int)))
        if eval_time is not None:
            if float(test_t.min()) < float(eval_time) < float(test_t.max()):
                auc, _ = cumulative_dynamic_auc(
                    train.column(duration_col).astype(float),
                    train.column(event_col).astype(float), test_t, test_e, risk,
                    [float(eval_time)])
                if np.isfinite(auc[0]):
                    aucs.append(float(auc[0]))
    metrics["cv_cindex_mean"] = float(np.mean(c_indices)) if c_indices else None
    metrics["cv_auc_mean"] = float(np.mean(aucs)) if aucs else None
    metrics["cv_cindex"] = c_indices

    final = CoxPH(penalizer=cox_penalizer, device=device).fit(table, duration_col, event_col)
    if return_metrics:
        return final, metrics
    return final
