"""Plotting helpers on matplotlib (Agg), imported inside each function.

Counterpart of ``flexynesis_tpu/utils/plotting.py`` without pandas,
seaborn, sklearn or umap; where matplotlib is missing a call raises an
``ImportError`` naming it, and importing this module needs nothing of it.
The figures draw the JAX package's data:

* ``plot_dim_reduced``: PCA through ``classical.PCA``, or t-SNE as an
  exact-gradient t-SNE in torch on the caller's device (sklearn's
  perplexity search, early exaggeration 12 for 250 iterations, momentum
  0.5 then 0.8, gains, learning rate ``max(n / 48, 50)``, 1000 iterations,
  PCA initialisation scaled to a first-column std of 1e-4) with JAX's
  perplexity ``min(30, max(n // 4, 2))``; "umap" falls back to t-SNE with
  JAX's warning (umap is not a dependency);
* ``plot_roc_curves`` / ``plot_pr_curves`` from ``utils.metrics``'s
  sklearn-exact curves;
* ``plot_label_concordance_heatmap``: the row-normalised crosstab drawn with
  ``imshow`` and "%.2f" annotations (seaborn's heatmap in JAX: the same
  numbers, another look).
"""

from __future__ import annotations

import math
import warnings
from typing import Optional

import numpy as np
import torch

from .device import resolve_device
from .survival import KaplanMeier, multivariate_logrank_test, unique_labels


def _pyplot():
    try:
        import matplotlib
    except ImportError as exc:
        raise ImportError("plotting needs matplotlib, which is not installed") from exc
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _with_na(labels) -> np.ndarray:
    """Labels as objects, NaN/None as "NA" (pandas' ``fillna("NA")``)."""
    return np.array(["NA" if v is None or (isinstance(v, float) and math.isnan(v)) else v
                     for v in np.asarray(labels, dtype=object).tolist()], dtype=object)


def get_color_mapping(labels):
    """Stable label -> color mapping over tab20, NaN labels as "NA"."""
    plt = _pyplot()
    cmap = plt.get_cmap("tab20")
    return {lb: cmap(i % 20) for i, lb in enumerate(unique_labels(_with_na(labels)))}


# ------------------------------------------------------------------ t-SNE


def _conditional_p(sqd: torch.Tensor, perplexity: float) -> torch.Tensor:
    """sklearn's ``_binary_search_perplexity`` over all rows at once: each
    row's precision beta halved or doubled, then bisected, until its entropy
    is within 1e-5 of log(perplexity), at most 100 steps."""
    n = sqd.shape[0]
    off = ~torch.eye(n, dtype=torch.bool, device=sqd.device)
    want = math.log(perplexity)
    beta = torch.ones(n, dtype=sqd.dtype, device=sqd.device)
    lo = torch.full_like(beta, -math.inf)
    hi = torch.full_like(beta, math.inf)
    done = torch.zeros(n, dtype=torch.bool, device=sqd.device)
    P = torch.zeros_like(sqd)
    for _ in range(100):
        Pi = torch.where(off, torch.exp(-sqd * beta[:, None]), 0.0)
        s = Pi.sum(1)
        s = torch.where(s == 0, 1e-8, s)
        Pi = Pi / s[:, None]
        entropy = torch.log(s) + beta * (sqd * Pi).sum(1)
        diff = entropy - want
        P = torch.where(done[:, None], P, Pi)
        done = done | (diff.abs() <= 1e-5)
        if bool(done.all()):
            break
        up = (diff > 0) & ~done
        down = (diff <= 0) & ~done
        new_beta = torch.where(up, torch.where(torch.isinf(hi), beta * 2, (beta + hi) / 2),
                               torch.where(torch.isinf(lo), beta / 2, (beta + lo) / 2))
        lo = torch.where(up, beta, lo)
        hi = torch.where(down, beta, hi)
        beta = torch.where(done, beta, new_beta)
    return P


TSNE_ITERATIONS, EXPLORATION, EXAGGERATION = 1000, 250, 12.0  # sklearn's defaults


def tsne(X, perplexity: float = 30.0, device="auto") -> np.ndarray:
    """A 2-D exact-gradient t-SNE (sklearn's ``TSNE(method="exact")`` steps)
    in float64 on ``device``."""
    from .classical.pca import PCA

    dev = resolve_device(device)
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    Xd = torch.as_tensor(X, device=dev)
    xx = (Xd * Xd).sum(1)
    sqd = (xx[:, None] + xx[None, :] - 2 * Xd @ Xd.T).clamp(min=0).fill_diagonal_(0)
    cond = _conditional_p(sqd.to(torch.float32).to(torch.float64), perplexity)
    P = cond + cond.T
    P = torch.clamp(P / P.sum().clamp(min=np.finfo(np.float64).eps),
                    min=np.finfo(np.float64).eps)
    off = ~torch.eye(n, dtype=torch.bool, device=dev)
    P = torch.where(off, P, 0.0)
    emb = PCA(2).fit(X).transform(X)
    emb = emb / np.std(emb[:, 0]) * 1e-4
    Y = torch.as_tensor(emb, device=dev)
    lr = max(n / EXAGGERATION / 4, 50)
    update = torch.zeros_like(Y)
    gains = torch.ones_like(Y)

    def grad_of(Y, P):
        yy = (Y * Y).sum(1)
        dist = 1.0 / (1.0 + (yy[:, None] + yy[None, :] - 2 * Y @ Y.T).clamp(min=0))
        dist = torch.where(off, dist, 0.0)
        Q = torch.clamp(dist / dist.sum(), min=np.finfo(np.float64).eps)
        W = (P - Q) * dist
        return 4.0 * (W.sum(1, keepdim=True) * Y - W @ Y)

    for it in range(TSNE_ITERATIONS):
        exploring = it < EXPLORATION
        grad = grad_of(Y, P * EXAGGERATION if exploring else P)
        inc = update * grad < 0.0
        gains = torch.clamp(torch.where(inc, gains + 0.2, gains * 0.8), min=0.01)
        grad = grad * gains
        update = (0.5 if exploring else 0.8) * update - lr * grad
        Y = Y + update
        if (it + 1) % 50 == 0 and float(torch.linalg.vector_norm(grad)) <= 1e-7:
            break
    return Y.cpu().numpy()


# ----------------------------------------------------------------- figures


def plot_dim_reduced(matrix, labels, method: str = "pca", color_type: str = "categorical",
                     scatter_kwargs: Optional[dict] = None, device="auto"):
    """2D embedding scatter (PCA, or t-SNE; umap falls back to t-SNE),
    colored by labels."""
    plt = _pyplot()
    X = np.asarray(matrix, dtype=float)
    if method == "pca":
        from .classical.pca import PCA

        emb = PCA(n_components=2).fit(X).transform(X)
        xlab, ylab = "PC1", "PC2"
    elif method in ("umap", "tsne"):
        if method == "umap":
            warnings.warn("umap-learn is not installed; falling back to t-SNE.")
        emb = tsne(X, perplexity=min(30, max(len(X) // 4, 2)), device=device)
        xlab, ylab = "dim1", "dim2"
    else:
        raise ValueError(f"Unknown method: {method}")

    fig, ax = plt.subplots(figsize=(7, 6))
    labels = _with_na(labels)
    kwargs = dict(s=18, alpha=0.8)
    kwargs.update(scatter_kwargs or {})
    if color_type == "categorical":
        for lb, c in get_color_mapping(labels).items():
            m = labels == lb
            ax.scatter(emb[m, 0], emb[m, 1], color=c, label=str(lb), **kwargs)
        ax.legend(loc="best", fontsize=8)
    else:
        vals = np.array([_to_float(v) for v in labels])
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=vals, cmap="viridis", **kwargs)
        fig.colorbar(sc, ax=ax)
    ax.set_xlabel(xlab)
    ax.set_ylabel(ylab)
    fig.tight_layout()
    return fig


def _to_float(v) -> float:
    """pandas' ``to_numeric(errors="coerce")`` of one label."""
    try:
        return float(v)
    except (TypeError, ValueError):
        return float("nan")


def plot_kaplan_meier_curves(durations, events, categorical_variable, title=None):
    """Per-group KM curves + multivariate log-rank p-value annotation."""
    plt = _pyplot()
    durations = np.asarray(durations, dtype=float)
    events = np.asarray(events, dtype=float)
    groups = _with_na(categorical_variable)
    fig, ax = plt.subplots(figsize=(7, 6))
    for lb, color in get_color_mapping(groups).items():
        m = groups == lb
        if m.sum() == 0:
            continue
        km = KaplanMeier().fit(durations[m], events[m])
        t = np.concatenate([[0], km.timeline])
        s = np.concatenate([[1.0], km.survival])
        ax.step(t, s, where="post", label=f"{lb} (n={int(m.sum())})", color=color)
    res = multivariate_logrank_test(durations, groups, events)
    ax.set_xlabel("Time")
    ax.set_ylabel("Survival probability")
    ax.set_ylim(0, 1.02)
    ax.legend(loc="best", fontsize=8)
    ax.set_title((title or "Kaplan-Meier") + f"  (log-rank p={res.p_value:.3g})")
    fig.tight_layout()
    return fig


def plot_scatter(true_values, predicted_values):
    """True vs predicted scatter with fit line and Pearson r annotation."""
    from scipy.stats import linregress

    plt = _pyplot()
    y, yh = np.asarray(true_values, float), np.asarray(predicted_values, float)
    m = np.isfinite(y) & np.isfinite(yh)
    lr = linregress(y[m], yh[m])
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(y[m], yh[m], s=16, alpha=0.7)
    xs = np.linspace(y[m].min(), y[m].max(), 10)
    ax.plot(xs, lr.intercept + lr.slope * xs, color="red")
    ax.set_xlabel("True values")
    ax.set_ylabel("Predicted values")
    ax.set_title(f"r={lr.rvalue:.3f}, p={lr.pvalue:.3g}")
    fig.tight_layout()
    return fig


def plot_boxplot(categorical_x, numerical_y, title_x="Categories", title_y="Values",
                 jittersize=4):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7, 5))
    x = np.asarray(categorical_x, dtype=object)
    y = np.asarray(numerical_y, dtype=float)
    uniq = unique_labels([v for v in x.tolist() if v is not None])
    data = [y[x == u] for u in uniq]
    ax.boxplot(data, tick_labels=[str(u) for u in uniq], showfliers=False)
    rng = np.random.default_rng(0)
    for i, d in enumerate(data):
        ax.scatter(np.full(len(d), i + 1) + rng.uniform(-0.12, 0.12, len(d)), d,
                   s=jittersize, alpha=0.6, color="black")
    ax.set_xlabel(title_x)
    ax.set_ylabel(title_y)
    fig.tight_layout()
    return fig


def plot_roc_curves(y_true, y_probs):
    from .metrics import _binary_auroc, roc_curve

    plt = _pyplot()
    y_true = np.asarray(y_true)
    y_probs = np.asarray(y_probs)
    fig, ax = plt.subplots(figsize=(6, 6))
    n_classes = y_probs.shape[1]
    if n_classes == 2:
        fpr, tpr, _ = roc_curve(y_true, y_probs[:, 1])
        auc = _binary_auroc((y_true == 1).astype(float), y_probs[:, 1])
        ax.plot(fpr, tpr, label=f"Class 1 (AUC={auc:.2f})")
    else:
        for c in range(n_classes):
            yb = (y_true == c).astype(int)
            if yb.sum() == 0 or yb.sum() == len(yb):
                continue
            fpr, tpr, _ = roc_curve(yb, y_probs[:, c])
            auc = _binary_auroc(yb.astype(float), y_probs[:, c])
            ax.plot(fpr, tpr, label=f"Class {c} (AUC={auc:.2f})")
    ax.plot([0, 1], [0, 1], "k--", lw=0.8)
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.set_title("ROC Curve")
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def plot_pr_curves(y_true, y_probs):
    from .metrics import _binary_average_precision, precision_recall_curve

    plt = _pyplot()
    y_true = np.asarray(y_true)
    y_probs = np.asarray(y_probs)
    fig, ax = plt.subplots(figsize=(6, 6))
    n_classes = y_probs.shape[1]
    classes = [1] if n_classes == 2 else range(n_classes)
    for c in classes:
        yb = (y_true == c).astype(int) if n_classes > 2 else y_true
        probs = y_probs[:, c]
        if np.unique(yb).size < 2:
            continue
        prec, rec, _ = precision_recall_curve(yb, probs)
        ap = _binary_average_precision((np.asarray(yb) == 1).astype(float), probs)
        ax.plot(rec, prec, label=f"Class {c} (AP={ap:.2f})")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_title("Precision-Recall Curve")
    ax.legend(fontsize=8)
    fig.tight_layout()
    return fig


def concordance_table(labels1, labels2):
    """(row labels, column labels, fractions): ``pd.crosstab(labels1,
    labels2, normalize="index")``, labels sorted, NaN pairs left out."""
    a = np.asarray(labels1, dtype=object)
    b = np.asarray(labels2, dtype=object)
    ok = np.array([not (v is None or (isinstance(v, float) and math.isnan(v)))
                   and not (w is None or (isinstance(w, float) and math.isnan(w)))
                   for v, w in zip(a.tolist(), b.tolist())], dtype=bool)
    rows, cols = sorted(set(a[ok].tolist())), sorted(set(b[ok].tolist()))
    counts = np.zeros((len(rows), len(cols)))
    ri, ci = {v: i for i, v in enumerate(rows)}, {v: i for i, v in enumerate(cols)}
    for v, w in zip(a[ok].tolist(), b[ok].tolist()):
        counts[ri[v], ci[w]] += 1
    return rows, cols, counts / counts.sum(axis=1, keepdims=True)


def plot_label_concordance_heatmap(labels1, labels2, figsize=(12, 10)):
    plt = _pyplot()
    rows, cols, frac = concordance_table(labels1, labels2)
    fig, ax = plt.subplots(figsize=figsize)
    im = ax.imshow(frac, cmap="viridis", aspect="auto")
    for i in range(len(rows)):
        for j in range(len(cols)):
            ax.text(j, i, f"{frac[i, j]:.2f}", ha="center", va="center",
                    color="white" if frac[i, j] < 0.5 else "black")
    ax.set_xticks(range(len(cols)))
    ax.set_xticklabels([str(c) for c in cols])
    ax.set_yticks(range(len(rows)))
    ax.set_yticklabels([str(r) for r in rows])
    ax.set_xlabel("labels2")
    ax.set_ylabel("labels1")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def plot_hazard_ratios(cox_model):
    """Forest plot of hazard ratios with 95% CI + significance stars."""
    plt = _pyplot()

    def significance(p):
        return "***" if p < 0.001 else "**" if p < 0.01 else "*" if p < 0.05 else ""

    summary = cox_model.summary
    order = np.argsort(summary.column("exp(coef)"), kind="stable")
    hr = summary.column("exp(coef)")[order]
    lo = summary.column("exp(coef) lower 95%")[order]
    hi = summary.column("exp(coef) upper 95%")[order]
    p = summary.column("p")[order]
    names = [summary.index[i] for i in order]
    ypos = np.arange(len(names))
    fig, ax = plt.subplots(figsize=(7, max(2, 0.4 * len(names) + 1)))
    ax.errorbar(hr, ypos, xerr=[hr - lo, hi - hr], fmt="o", color="black", ecolor="gray",
                capsize=3)
    for y, (h, pv) in enumerate(zip(hr, p)):
        ax.annotate(significance(pv), (h, y), textcoords="offset points", xytext=(0, 6),
                    ha="center", fontsize=10, color="red")
    ax.axvline(1.0, color="blue", linestyle="--", lw=0.8)
    ax.set_yticks(ypos)
    ax.set_yticklabels(names)
    ax.set_xlabel("Hazard ratio (95% CI)")
    ax.set_title("Hazard ratios")
    fig.tight_layout()
    return fig
