"""Evaluation metrics in numpy/scipy: classification, regression, survival.

Counterpart of ``flexynesis_tpu/utils/metrics.py`` (reference utils.py:416-834)
without sklearn or pandas. The classification scores follow sklearn's
definitions, including its edge cases: labels are the union of true and
predicted classes, weighted averages are weighted by true-class support,
AUROC and AUPR are ``None`` where sklearn raises. ``evaluate_wrapper`` and
``get_predicted_labels`` return lists of row dicts.
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
from scipy.stats import linregress, rankdata


def concordance_index(event_times, predicted_scores, event_observed=None) -> float:
    """Harrell's C-index; a higher score means longer expected survival.

    (i, j) is comparable when t_i < t_j and subject i had an event, or
    t_i == t_j with exactly one event (the event subject is the 'short' one).
    Concordant = the shorter-lived subject has the lower score; score ties
    count 0.5."""
    t = np.asarray(event_times, dtype=np.float64).ravel()
    s = np.asarray(predicted_scores, dtype=np.float64).ravel()
    e = (
        np.ones_like(t)
        if event_observed is None
        else np.asarray(event_observed, dtype=np.float64).ravel()
    )
    if np.isnan(t).any() or np.isnan(s).any() or np.isnan(e).any():
        raise ValueError(
            "NaNs detected in inputs of concordance_index; correct or drop."
        )
    ti, tj = t[:, None], t[None, :]
    si, sj = s[:, None], s[None, :]
    ei, ej = e[:, None], e[None, :]
    comparable = ((ti < tj) & (ei == 1)) | ((ti == tj) & (ei == 1) & (ej == 0))
    concordant = comparable & (si < sj)
    tied = comparable & (si == sj)
    n_pairs = comparable.sum()
    if n_pairs == 0:
        raise ZeroDivisionError("No admissible pairs for the concordance index.")
    return float((concordant.sum() + 0.5 * tied.sum()) / n_pairs)


def evaluate_survival(outputs, durations, events) -> Dict[str, float]:
    """C-index of risk scores (higher risk -> shorter survival); NaN with a
    warning when no row or no pair can be scored."""
    outputs = np.asarray(outputs, dtype=np.float64).ravel()
    durations = np.asarray(durations, dtype=np.float64).ravel()
    events = np.asarray(events, dtype=np.float64).ravel()
    valid = ~np.isnan(durations) & ~np.isnan(events)
    if valid.sum() == 0:
        warnings.warn(
            "evaluate_survival: no samples with observed duration+event; "
            "reporting cindex=NaN."
        )
        return {"cindex": float("nan")}
    outputs, durations, events = outputs[valid], durations[valid], events[valid]
    try:
        return {"cindex": concordance_index(durations, -outputs, events)}
    except ZeroDivisionError:
        warnings.warn(
            "evaluate_survival: no admissible pair (all times tied/censored);"
            " reporting cindex=NaN."
        )
        return {"cindex": float("nan")}


def _confusion(y_true, y_pred):
    labels = np.union1d(y_true, y_pred)
    t = np.searchsorted(labels, y_true)
    p = np.searchsorted(labels, y_pred)
    cm = np.zeros((labels.size, labels.size), dtype=np.int64)
    np.add.at(cm, (t, p), 1)
    return cm


def balanced_accuracy(cm: np.ndarray) -> float:
    with np.errstate(divide="ignore", invalid="ignore"):
        per_class = np.diag(cm) / cm.sum(axis=1)
    return float(np.mean(per_class[~np.isnan(per_class)]))


def weighted_f1(cm: np.ndarray) -> float:
    """Support-weighted F1 with zero_division=0."""
    tp = np.diag(cm).astype(np.float64)
    denom = cm.sum(axis=1) + cm.sum(axis=0)
    f1 = np.divide(2 * tp, denom, out=np.zeros_like(tp), where=denom > 0)
    support = cm.sum(axis=1)
    if support.sum() == 0:
        return 0.0
    return float(np.average(f1, weights=support))


def cohen_kappa(cm: np.ndarray) -> float:
    cm = cm.astype(np.float64)
    sum0, sum1 = cm.sum(axis=0), cm.sum(axis=1)
    if sum0.sum() == 0:
        return float("nan")
    expected = np.outer(sum0, sum1) / sum0.sum()
    w = np.ones_like(cm) - np.eye(cm.shape[0])
    denom = np.sum(w * expected)
    with np.errstate(divide="ignore", invalid="ignore"):
        return float(1 - np.sum(w * cm) / denom)


def _binary_auroc(y, score) -> float:
    """Area under the ROC curve of binary labels y (ties count one half);
    NaN when only one class is present, as sklearn returns."""
    pos = y == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    ranks = rankdata(score)
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def _binary_average_precision(y, score) -> float:
    """Step-function area under the precision-recall curve of binary labels y."""
    order = np.argsort(-score, kind="mergesort")
    s, y = score[order], y[order]
    last = np.r_[np.nonzero(np.diff(s))[0], s.size - 1]  # end of each threshold
    tps = np.cumsum(y)[last]
    fps = (last + 1) - tps
    precision = tps / (tps + fps)
    # no positives: sklearn sets the recall to one at every threshold
    recall = tps / tps[-1] if tps[-1] > 0 else np.ones_like(precision)
    return float(max(0.0, np.sum(np.diff(np.r_[0.0, recall]) * precision)))


def _thresholds(y, score):
    """(fps, tps, thresholds) at each distinct score, descending, as
    sklearn's ``confusion_matrix_at_thresholds`` (positive label 1)."""
    y = (np.asarray(y) == 1).astype(np.float64)
    score = np.asarray(score, dtype=np.float64)
    order = np.argsort(score, kind="mergesort")[::-1]
    score, y = score[order], y[order]
    idx = np.r_[np.where(np.diff(score))[0], y.size - 1]
    tps = np.cumsum(y)[idx]
    return 1 + idx - tps, tps, score[idx]


def roc_curve(y_true, y_score):
    """(fpr, tpr, thresholds) of binary labels, as sklearn's ``roc_curve``
    (collinear points dropped, a first point at (0, 0), threshold inf)."""
    fps, tps, thr = _thresholds(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thr = fps[keep], tps[keep], thr[keep]
    tps, fps = np.r_[0.0, tps], np.r_[0.0, fps]
    thr = np.r_[np.inf, thr]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thr


def precision_recall_curve(y_true, y_score):
    """(precision, recall, thresholds) of binary labels, as sklearn's
    ``precision_recall_curve``: recall decreasing, ending at (1, 0)."""
    fps, tps, thr = _thresholds(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thr[::-1]


def _weighted_ovr(metric, y_true, y_probs, classes) -> float:
    onehot = (y_true[:, None] == classes[None, :]).astype(np.float64)
    weights = onehot.sum(axis=0)
    if np.isclose(weights.sum(), 0.0):
        return 0.0
    scores = [metric(onehot[:, c], y_probs[:, c]) for c in range(classes.size)]
    return float(np.average(scores, weights=weights))


def _auroc_aupr(y_true, y_probs):
    """(AUROC, AUPR) as evaluate_classifier reports them; raises ValueError
    where sklearn's roc_auc_score or average_precision_score do."""
    classes = np.unique(y_true)
    if y_probs.shape[1] <= 2:  # binary: the score of the last column
        if classes.size > 2:
            raise ValueError("multiclass y_true with binary scores")
        if classes.size == 2 and 1 not in classes:
            raise ValueError("pos_label=1 is not a valid label.")
        score = y_probs[:, -1]
        auroc = _binary_auroc((y_true == classes[-1]).astype(np.float64), score)
        return auroc, _binary_average_precision((y_true == 1).astype(np.float64), score)
    if classes.size != y_probs.shape[1]:
        raise ValueError(
            "Number of classes in y_true not equal to the number of columns in 'y_score'"
        )
    if not np.allclose(1, y_probs.sum(axis=1)):
        raise ValueError("Target scores need to be probabilities for multiclass roc_auc")
    return (
        _weighted_ovr(_binary_auroc, y_true, y_probs, classes),
        _weighted_ovr(_binary_average_precision, y_true, y_probs, classes),
    )


def classification_report(y_true, y_pred) -> str:
    """The text of sklearn's ``classification_report(y_true, y_pred,
    zero_division=0)``: per label (the sorted union of true and predicted
    labels, named as ``"%s" % label``) precision, recall, f1-score and
    support, then accuracy, macro avg and weighted avg, to 2 digits."""
    digits = 2
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    labels = np.union1d(y_true, y_pred)
    cm = _confusion(y_true, y_pred)
    tp = np.diag(cm).astype(np.float64)
    support, predicted = cm.sum(axis=1), cm.sum(axis=0)
    if not tp.any():  # sklearn then counts the supports in floats
        support = support.astype(np.float64)

    def ratio(num, den):
        return np.divide(num, den, out=np.zeros_like(num), where=den > 0)

    per_class = [ratio(tp, predicted), ratio(tp, support), ratio(2 * tp, support + predicted)]
    names = ["%s" % label for label in labels]
    width = max(max(len(n) for n in names), len("weighted avg"), digits)
    head_fmt = "{:>{width}s} " + " {:>9}" * 4
    row_fmt = "{:>{width}s} " + " {:>9.{digits}f}" * 3 + " {:>9}\n"
    report = head_fmt.format("", "precision", "recall", "f1-score", "support",
                             width=width) + "\n\n"
    for name, p, r, f, n in zip(names, *per_class, support):
        report += row_fmt.format(name, p, r, f, n, width=width, digits=digits)
    total = support.sum()
    accuracy = tp.sum() / total if total else 0.0
    report += "\n" + ("{:>{width}s} " + " {:>9.{digits}}" * 2 + " {:>9.{digits}f} {:>9}\n"
                      ).format("accuracy", "", "", accuracy, total, width=width, digits=digits)
    macro = [np.average(v) for v in per_class]
    weighted = [np.average(v, weights=support) if total else 0.0 for v in per_class]
    report += row_fmt.format("macro avg", *macro, total, width=width, digits=digits)
    report += row_fmt.format("weighted avg", *weighted, total, width=width, digits=digits)
    return report


def evaluate_classifier(y_true, y_probs, print_report: bool = False) -> Dict:
    """balanced_acc, weighted F1, Cohen's kappa, AUROC (ovr weighted), AUPR;
    ``print_report`` also prints ``classification_report``."""
    y_pred = np.argmax(np.asarray(y_probs), axis=1)
    if print_report:
        print(classification_report(y_true, y_pred))
    y_true = np.asarray(y_true, dtype=np.float64)
    y_probs = np.asarray(y_probs, dtype=np.float64)
    cm = _confusion(y_true, y_pred.astype(np.float64))
    try:
        average_auroc, average_aupr = _auroc_aupr(y_true, y_probs)
    except ValueError:
        average_auroc = average_aupr = None
    return {
        "balanced_acc": balanced_accuracy(cm),
        "f1_score": weighted_f1(cm),
        "kappa": cohen_kappa(cm),
        "average_auroc": average_auroc,
        "average_aupr": average_aupr,
    }


def evaluate_regressor(y_true, y_pred) -> Dict[str, float]:
    """MSE, R^2 (squared Pearson r of y_true vs y_pred) and Pearson r."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_pred = np.asarray(y_pred, dtype=np.float64).ravel()
    mse = float(np.mean((y_true - y_pred) ** 2))
    lr = linregress(y_true, y_pred)
    return {"mse": mse, "r2": lr.rvalue**2, "pearson_corr": lr.rvalue}


def generate_bootstrap_indices(n: int, n_bootstraps: int = 1000, seed: int = 42):
    rng = np.random.default_rng(seed)
    return [rng.choice(n, size=n, replace=True) for _ in range(n_bootstraps)]


def bootstrap_metric(y_true, y_pred, indices_list, metric_fn, ci=95, **kwargs):
    """The metric over each bootstrap draw, and (mean, lower, upper) of its
    ``ci`` percent interval."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    scores = [metric_fn(y_true[idx], y_pred[idx], **kwargs) for idx in indices_list]
    lower = np.percentile(scores, (100 - ci) / 2)
    upper = np.percentile(scores, 100 - (100 - ci) / 2)
    return scores, (float(np.mean(scores)), float(lower), float(upper))


def evaluate_wrapper(method: str, y_pred_dict: Dict[str, np.ndarray], dataset,
                     surv_event_var: Optional[str] = None,
                     surv_time_var: Optional[str] = None) -> List[dict]:
    """Long-format metric rows across all predicted variables; variables
    without labels in the cohort are skipped."""
    rows = []
    for var in y_pred_dict.keys():
        if var not in dataset.ann:
            print(f"[INFO] No '{var}' labels in the cohort; skipping metrics")
            continue
        ann = np.asarray(dataset.ann[var], dtype=np.float64)
        if dataset.variable_types[var] == "numerical":
            if var == surv_event_var:
                metrics = evaluate_survival(
                    y_pred_dict[var], np.asarray(dataset.ann[surv_time_var]), ann
                )
            else:
                ind = ~np.isnan(ann)
                if not ind.any():
                    print(f"[INFO] All '{var}' labels missing; skipping metrics")
                    continue
                metrics = evaluate_regressor(
                    ann[ind], np.asarray(y_pred_dict[var]).ravel()[ind]
                )
        else:
            # -1 = missing/unseen level
            ind = ~np.isnan(ann) & (ann != -1)
            if not ind.any():
                print(
                    f"[INFO] No known '{var}' labels in the cohort (all "
                    "missing or unseen levels); skipping metrics"
                )
                continue
            metrics = evaluate_classifier(ann[ind], np.asarray(y_pred_dict[var])[ind])
        for metric, value in metrics.items():
            rows.append({
                "method": method,
                "var": var,
                "variable_type": dataset.variable_types[var],
                "metric": metric,
                "value": value,
            })
    return rows


def get_predicted_labels(y_pred_dict: Dict[str, np.ndarray], dataset, split: str,
                         method_name: str) -> List[dict]:
    """Long-format per-sample prediction rows (probabilities + labels)."""
    rows = []
    n = len(dataset.samples)
    for var in y_pred_dict.keys():
        preds_arr = np.asarray(y_pred_dict[var])
        vtype = dataset.variable_types.get(
            var, "categorical" if preds_arr.ndim == 2 else "numerical"
        )
        ann = np.asarray(dataset.ann.get(var, np.full(n, np.nan)), dtype=np.float64)
        if vtype == "categorical":
            probs = preds_arr
            mapping = dataset.label_mappings.get(var)

            def _name(i):
                # a NaN category (missing labels in training) shows as "Unknown"
                v = mapping.get(int(i), f"class_{int(i)}") if mapping else f"class_{int(i)}"
                return "Unknown" if isinstance(v, float) and np.isnan(v) else v

            class_labels = [_name(i) for i in range(probs.shape[1])]
            y_true = [
                _name(v) if mapping is not None and not np.isnan(v) else np.nan
                for v in ann
            ]
            y_pred = [_name(i) for i in np.argmax(probs, axis=1)]
            for i, sample_id in enumerate(dataset.samples):
                for j, cl in enumerate(class_labels):
                    rows.append({
                        "sample_id": sample_id,
                        "variable": var,
                        "class_label": cl,
                        "probability": float(probs[i, j]),
                        "known_label": y_true[i],
                        "predicted_label": y_pred[i],
                        "split": split,
                        "method": method_name,
                    })
        else:
            preds = preds_arr.ravel()
            for i, sample_id in enumerate(dataset.samples):
                rows.append({
                    "sample_id": sample_id,
                    "variable": var,
                    "class_label": np.nan,
                    "probability": np.nan,
                    "known_label": float(ann[i]),
                    "predicted_label": float(preds[i]),
                    "split": split,
                    "method": method_name,
                })
    return rows
