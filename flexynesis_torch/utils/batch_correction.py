"""Batch-effect correction toolkit (experimental, library-only, as in the
reference).

Counterpart of ``flexynesis_tpu/utils/batch_correction.py`` without sklearn
or pandas; tables are ``utils.csvio.Table``s (samples x features). On the
caller's device (the card unless ``device="cpu"``):

* ``sinkhorn_plan`` (log-domain, uniform marginals) and
  ``sinkhorn_divergence`` in float32, as JAX runs them;
* ``optimal_transport_align``: batch 2 replaced by its barycentric projection
  onto batch 1 under the Sinkhorn plan of the normalised euclidean cost;
* ``reciprocal_pca_mnn``: each batch's PCA (``classical.PCA``), mutual
  nearest neighbours across the two projections (kNN on the device) as
  anchors, batch 2 mapped onto batch 1 by least squares over them;
* ``remove_batch_associated_variables``: a random forest's impurity
  importances at or above their mean (``SelectFromModel``'s rule) per target,
  minus the features whose KSG mutual information with a batch variable is
  above ``mi_threshold`` (``classical.feature_selection``); random, as in
  JAX (no seed reaches the forest or the jitter);
* ``compute_correlation_loss`` and ``compute_transport_cost``.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from .csvio import Table
from .device import full_f32, resolve_device

# ------------------------------------------------------- Sinkhorn core


def sinkhorn_plan(cost: torch.Tensor, eps: float = 0.01, n_iters: int = 500) -> torch.Tensor:
    """Entropy-regularised OT plan between uniform marginals (log-domain)."""
    n, m = cost.shape
    log_a = torch.full((n,), -math.log(n), dtype=cost.dtype, device=cost.device)
    log_b = torch.full((m,), -math.log(m), dtype=cost.dtype, device=cost.device)
    K = -cost / eps
    u = torch.zeros(n, dtype=cost.dtype, device=cost.device)
    v = torch.zeros(m, dtype=cost.dtype, device=cost.device)
    for _ in range(n_iters):
        u = log_a - torch.logsumexp(K + v[None, :], dim=1)
        v = log_b - torch.logsumexp(K + u[:, None], dim=0)
    return torch.exp(K + u[:, None] + v[None, :])


def _sq_cost(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a2 = torch.sum(a * a, 1)[:, None]
    b2 = torch.sum(b * b, 1)[None, :]
    return torch.clamp(a2 + b2 - 2 * a @ b.T, min=0.0)


def sinkhorn_divergence(x: torch.Tensor, y: torch.Tensor, blur: float = 0.5,
                        n_iters: int = 300) -> torch.Tensor:
    """Debiased Sinkhorn divergence S(x,y) = OT(x,y) - (OT(x,x)+OT(y,y))/2."""
    eps = blur ** 2

    def ot_cost(a, b):
        C = _sq_cost(a, b)
        return torch.sum(sinkhorn_plan(C, eps=eps, n_iters=n_iters) * C)

    return ot_cost(x, y) - 0.5 * (ot_cost(x, x) + ot_cost(y, y))


def _f32(values, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(values, dtype=np.float32), device=device)


# ------------------------------------------------------------- public API


def remove_batch_associated_variables(data: Table, variable_types: dict, target_dict: dict,
                                      batch_dict: dict | None = None,
                                      mi_threshold: float = 0.1, device="auto") -> Table:
    """Keep target-predictive features; drop batch-informative ones."""
    from .classical.ensemble import RandomForestClassifier, RandomForestRegressor
    from .classical.feature_selection import (
        mutual_info_classif,
        mutual_info_regression,
        select_from_model,
    )

    X = np.asarray(data.values, dtype=np.float64)
    important = set()
    for var, target in target_dict.items():
        target = np.asarray(target, dtype=float)
        if np.all(np.isnan(target)):
            continue
        ok = ~np.isnan(target)
        forest = (RandomForestClassifier if variable_types[var] == "categorical"
                  else RandomForestRegressor)(device=device)
        forest.fit(X[ok], target[ok])
        support = select_from_model(forest.feature_importances_)
        important.update(c for c, s in zip(data.columns, support) if s)
    if batch_dict is not None:
        for var, batch in batch_dict.items():
            batch = np.asarray(batch, dtype=float)
            if np.all(np.isnan(batch)):
                continue
            ok = ~np.isnan(batch)
            mi_fn = (mutual_info_classif if variable_types[var] == "categorical"
                     else mutual_info_regression)
            mi = mi_fn(X[ok], batch[ok], device=device)
            important -= {c for c, v in zip(data.columns, mi) if v > mi_threshold}
    keep = [j for j, c in enumerate(data.columns) if c in important]
    return Table(list(data.index), [data.columns[j] for j in keep], data.values[:, keep])


def generate_synthetic_batches(n_samples_per_batch: int = 150,
                               n_features: int = 50) -> Tuple[Table, np.ndarray]:
    b1 = np.random.normal(0.0, 1.0, (n_samples_per_batch, n_features))
    b2 = np.random.normal(2.0, 1.5, (n_samples_per_batch, n_features))
    values = np.vstack([b1, b2])
    data = Table([str(i) for i in range(len(values))],
                 [f"feature_{i + 1}" for i in range(n_features)], values)
    return data, np.array([0] * n_samples_per_batch + [1] * n_samples_per_batch)


def _two_batches(batch_labels, what: str):
    labels = np.asarray(batch_labels)
    uniq = np.unique(labels)
    if len(uniq) != 2:
        raise ValueError(f"{what} supports aligning exactly two batches.")
    return np.where(labels == uniq[0])[0], np.where(labels == uniq[1])[0]


def _standard_scaled(x: np.ndarray) -> np.ndarray:
    """sklearn's ``StandardScaler().fit_transform``."""
    std = x.std(axis=0)
    return (x - x.mean(axis=0)) / np.where(std == 0, 1.0, std)


def optimal_transport_align(embeddings: Table, batch_labels,
                            standardize_by_labels: bool = False, eps: float = 0.005,
                            device="auto"):
    """Align two batches by optimal transport: batch 2's samples replaced by
    their barycentric projection onto batch 1; returns (Table, labels)."""
    dev = resolve_device(device)
    i1, i2 = _two_batches(batch_labels, "Optimal transport")
    values = np.asarray(embeddings.values)
    x1, x2 = _f32(values[i1], dev), _f32(values[i2], dev)
    with full_f32():
        cost = torch.sqrt(_sq_cost(x1, x2))  # euclidean, as ot.dist(metric="euclidean")
        cost = cost / torch.clamp(torch.max(cost), min=1e-12)
        plan = sinkhorn_plan(cost, eps=eps, n_iters=1000)
        weights = plan.T / torch.clamp(torch.sum(plan.T, dim=1, keepdim=True), min=1e-12)
        aligned = weights @ x1
    out = values.copy()
    out[i2] = aligned.cpu().numpy()
    if standardize_by_labels:
        out[i1] = _standard_scaled(out[i1])
        out[i2] = _standard_scaled(out[i2])
    return (Table(list(embeddings.index), list(embeddings.columns), out),
            np.asarray(batch_labels))


def _kneighbors(fit: torch.Tensor, query: torch.Tensor, k: int) -> np.ndarray:
    """Indices of each query row's k nearest fitted rows, nearest first."""
    d = torch.cdist(query, fit)
    return torch.topk(d, k, dim=1, largest=False).indices.cpu().numpy()


def reciprocal_pca_mnn(embeddings: Table, batch_labels, n_components: int = 10,
                       n_neighbors: int = 5, standardize_by_labels: bool = False,
                       random_state=None, device="auto"):
    """rPCA + mutual-nearest-neighbour anchor alignment of two batches;
    returns (Table of rPCA_1..n, labels). ``random_state`` is taken for the
    JAX signature: the full SVD draws nothing."""
    from .classical.pca import PCA

    dev = resolve_device(device)
    i1, i2 = _two_batches(batch_labels, "Reciprocal PCA")
    values = np.asarray(embeddings.values, dtype=np.float64)
    x1, x2 = values[i1], values[i2]
    if standardize_by_labels:
        x1 = (x1 - x1.mean(0)) / x1.std(0)
        x2 = (x2 - x2.mean(0)) / x2.std(0)
    pca1, pca2 = PCA(n_components).fit(x1), PCA(n_components).fit(x2)
    p1, p2 = pca1.transform(x1), pca2.transform(x2)
    x1_in_2, x2_in_1 = pca2.transform(x1), pca1.transform(x2)

    def t(a):
        return torch.as_tensor(a, device=dev)

    idx1 = _kneighbors(t(x2_in_1), t(p1), n_neighbors)
    idx2 = _kneighbors(t(x1_in_2), t(p2), n_neighbors)
    anchors = [(i, j) for i, nbrs in enumerate(idx1) for j in nbrs if i in idx2[j]]
    if not anchors:
        raise ValueError("No mutual nearest neighbors (MNN) found between batches.")
    anchors = np.asarray(anchors)
    A = np.linalg.pinv(p2[anchors[:, 1]]) @ p1[anchors[:, 0]]
    out = np.zeros((len(values), n_components))
    out[i1] = p1
    out[i2] = p2 @ A
    return (Table(list(embeddings.index), [f"rPCA_{i + 1}" for i in range(n_components)], out),
            np.asarray(batch_labels))


def compute_correlation_loss(embeddings, batch_labels, device="auto") -> float:
    """Sum of |corr(embedding_dim, batch_label)|."""
    dev = resolve_device(device)
    e = _f32(embeddings, dev)
    b = _f32(batch_labels, dev)
    e = (e - e.mean(0, keepdim=True)) / (e.std(0, correction=0, keepdim=True) + 1e-8)
    b = (b - b.mean()) / (b.std(correction=0) + 1e-8)
    with full_f32():
        cov = (b[None, :] @ e) / (e.shape[0] - 1)
    return float(torch.sum(torch.abs(cov)))


def compute_transport_cost(embeddings, batch_labels, blur: float = 0.5,
                           device="auto") -> float:
    """Sinkhorn divergence between the two batches' embeddings."""
    dev = resolve_device(device)
    e = _f32(embeddings, dev)
    b = np.asarray(batch_labels).astype(int)
    x, y = e[torch.as_tensor(b == 0, device=dev)], e[torch.as_tensor(b == 1, device=dev)]
    if x.shape[0] == 0 or y.shape[0] == 0:
        raise ValueError("Both batches must have at least one sample.")
    with full_f32():
        return float(sinkhorn_divergence(x, y, blur=blur))
