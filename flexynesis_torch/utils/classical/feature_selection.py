"""Feature screens as sklearn 1.9 computes them, without sklearn.

* ``mutual_info_classif`` / ``mutual_info_regression``: the KSG
  nearest-neighbour estimators (k = 3; Kraskov et al. for a continuous
  target, Ross for a discrete one) with sklearn's preprocessing: continuous
  columns scaled by their standard deviation (ddof 0) and jittered by
  ``1e-10 * max(1, mean |x|)`` standard normal draws from
  ``np.random.RandomState(random_state)`` (sklearn's ``check_random_state``:
  the global generator for None), the target likewise for regression.
  The neighbour radii and counts (Chebyshev distances over all pairs) run
  in torch on the caller's device, features in slices.
* ``select_from_model``: ``SelectFromModel(prefit=True).get_support()``'s
  default rule, importances at or above their mean.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import digamma

from ..device import resolve_device

PAIRS_PER_SLICE = 1 << 26  # features x samples x samples of one slice
N_NEIGHBORS = 3  # sklearn's default


def select_from_model(importances) -> np.ndarray:
    importances = np.asarray(importances, dtype=np.float64)
    return importances >= np.mean(importances)


def _rng(random_state):
    if random_state is None:
        return np.random.mtrand._rand
    if isinstance(random_state, np.random.RandomState):
        return random_state
    return np.random.RandomState(random_state)


def _scaled(X: np.ndarray, rng) -> np.ndarray:
    X = np.array(X, dtype=np.float64)
    std = X.std(axis=0)
    X /= np.where(std == 0, 1.0, std)
    means = np.maximum(1, np.mean(np.abs(X), axis=0))
    X += 1e-10 * means * rng.standard_normal(size=X.shape)
    return X


def _kth_radius(d: torch.Tensor, k) -> torch.Tensor:
    """nextafter(k-th smallest distance to another point, 0) per row of
    (S, n, n) distances whose diagonal is +inf; ``k`` an int or (n,) ints."""
    srt = torch.sort(d, dim=-1).values
    kk = torch.as_tensor(k, device=d.device).expand(d.shape[1]) - 1
    r = srt.gather(-1, kk.view(1, -1, 1).expand(d.shape[0], -1, 1)).squeeze(-1)
    return torch.nextafter(r, torch.zeros_like(r))


def _slices(F: int, n: int):
    step = max(1, PAIRS_PER_SLICE // max(n * n, 1))
    return [slice(s, min(F, s + step)) for s in range(0, F, step)]


def _mi_cd(X: torch.Tensor, y: np.ndarray, n_neighbors: int) -> np.ndarray:
    """Ross's estimator of each continuous column of X (n, F) against a
    discrete target y."""
    n = X.shape[0]
    labels, codes, counts = np.unique(y, return_inverse=True, return_counts=True)
    label_counts = counts[codes].astype(np.float64)
    k_all = np.minimum(n_neighbors, label_counts - 1)
    keep = label_counts > 1  # points with a unique label are left out
    dev = X.device
    same = torch.as_tensor(codes[:, None] == codes[None, :], device=dev)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    k_t = torch.as_tensor(np.maximum(k_all, 1).astype(np.int64), device=dev)
    keep_t = torch.as_tensor(keep, device=dev)
    out = []
    for sl in _slices(X.shape[1], n):
        c = X[:, sl].T  # (S, n)
        d = (c.unsqueeze(2) - c.unsqueeze(1)).abs()
        within = torch.where(same & ~eye, d, float("inf"))
        radius = _kth_radius(within, k_t)
        m_all = ((d <= radius.unsqueeze(2)) & keep_t).sum(2).to(torch.float64)
        out.append(m_all[:, keep_t].cpu().numpy())
    m_all = np.concatenate(out) if out else np.zeros((0, int(keep.sum())))
    n_kept = int(keep.sum())
    mi = (digamma(n_kept) + np.mean(digamma(k_all[keep])) - np.mean(digamma(label_counts[keep]))
          - np.mean(digamma(m_all), axis=1))
    return np.maximum(0, mi)


def _mi_cc(X: torch.Tensor, y: torch.Tensor, n_neighbors: int) -> np.ndarray:
    """Kraskov's estimator of each continuous column of X against a
    continuous target y, Chebyshev distances in the joint space."""
    n = X.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=X.device)
    dy = (y.unsqueeze(1) - y.unsqueeze(0)).abs()
    out = []
    for sl in _slices(X.shape[1], n):
        c = X[:, sl].T
        dx = (c.unsqueeze(2) - c.unsqueeze(1)).abs()
        joint = torch.where(eye, float("inf"), torch.maximum(dx, dy))
        radius = _kth_radius(joint, n_neighbors).unsqueeze(2)
        nx = (dx <= radius).sum(2).to(torch.float64) - 1.0
        ny = (dy <= radius).sum(2).to(torch.float64) - 1.0
        out.append(torch.stack([nx, ny]).cpu().numpy())
    counts = np.concatenate(out, axis=1)
    mi = (digamma(n) + digamma(n_neighbors) - np.mean(digamma(counts[0] + 1), axis=1)
          - np.mean(digamma(counts[1] + 1), axis=1))
    return np.maximum(0, mi)


def mutual_info_classif(X, y, random_state=None, device="auto") -> np.ndarray:
    rng = _rng(random_state)
    Xd = torch.as_tensor(_scaled(X, rng), device=resolve_device(device))
    return _mi_cd(Xd, np.asarray(y), N_NEIGHBORS)


def mutual_info_regression(X, y, random_state=None, device="auto") -> np.ndarray:
    rng = _rng(random_state)
    Xs = _scaled(X, rng)
    y = np.array(y, dtype=np.float64)
    std = y.std()
    y = y / (std if std != 0 else 1.0)
    y += 1e-10 * np.maximum(1, np.mean(np.abs(y))) * rng.standard_normal(size=len(y))
    dev = resolve_device(device)
    return _mi_cc(torch.as_tensor(Xs, device=dev), torch.as_tensor(y, device=dev), N_NEIGHBORS)
