"""Unsupervised Laplacian-score feature selection, computed on the model's device.

Counterpart of ``flexynesis_tpu/data/feature_selection.py`` (reference
feature_selection.py:11-268):

* ``laplacian_score`` builds the kNN graph (k=5, self included) from one
  pairwise-distance product and ``torch.topk`` on -d^2 (or, with ``t``, the
  dense heat-kernel affinity), then scores every feature as
  diag(F'LF) / diag(F'DF) with dense algebra, in float32;
  ``laplacian_score_sharded`` scores column blocks on the devices of a mesh;
* ``remove_redundant_features`` walks the candidates in ascending score order
  over the absolute correlation matrix and drops any feature correlated above
  the threshold with one already kept, then tops the selection back up from
  the dropped ones (best score first);
* ``filter_by_laplacian`` returns the selected names and the feature log.

The log is a list of row dicts (``feature``, ``laplacian_score`` and, where
redundancy pruning dropped features, ``correlated_with`` and
``correlation_score``, then ``selected``). Where pruning dropped features the
rows are sorted by feature name, as the JAX package's outer ``pd.merge``
sorts them; that order is also the order of the selected features.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.device import resolve_device


def _graph_operators(X: torch.Tensor, k: int, t: Optional[float]):
    """(S, L, D) of the samples' graph, from X (samples x features): W is
    the kNN connectivity (k neighbours, self included), or with ``t`` the
    dense heat kernel exp(-d^2 / t) (reference :29-31);
    S = D^-1/2 W D^-1/2 and D the row sums of W, self-loops included
    (reference :34); L = scipy's csgraph.laplacian(W, normed=True), which
    drops self-loops and normalises by in-degree."""
    n = X.shape[0]
    sq = (X * X).sum(dim=1)
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * (X @ X.T), min=0.0)
    if t is not None:
        W = torch.exp(-d2 / t)
    else:
        # sklearn kneighbors_graph(include_self=True): self is one of the k
        d2.fill_diagonal_(-1.0)
        nbr = torch.topk(-d2, k, dim=1).indices
        W = torch.zeros((n, n), dtype=X.dtype, device=X.device)
        W.scatter_(1, nbr, 1.0)
    D_vec = W.sum(dim=1)
    d_inv_sqrt = 1.0 / torch.sqrt(D_vec)
    S = W * d_inv_sqrt[:, None] * d_inv_sqrt[None, :]
    w_nd = W.clone()
    w_nd.fill_diagonal_(0.0)
    d_in = w_nd.sum(dim=0)
    dn = torch.sqrt(torch.where(d_in == 0, torch.ones_like(d_in), d_in))
    L = -w_nd / (dn[:, None] * dn[None, :])
    L.diagonal().copy_((d_in > 0).to(L.dtype))
    return S, L, D_vec


def _scores(X: torch.Tensor, S: torch.Tensor, L: torch.Tensor, D_vec: torch.Tensor):
    """diag(F'LF) / diag(F'DF) for each column of X, F = X - sum(S X) / n."""
    F = X - (S @ X).sum(dim=0) / X.shape[0]
    num = (F * (L @ F)).sum(dim=0)
    den = (F * (F * D_vec[:, None])).sum(dim=0)
    return num / den


def laplacian_score(X, k: int = 5, t: Optional[float] = None, device="auto") -> np.ndarray:
    """Laplacian score of each column of X (samples x features); lower is
    better. ``t`` scores on the heat-kernel affinity in place of the kNN
    graph. ``device`` as in ``utils.device.resolve_device``: the card unless
    ``cpu``."""
    X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=resolve_device(device))
    return _scores(X, *_graph_operators(X, k, t)).cpu().numpy()


def laplacian_score_sharded(X, k: int = 5, mesh=None, axis: str = "data",
                            device="auto") -> np.ndarray:
    """``laplacian_score`` with the feature axis split over the devices of
    ``mesh`` along ``axis`` (``parallel/mesh.Mesh``; JAX's shard_map,
    feature_selection.py:109-167). The features are padded to a multiple of
    the axis size and cut into one column block per device; the (n x n)
    operators S, L and D are built once, on the first device, and copied to
    each; every block is scored where it lies, and the scores are joined in
    order with the pad cut. No collective is needed. Without a mesh this is
    ``laplacian_score`` on ``device``."""
    if mesh is None:
        return laplacian_score(X, k, device=device)
    X = np.asarray(X, dtype=np.float32)
    devices = mesh.axis_devices(axis)
    f = X.shape[1]
    width = -(-f // len(devices))
    Xp = np.pad(X, ((0, 0), (0, width * len(devices) - f)))
    ops = _graph_operators(torch.from_numpy(X).to(devices[0]), k, None)
    scores = []
    for i, d in enumerate(devices):
        block = torch.from_numpy(Xp[:, i * width:(i + 1) * width]).to(d)
        scores.append(_scores(block, *(o.to(d) for o in ops)).cpu())
    return torch.cat(scores).numpy()[:f]


def correlation_matrix(X, device="auto") -> np.ndarray:
    """np.corrcoef(X.T): correlations between the columns of X, in float32."""
    X = torch.as_tensor(np.asarray(X, dtype=np.float32), device=resolve_device(device))
    Xc = X - X.mean(dim=0, keepdim=True)
    cov = Xc.T @ Xc
    std = torch.sqrt(torch.diagonal(cov))
    return (cov / (std[:, None] * std[None, :])).cpu().numpy()


def remove_redundant_features(X, names: Sequence[str], scores: np.ndarray,
                              threshold: float, topN: Optional[int] = None,
                              device="auto") -> Tuple[List[str], List[dict]]:
    """(kept names, redundancy rows) for the columns of X in ascending score
    order (reference feature_selection.py:51-154)."""
    corr = np.abs(correlation_matrix(X, device))
    scores = np.asarray(scores)
    selected: List[int] = []
    redundant: dict = {}
    for idx in np.argsort(scores):
        if selected:
            cors = corr[idx, selected]
            j = int(np.argmax(cors))
            if cors[j] > threshold:
                redundant[int(idx)] = (selected[j], float(cors[j]))
                continue
        selected.append(int(idx))
    if topN is not None and len(selected) < topN:
        for idx in sorted(redundant, key=lambda i: scores[i]):
            if len(selected) >= topN:
                break
            selected.append(idx)
            del redundant[idx]
    rows = [{"feature": names[i], "correlated_with": names[w], "correlation_score": c}
            for i, (w, c) in redundant.items()]
    return [names[i] for i in selected], rows


def filter_by_laplacian(X, names: Sequence[str], layer: str, k: int = 5,
                        t: Optional[float] = None, topN: int = 100,
                        correlation_threshold: float = 0.9,
                        device="auto") -> Tuple[List[str], List[dict]]:
    """(selected feature names in log order, feature log) for X (samples x
    features) with columns ``names`` (reference feature_selection.py:157-268);
    ``t`` as in ``laplacian_score``.

    When ``topN`` covers every feature nothing is scored: all features are
    kept and the log has no ``selected`` column."""
    names = list(names)
    print(f"[INFO] Laplacian feature selection for layer '{layer}': "
          f"{len(names)} features, {X.shape[0]} samples")
    if topN >= len(names):
        print("[INFO] Requested more features than present; skipping selection.")
        return names, [{"feature": f, "laplacian_score": None} for f in names]

    scores = laplacian_score(X, k, t, device)
    top = np.argsort(scores)[:topN]
    chosen = [names[i] for i in top]
    redundancy: List[dict] = []
    if correlation_threshold < 1:
        # redundancy is judged on the topN candidate block (as the reference)
        chosen, redundancy = remove_redundant_features(
            np.asarray(X)[:, top], chosen, scores[top], correlation_threshold,
            topN, device,
        )
        chosen = chosen[:topN]
    keep = set(chosen)
    log = [{"feature": f, "laplacian_score": s} for f, s in zip(names, scores)]
    if redundancy:
        extra = {r["feature"]: r for r in redundancy}
        for row in log:
            r = extra.get(row["feature"], {})
            row["correlated_with"] = r.get("correlated_with")
            row["correlation_score"] = r.get("correlation_score")
        log.sort(key=lambda row: row["feature"])
    for row in log:
        row["selected"] = row["feature"] in keep
    return [row["feature"] for row in log if row["selected"]], log
