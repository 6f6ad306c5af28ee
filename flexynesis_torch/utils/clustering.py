"""Unsupervised analysis helpers: k-means, Louvain, AMI/ARI and summaries.

Counterpart of ``flexynesis_tpu/utils/clustering.py`` without sklearn,
networkx or pandas; each result equals the JAX package's:

* ``KMeans`` is sklearn's ``KMeans(n_init="auto", random_state=42)``: the data
  centred, greedy k-means++ seeding with ``2 + int(log k)`` local trials and
  its draws from ``np.random.RandomState(seed)`` on the host, then Lloyd
  iterations on the device in the data's float dtype (float64 for float64 or
  integer input, as sklearn keeps float32) with sklearn's tolerance
  (``tol`` x the mean feature variance), its strict-convergence rule and its
  empty-cluster relocation (the farthest points, largest first).
* ``silhouette_score`` (euclidean) on the device.
* ``louvain_clustering``: the distance matrix and the kNN or threshold graph
  on the device; Louvain itself on the host, step for step as networkx 3.x's
  ``louvain_communities(weight="weight", seed=42)`` runs it (the node
  shuffles from ``random.Random(seed)``, insertion-ordered adjacency,
  resolution 1, threshold 1e-7), so the partitions are networkx's.
* ``adjusted_mutual_info_score`` (arithmetic mean, the expected mutual
  information through ``gammaln``) and ``adjusted_rand_score``, as sklearn.
"""

from __future__ import annotations

import math
import random
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch
from scipy.special import gammaln

from .csvio import Table
from .device import resolve_device

# ----------------------------------------------------------------- k-means


def _kmeans_plusplus(X: np.ndarray, n_clusters: int, x_squared_norms: np.ndarray,
                     random_state: np.random.RandomState) -> np.ndarray:
    """sklearn's greedy k-means++ (unit sample weights)."""
    n_samples = X.shape[0]
    sample_weight = np.ones(n_samples, dtype=X.dtype)
    n_local_trials = 2 + int(np.log(n_clusters))

    def sq_dist(Y):  # sklearn's _euclidean_distances(Y, X, squared=True)
        d = -2 * (Y @ X.T)
        d += np.einsum("ij,ij->i", Y, Y)[:, None]
        d += x_squared_norms[None, :]
        return np.maximum(d, 0, out=d)

    centers = np.empty((n_clusters, X.shape[1]), dtype=X.dtype)
    center_id = random_state.choice(n_samples, p=sample_weight / sample_weight.sum())
    centers[0] = X[center_id]
    closest_dist_sq = sq_dist(centers[0, np.newaxis])
    current_pot = closest_dist_sq @ sample_weight
    for c in range(1, n_clusters):
        rand_vals = random_state.uniform(size=n_local_trials) * current_pot
        candidate_ids = np.searchsorted(np.cumsum(sample_weight * closest_dist_sq), rand_vals)
        np.clip(candidate_ids, None, closest_dist_sq.size - 1, out=candidate_ids)
        distance_to_candidates = sq_dist(X[candidate_ids])
        np.minimum(closest_dist_sq, distance_to_candidates, out=distance_to_candidates)
        candidates_pot = distance_to_candidates @ sample_weight.reshape(-1, 1)
        best = np.argmin(candidates_pot)
        current_pot = candidates_pot[best]
        closest_dist_sq = distance_to_candidates[best]
        centers[c] = X[candidate_ids[best]]
    return centers


def _assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest center of each row by ||c||^2 - 2 x.c (the first on a tie)."""
    d = torch.addmm((centers * centers).sum(1).unsqueeze(0), X, centers.T, alpha=-2)
    return torch.argmin(d, dim=1)


MAX_ITER, TOL = 300, 1e-4  # sklearn's defaults


class KMeans:
    """sklearn's ``KMeans(n_clusters, n_init="auto", random_state)`` with the
    k-means++ init (one run) and Lloyd's algorithm."""

    def __init__(self, n_clusters: int, random_state: int = 42, device="auto"):
        self.n_clusters = n_clusters
        self.random_state = random_state
        self.device = device

    def fit(self, data):
        X = np.array(data, copy=True)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        n, k = X.shape[0], self.n_clusters
        if n < k:
            raise ValueError(f"n_samples={n} should be >= n_clusters={k}.")
        tol = float(np.mean(np.var(X, axis=0))) * TOL
        X_mean = X.mean(axis=0)
        X -= X_mean
        centers = _kmeans_plusplus(X, k, np.einsum("ij,ij->i", X, X),
                                   np.random.RandomState(self.random_state))
        dev = resolve_device(self.device)
        Xd = torch.as_tensor(X, device=dev)
        C = torch.as_tensor(centers, device=dev)
        labels_old = torch.full((n,), -1, dtype=torch.long, device=dev)
        strict = False
        for it in range(MAX_ITER):
            labels = _assign(Xd, C)
            C_new = torch.zeros_like(C).index_add_(0, labels, Xd)
            weight = torch.bincount(labels, minlength=k).to(Xd.dtype)
            empty = (weight == 0).nonzero(as_tuple=True)[0]
            if len(empty):  # sklearn: the farthest points become the empty centers
                far = torch.argsort(((Xd - C[labels]) ** 2).sum(1), descending=True,
                                    stable=True)[: len(empty)]
                for e, f in zip(empty.tolist(), far.tolist()):
                    old = int(labels[f])
                    C_new[old] -= Xd[f]
                    C_new[e] = Xd[f]
                    weight[e] = 1.0
                    weight[old] -= 1.0
            C_new = torch.where(weight.unsqueeze(1) > 0,
                                C_new * (1.0 / weight.clamp(min=1e-300)).unsqueeze(1), C_new)
            shift = torch.sqrt(((C_new - C) ** 2).sum(1))
            C = C_new
            if torch.equal(labels, labels_old):
                strict = True
                break
            if float((shift ** 2).sum()) <= tol:
                break
            labels_old = labels
        if not strict:
            labels = _assign(Xd, C)  # the labels of the final centers
        self.inertia_ = float(((Xd - C[labels]) ** 2).sum())
        self.labels_ = labels.cpu().numpy().astype(np.int32)
        self.cluster_centers_ = C.cpu().numpy() + X_mean
        self.n_iter_ = it + 1
        return self

    def fit_predict(self, data) -> np.ndarray:
        return self.fit(data).labels_


def k_means_clustering(data, k: int, device="auto"):
    """KMeans labels + fitted model."""
    km = KMeans(n_clusters=k, random_state=42, device=device)
    return km.fit_predict(data), km


def _pairwise_distances(X: torch.Tensor) -> torch.Tensor:
    """sklearn's ``euclidean_distances(X)``: sqrt(max(-2 X X' + |x|^2 + |y|^2, 0)),
    the diagonal 0."""
    xx = (X * X).sum(1)
    d = -2 * (X @ X.T)
    d += xx.unsqueeze(1)
    d += xx.unsqueeze(0)
    d.clamp_(min=0).fill_diagonal_(0)
    return torch.sqrt(d)


def silhouette_score(data, labels, device="auto") -> float:
    """Mean silhouette (euclidean); 0 for a sample alone in its cluster."""
    dev = resolve_device(device)
    X = np.asarray(data)
    X = torch.as_tensor(X if X.dtype in (np.float32, np.float64) else X.astype(np.float64),
                        device=dev)
    _, codes = np.unique(np.asarray(labels), return_inverse=True)
    freqs = np.bincount(codes)
    if not 1 < len(freqs) < len(codes):
        raise ValueError("Number of labels is %d. Valid values are 2 to n_samples - 1 "
                         "(inclusive)" % len(freqs))
    D = _pairwise_distances(X)
    lab = torch.as_tensor(codes, device=dev)
    sums = torch.zeros((len(codes), len(freqs)), dtype=D.dtype, device=dev)
    sums.index_add_(1, lab, D)  # each sample's distance sum to each cluster
    rows = torch.arange(len(codes), device=dev)
    intra = sums[rows, lab]
    sums[rows, lab] = float("inf")
    inter = (sums / torch.as_tensor(freqs, dtype=D.dtype, device=dev)).min(1).values
    intra = intra / torch.as_tensor(freqs - 1, dtype=D.dtype, device=dev)[lab]
    s = (inter - intra) / torch.maximum(intra, inter)
    return float(torch.nan_to_num(s).mean())


def get_optimal_clusters(data, min_k: int = 2, max_k: int = 10, device="auto"):
    """Silhouette-optimal k for KMeans; returns (labels, k, score table)."""
    data = np.asarray(data)
    scores, labels_by_k = [], {}
    for k in range(min_k, max_k + 1):
        labels = KMeans(n_clusters=k, random_state=42, device=device).fit_predict(data)
        scores.append((k, silhouette_score(data, labels, device=device)))
        labels_by_k[k] = labels
    table = Table([str(i) for i in range(len(scores))], ["k", "silhouette_score"],
                  np.asarray(scores, dtype=np.float64))
    optimal_k = int(scores[int(np.argmax([s for _, s in scores]))][0])
    return labels_by_k[optimal_k], optimal_k, table


# ----------------------------------------------------------------- Louvain


class Graph:
    """An undirected weighted graph with networkx's iteration orders:
    ``adj[u][v]`` is the weight, neighbours and nodes in insertion order;
    ``members[u]`` the original nodes a reduced node stands for."""

    def __init__(self):
        self.adj: Dict[int, Dict[int, float]] = {}
        self.members: Dict[int, set] = {}

    def add_node(self, u, members: Optional[set] = None) -> None:
        self.adj.setdefault(u, {})
        if members is not None:
            self.members[u] = members

    def add_edge(self, u, v, weight) -> None:
        self.add_node(u)
        self.add_node(v)
        self.adj[u][v] = weight
        self.adj[v][u] = weight

    def degree(self, u) -> float:
        nbrs = self.adj[u]
        return sum(nbrs.values()) + (u in nbrs and nbrs[u])

    def edges(self, nbunch=None):
        """(u, v, weight) of each edge once, as ``G.edges(nbunch, data=...)``."""
        seen = {}
        for n in (self.adj if nbunch is None else (n for n in nbunch if n in self.adj)):
            for nbr, w in self.adj[n].items():
                if nbr not in seen:
                    yield n, nbr, w
            seen[n] = 1

    def number_of_edges(self) -> int:
        return sum(1 for _ in self.edges())


def modularity(G: Graph, communities, resolution: float = 1) -> float:
    """networkx's ``modularity`` of an undirected graph, in its order of sums."""
    degree = {u: G.degree(u) for u in G.adj}
    deg_sum = sum(degree.values())
    m = deg_sum / 2
    norm = 1 / deg_sum ** 2

    def contribution(community):
        comm = set(community)
        L_c = sum(w for u, v, w in G.edges(comm) if v in comm)
        degree_sum = sum(degree[u] for u in comm)
        return L_c / m - resolution * degree_sum * degree_sum * norm

    return sum(map(contribution, communities))


def _one_level(G: Graph, m: float, partition: List[set], resolution: float,
               rng: random.Random):
    node2com = {u: i for i, u in enumerate(G.adj)}
    inner_partition = [{u} for u in G.adj]
    degrees = {u: G.degree(u) for u in G.adj}
    Stot = list(degrees.values())
    nbrs = {u: {v: w for v, w in G.adj[u].items() if v != u} for u in G.adj}
    rand_nodes = list(G.adj)
    rng.shuffle(rand_nodes)
    nb_moves = 1
    improvement = False
    while nb_moves > 0:
        nb_moves = 0
        for u in rand_nodes:
            best_mod = 0
            best_com = node2com[u]
            weights2com = defaultdict(float)
            for nbr, wt in nbrs[u].items():
                weights2com[node2com[nbr]] += wt
            degree = degrees[u]
            Stot[best_com] -= degree
            remove_cost = -weights2com[best_com] / m + resolution * (
                Stot[best_com] * degree) / (2 * m ** 2)
            for nbr_com, wt in weights2com.items():
                gain = remove_cost + wt / m - resolution * (Stot[nbr_com] * degree) / (2 * m ** 2)
                if gain > best_mod:
                    best_mod = gain
                    best_com = nbr_com
            Stot[best_com] += degree
            if best_com != node2com[u]:
                com = G.members.get(u, {u})
                partition[node2com[u]].difference_update(com)
                inner_partition[node2com[u]].remove(u)
                partition[best_com].update(com)
                inner_partition[best_com].add(u)
                improvement = True
                nb_moves += 1
                node2com[u] = best_com
    return list(filter(len, partition)), list(filter(len, inner_partition)), improvement


def _reduce(G: Graph, partition: List[set]) -> Graph:
    """networkx's ``_gen_graph``: one node per community, edge weights summed."""
    H = Graph()
    node2com = {}
    for i, part in enumerate(partition):
        nodes = set()
        for node in part:
            node2com[node] = i
            nodes.update(G.members.get(node, {node}))
        H.add_node(i, nodes)
    for u, v, w in G.edges():
        c1, c2 = node2com[u], node2com[v]
        H.add_edge(c1, c2, w + H.adj[c1].get(c2, 0))
    return H


def louvain_communities(G: Graph, resolution: float = 1, threshold: float = 1e-7,
                        seed: int = 42) -> List[set]:
    """networkx's ``louvain_communities(G, weight="weight", seed=seed)``."""
    rng = random.Random(seed)
    partition = [{u} for u in G.adj]
    if G.number_of_edges() == 0:
        return partition
    mod = modularity(G, partition, resolution)
    graph = Graph()
    for u in G.adj:
        graph.add_node(u)
    for u, v, w in G.edges():
        graph.add_edge(u, v, w)
    m = sum(graph.degree(u) for u in graph.adj) / 2
    partition, inner, improvement = _one_level(graph, m, partition, resolution, rng)
    improvement = True
    last = None
    while improvement:
        last = [s.copy() for s in partition]
        new_mod = modularity(graph, inner, resolution)
        if new_mod - mod <= threshold:
            break
        mod = new_mod
        graph = _reduce(graph, inner)
        partition, inner, improvement = _one_level(graph, m, partition, resolution, rng)
    return last


def louvain_clustering(X, threshold: Optional[float] = None, k: Optional[int] = None,
                       device="auto"):
    """Louvain communities on a distance graph: an edge (i, j), i < j, of
    weight 1 / distance where the distance is below ``threshold``, else where
    j is among i's k + 1 nearest (itself included); returns (labels, graph,
    partition)."""
    dev = resolve_device(device)
    X = np.asarray(X)
    Xd = torch.as_tensor(X if X.dtype in (np.float32, np.float64) else X.astype(np.float64),
                         device=dev)
    D = _pairwise_distances(Xd)
    n = D.shape[0]
    link = torch.zeros((n, n), dtype=torch.bool, device=dev)
    if threshold is not None:
        link |= D < threshold
    if k is not None:
        nbrs = torch.topk(D, min(k + 1, n), dim=1, largest=False).indices
        link |= torch.zeros_like(link).scatter_(1, nbrs, True)
    link = torch.triu(link, diagonal=1)
    i, j = link.nonzero(as_tuple=True)  # row-major: the order of JAX's double loop
    w = (1.0 / D[i, j].clamp(min=1e-12)).tolist()
    G = Graph()
    for u in range(n):
        G.add_node(u)
    for u, v, wt in zip(i.tolist(), j.tolist(), w):
        G.add_edge(u, v, wt)
    partition = {}
    for ci, nodes in enumerate(louvain_communities(G, seed=42)):
        for node in nodes:
            partition[node] = ci
    labels = np.full(n, np.nan)
    for node, c in partition.items():
        labels[node] = c
    return labels, G, partition


# -------------------------------------------------------------- AMI / ARI


def _contingency(labels_true, labels_pred) -> np.ndarray:
    _, a = np.unique(labels_true, return_inverse=True)
    _, b = np.unique(labels_pred, return_inverse=True)
    c = np.zeros((a.max() + 1, b.max() + 1), dtype=np.int64)
    np.add.at(c, (a, b), 1)
    return c


def _entropy(labels) -> float:
    pi = np.bincount(np.unique(labels, return_inverse=True)[1]).astype(np.float64)
    pi = pi[pi > 0]
    if pi.size == 1:
        return 0.0
    pi_sum = np.sum(pi)
    return float(-np.sum((pi / pi_sum) * (np.log(pi) - math.log(pi_sum))))


def _mutual_info(contingency: np.ndarray) -> float:
    nzx, nzy = np.nonzero(contingency)
    nz_val = contingency[nzx, nzy]
    total = contingency.sum()
    pi, pj = contingency.sum(axis=1), contingency.sum(axis=0)
    if pi.size == 1 or pj.size == 1:
        return 0.0
    log_nm = np.log(nz_val)
    nm = nz_val / total
    outer = pi.take(nzx).astype(np.int64) * pj.take(nzy).astype(np.int64)
    log_outer = -np.log(outer) + math.log(pi.sum()) + math.log(pj.sum())
    mi = nm * (log_nm - math.log(total)) + nm * log_outer
    mi = np.where(np.abs(mi) < np.finfo(mi.dtype).eps, 0.0, mi)
    return float(np.clip(mi.sum(), 0.0, None))


def _expected_mutual_info(contingency: np.ndarray, n_samples: int) -> float:
    """sklearn's ``expected_mutual_information``, the same sums in the same order."""
    a = contingency.sum(axis=1).astype(np.int64)
    b = contingency.sum(axis=0).astype(np.int64)
    if a.size == 1 or b.size == 1:
        return 0.0
    N = float(n_samples)
    nijs = np.arange(0, max(np.max(a), np.max(b)) + 1, dtype="float")
    nijs[0] = 1
    term1 = nijs / N
    log_a, log_b = np.log(a), np.log(b)
    log_Nnij = np.log(N) + np.log(nijs)
    gln_a, gln_b = gammaln(a + 1), gammaln(b + 1)
    gln_Na, gln_Nb = gammaln(N - a + 1), gammaln(N - b + 1)
    gln_Nnij = gammaln(nijs + 1) + gammaln(N + 1)
    emi = 0.0
    for i in range(len(a)):
        for j in range(len(b)):
            start = max(1, a[i] - n_samples + b[j])
            end = min(a[i], b[j]) + 1
            for nij in range(start, end):
                term2 = log_Nnij[nij] - log_a[i] - log_b[j]
                gln = (gln_a[i] + gln_b[j] + gln_Na[i] + gln_Nb[j] - gln_Nnij[nij]
                       - math.lgamma(a[i] - nij + 1) - math.lgamma(b[j] - nij + 1)
                       - math.lgamma(n_samples - a[i] - b[j] + nij + 1))
                emi += term1[nij] * term2 * math.exp(gln)
    return float(emi)


def adjusted_mutual_info_score(labels_true, labels_pred) -> float:
    """sklearn's AMI with the arithmetic mean of the entropies."""
    labels_true, labels_pred = np.asarray(labels_true), np.asarray(labels_pred)
    n_classes, n_clusters = len(np.unique(labels_true)), len(np.unique(labels_pred))
    if n_classes == n_clusters == 1 or n_classes == n_clusters == 0:
        return 1.0
    if n_classes == 1 or n_clusters == 1:
        return 0.0
    contingency = _contingency(labels_true, labels_pred)
    mi = _mutual_info(contingency)
    emi = _expected_mutual_info(contingency, len(labels_true))
    normalizer = float(np.mean([_entropy(labels_true), _entropy(labels_pred)]))
    eps = np.finfo("float64").eps
    denominator = normalizer - emi
    denominator = min(denominator, -eps) if denominator < 0 else max(denominator, eps)
    numerator = mi - emi
    numerator = min(numerator, -eps) if numerator < 0 else max(numerator, eps)
    return float(numerator / denominator)


def adjusted_rand_score(labels_true, labels_pred) -> float:
    """sklearn's ARI through the pair confusion matrix."""
    c = _contingency(np.asarray(labels_true), np.asarray(labels_pred))
    n = int(c.sum())
    n_c, n_k = c.sum(axis=1), c.sum(axis=0)
    sum_squares = int((c ** 2).sum())
    tp = sum_squares - n
    fp = int((c @ n_k).sum()) - sum_squares
    fn = int((c.T @ n_c).sum()) - sum_squares
    tn = n * n - fp - fn - sum_squares
    if fn == 0 and fp == 0:
        return 1.0
    return 2.0 * (tp * tn - fn * fp) / ((tp + fn) * (fn + tn) + (tp + fp) * (fp + tn))


def _label_strings(x) -> np.ndarray:
    """NaN/None as "missing", every label as its string (pandas' astype(str))."""
    return np.array(["missing" if v is None or (isinstance(v, float) and math.isnan(v))
                     else str(v) for v in np.asarray(x, dtype=object).tolist()])


def compute_ami_ari(labels1, labels2) -> dict:
    """Adjusted mutual information + adjusted Rand index (NaN-safe)."""
    l1, l2 = _label_strings(labels1), _label_strings(labels2)
    return {"ami": adjusted_mutual_info_score(l1, l2), "ari": adjusted_rand_score(l1, l2)}


# -------------------------------------------------------------- summaries


def scale_and_standardize_by_labels(data_matrix, labels):
    """Per-group standardization (batch-wise z-scoring)."""
    X = np.asarray(data_matrix, dtype=float).copy()
    labels = np.asarray(labels)
    for lb in dict.fromkeys(labels.tolist()):
        mask = labels == lb
        mu = X[mask].mean(axis=0)
        sd = X[mask].std(axis=0)
        sd[sd == 0] = 1.0
        X[mask] = (X[mask] - mu) / sd
    return X


def get_important_features(model, var: str, top: int = 20) -> List[dict]:
    """The rows of ``model.feature_importances[var]`` by descending importance,
    at most ``top`` per target class."""
    if var not in model.feature_importances:
        raise ValueError(
            f"No feature importances computed for variable '{var}'. "
            "Run compute_feature_importance first."
        )
    rows = sorted(model.feature_importances[var], key=lambda r: -r["importance"])
    taken: Dict[object, int] = defaultdict(int)
    out = []
    for r in rows:
        if taken[r["target_class"]] < top:
            taken[r["target_class"]] += 1
            out.append(r)
    return out


def subset_assays_by_features(dataset, features_dict) -> np.ndarray:
    """Concatenate selected features across assays."""
    blocks = []
    for layer, feats in features_dict.items():
        idx = [dataset.features[layer].index(f) for f in feats]
        blocks.append(np.asarray(dataset.dat[layer])[:, idx])
    return np.concatenate(blocks, axis=1)


def print_summary_stats(dataset) -> None:
    """Per-variable summary of the annotations."""
    for var, vtype in dataset.variable_types.items():
        arr = np.asarray(dataset.ann[var], dtype=float)
        if vtype == "categorical":
            mapping = dataset.label_mappings.get(var, {})
            vals, counts = np.unique(arr[~np.isnan(arr)], return_counts=True)
            named = {mapping.get(int(v), int(v)): int(c) for v, c in zip(vals, counts)}
            print(f"[INFO] {var} (categorical): {named}")
        else:
            print(
                f"[INFO] {var} (numerical): median={np.nanmedian(arr):.4g} "
                f"mean={np.nanmean(arr):.4g} "
                f"min={np.nanmin(arr):.4g} max={np.nanmax(arr):.4g}"
            )
