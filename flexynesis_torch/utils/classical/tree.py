"""CART trees grown level by level, many at once, in torch.

``grow`` fits a batch of T trees that share X (n, F) but each have their own
sample weights (0 leaves a sample out: a bootstrap draw, or a fold) and
targets, the way sklearn 1.9's ``BestSplitter`` and ``DepthFirstTreeBuilder``
fit one:

* each feature is sorted once; every tree keeps, per feature, its samples
  laid out by (node, value), and after each level a stable partition
  (counts and cumulative sums, no sort) moves each node's samples into its
  children's segments; each node's prefix sums come from one cumulative
  sum per feature;
* a split sits between two neighbouring samples whose float32 values differ
  by more than 1e-7, at the float64 midpoint ``a/2 + b/2`` (``a`` where that
  rounds to ``b``); ``min_samples_leaf`` counts samples on each side;
* the criterion is squared error (proxy ``sl²/wl + sr²/wr``) or gini (proxy
  ``-wl·gini_l - wr·gini_r``); the best proxy wins, ties to the lowest
  feature index, then the lowest position (sklearn breaks ties by its
  random feature order); proxies within ``TIE_RTOL`` of a node's best tie,
  so an equal partition reached through two features is not decided by
  the device's order of summation (a parallel scan on the card, a loop on
  the CPU);
* a node is a leaf at ``max_depth``, below ``min_samples_split`` or
  2 x ``min_samples_leaf`` samples, at impurity <= float64 eps, or without a
  valid split;
* ``max_features`` below F draws a feature subset per node from a
  counter-based hash of (tree seed, depth, node, feature), skipping features
  constant in the node, so a draw is the same on every device, and the same
  for a tree whatever ``max_depth`` or the number of trees.

Nodes of a level are numbered per tree in the order of their parents, so a
tree grown deeper holds the shallower tree as its top levels; ``predict``
takes a depth cap.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

EPSILON = float(np.finfo(np.float64).eps)
FEATURE_THRESHOLD = 1e-7
TIE_RTOL = 1e-10  # relative; summation order moves a float64 proxy by ~1e-15
BUDGET = 1 << 27  # (trees x features x samples) x (classes + 6) of one work slice: ~5 GB
_M32 = 0xFFFFFFFF


@dataclass
class Level:
    """The nodes of one depth of T trees: ``feature`` (T, N) (-1 at a leaf or
    an unused slot), ``threshold`` (T, N) float64, ``value`` (T, N, V) float64
    and ``child`` (T, N), the left child's index in the next level (the right
    one's is ``child + 1``); ``weight`` (T, N) the node's summed sample
    weight and ``impurity`` (T, N) its gini or squared error, float64 (the
    feature importances' terms)."""

    feature: torch.Tensor
    threshold: torch.Tensor
    value: torch.Tensor
    child: torch.Tensor
    weight: torch.Tensor
    impurity: torch.Tensor


def _hash32(x: torch.Tensor) -> torch.Tensor:
    for _ in range(2):
        x = ((x >> 16) ^ x) & _M32
        x = (x * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def _feature_keys(seeds: torch.Tensor, depth: int, n_nodes: int, F: int) -> torch.Tensor:
    """(T, N, F) uniform keys in [0, 1) of (tree seed, depth, node, feature)."""
    dev = seeds.device
    x = (seeds.view(-1, 1, 1) & _M32) * 0x2545F49 + depth * 0x3C6EF35
    x = (x & _M32) + torch.arange(n_nodes, device=dev).view(1, -1, 1) * 0x1B873593
    x = _hash32(x & _M32)
    x = _hash32((x + torch.arange(F, device=dev).view(1, 1, -1) * 0x68E31DA4) & _M32)
    return x.to(torch.float64) / 2.0 ** 32


def _segment_sums(values: torch.Tensor, node: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Per-node sums of values (T, n, ...) over the samples of node (T, n)
    (-1 = none)."""
    T = node.shape[0]
    out = values.new_zeros((T, n_nodes + 1) + values.shape[2:])
    idx = torch.where(node < 0, n_nodes, node)
    idx = idx.view(T, -1, *([1] * (values.dim() - 2))).expand_as(values)
    return out.scatter_add_(1, idx, values)[:, :n_nodes]


def grow(X: torch.Tensor, order: torch.Tensor, y: torch.Tensor, w: torch.Tensor, *,
         n_classes: int = 0, max_depth=None, min_samples_split: int = 2,
         min_samples_leaf: int = 1, max_features: Optional[int] = None,
         seeds: Optional[torch.Tensor] = None):
    """Grow T trees; returns (levels, leaf) where ``leaf`` (T, n) is each
    sample's leaf as ``level_offset + node`` over the levels' concatenated
    nodes (-1 for a sample of weight 0).

    X (n, F) float32, ``order`` (F, n) each feature's ascending stable order,
    y (T, n) float64 targets (class codes 0..C-1 with ``n_classes`` = C for
    gini), w (T, n) float64 sample weights; ``max_depth`` None, an int, or
    one per tree (a sequence, None for unlimited)."""
    T, n = w.shape
    F = X.shape[1]
    dev = X.device
    gini = n_classes > 0
    Xt = X.t().contiguous()
    node = torch.where(w > 0, 0, -1)
    leaf = torch.full((T, n), -1, dtype=torch.long, device=dev)
    onehot = (torch.nn.functional.one_hot(y.long().clamp(min=0), n_classes).to(torch.float64)
              if gini else None)
    if max_depth is None or isinstance(max_depth, int):
        max_depth = [max_depth] * T
    depth_cap = torch.tensor([n if d is None else d for d in max_depth], device=dev)
    levels: List[Level] = []
    offset, n_nodes, depth = 0, 1, 0
    step = max(1, BUDGET // (F * n * (max(n_classes, 1) + 6)))  # trees per work slice
    slices = [slice(t0, min(T, t0 + step)) for t0 in range(0, T, step)]
    # each tree's samples per feature, by (node, value), samples out of every
    # node last: the presorted order partitioned into the root's segment
    layout = order.to(torch.int32).unsqueeze(0).expand(T, F, n).contiguous()
    root = torch.zeros((T, 2), dtype=torch.long, device=dev)  # one segment: the root's
    node_key = torch.where(node < 0, 1, 0)
    for sl in slices:
        layout[sl] = _regroup(layout[sl], root[sl], torch.zeros_like(node_key[sl]),
                              node_key[sl], 1)
    while n_nodes:
        # per-node totals
        cnt = _segment_sums(torch.ones_like(w) * (node >= 0), node, n_nodes)
        W = _segment_sums(w, node, n_nodes)
        if gini:
            stats = _segment_sums(w.unsqueeze(-1) * onehot, node, n_nodes)  # (T, N, C)
            safe = torch.where(W > 0, W, 1.0).unsqueeze(-1)
            value = stats / safe
            impurity = 1.0 - (value ** 2).sum(-1)
        else:
            s1 = _segment_sums(w * y, node, n_nodes)
            s2 = _segment_sums(w * y * y, node, n_nodes)
            safe = torch.where(W > 0, W, 1.0)
            value = (s1 / safe).unsqueeze(-1)
            impurity = s2 / safe - (s1 / safe) ** 2
        exists = cnt > 0
        splittable = exists & (cnt >= min_samples_split) & (cnt >= 2 * min_samples_leaf) & (
            impurity > EPSILON) & (depth < depth_cap).unsqueeze(1)
        feat = torch.full((T, n_nodes), -1, dtype=torch.long, device=dev)
        thr = torch.zeros((T, n_nodes), dtype=torch.float64, device=dev)
        counts = torch.zeros((T, n_nodes + 1), dtype=torch.long, device=dev)
        counts[:, :n_nodes] = cnt.long()
        starts = torch.cumsum(counts, 1) - counts  # each node's first position
        if splittable.any():
            parts = [_best_slice(Xt, layout[sl], y[sl], w[sl], node[sl], n_nodes, starts[sl],
                                 n_classes, min_samples_leaf, max_features,
                                 None if seeds is None else seeds[sl], depth, splittable[sl])
                     for sl in slices]
            feat = torch.cat([f for f, _ in parts])
            thr = torch.cat([t for _, t in parts])
        is_split = feat >= 0
        rank = torch.cumsum(is_split.long(), 1) - 1
        child = torch.where(is_split, 2 * rank, -1)
        levels.append(Level(feat, thr, value, child, W, impurity))
        # route the samples
        alive = node >= 0
        nd = node.clamp(min=0)
        f_s = feat.gather(1, nd)
        goes_on = alive & (f_s >= 0)
        ended = alive & ~goes_on
        leaf = torch.where(ended, offset + nd, leaf)
        x = X.unsqueeze(0).expand(T, n, F).gather(2, f_s.clamp(min=0).unsqueeze(-1))
        left = x.squeeze(-1).to(torch.float64) <= thr.gather(1, nd)
        nxt = child.gather(1, nd) + (~left).long()
        new_nodes = 2 * int(is_split.sum(1).max()) if is_split.any() else 0
        if new_nodes:
            old = torch.where(node < 0, n_nodes, node)
            node = torch.where(goes_on, nxt, -1)
            new_key = torch.where(node < 0, new_nodes, node)
            for sl in slices:
                layout[sl] = _regroup(layout[sl], starts[sl], old[sl], new_key[sl], new_nodes)
        offset += n_nodes
        n_nodes = new_nodes
        depth += 1
    return levels, leaf


def _regroup(layout, starts, old_key, new_key, n_keys):
    """The layout (T, F, n) of samples by (old node, value) moved to (new
    node, value): a stable partition of each old node's segment into its
    children's (new keys 2r and 2r + 1 of one parent), samples of key
    ``n_keys`` (out of every node) last. ``starts`` (T, N_old + 1) are the
    old segments' first positions."""
    T, F, n = layout.shape
    il = layout.long()
    kn = new_key.gather(1, il.view(T, -1)).view(T, F, n)
    seg = starts.gather(1, old_key.gather(1, il.view(T, -1))).view(T, F, n)
    out_ = kn == n_keys
    left = ~out_ & (kn % 2 == 0)
    right = ~out_ & (kn % 2 == 1)

    def before(mask):  # same-key samples ahead in the row, from the segment start
        c = torch.cumsum(mask.to(torch.int32), 2) - mask.to(torch.int32)
        return c

    cl, cr = before(left), before(right)
    within = torch.where(left, cl - cl.gather(2, seg), torch.where(right, cr - cr.gather(2, seg),
                                                                   before(out_)))
    counts = torch.zeros((T, n_keys + 1), dtype=torch.long, device=layout.device)
    counts.scatter_add_(1, new_key, torch.ones_like(new_key))
    first = torch.cumsum(counts, 1) - counts
    pos = first.gather(1, kn.view(T, -1)).view(T, F, n) + within
    return torch.empty_like(layout).scatter_(2, pos, layout)


def _best_slice(Xt, layout, y, w, node, N, start, n_classes, min_leaf, max_features, seeds,
                depth, splittable):
    """(feature, threshold) of each node's best split of T trees, feature -1
    where none; ``layout`` (T, F, n) the samples by (node, value), ``start``
    (T, N + 1) each node's first position (the same in every feature)."""
    T, n = w.shape
    F = Xt.shape[0]
    dev = Xt.device
    gini = n_classes > 0
    idx = layout.long()
    ks = torch.where(node < 0, N, node).gather(1, idx.view(T, -1)).view(T, F, n)
    xs = Xt.unsqueeze(0).expand(T, F, n).gather(2, idx)
    ws = w.gather(1, idx.view(T, -1)).view(T, F, n)
    node_start = start.gather(1, ks.view(T, -1)).view(T, F, n)
    node_end = start.gather(1, (ks + 1).clamp(max=N).view(T, -1)).view(T, F, n)
    # each node's first and last position, the same in every feature's column
    first_pos = start[:, :N].unsqueeze(1).expand(T, F, N)
    last_pos = (start[:, 1:] - 1).clamp(min=0).unsqueeze(1).expand(T, F, N)
    kk = ks.clamp(max=N - 1)

    def split_sums(ch):
        """(left, right) sums of a channel (T, F, n) at every position: the
        left side holds the node's positions up to and including it."""
        c = torch.cumsum(ch, 2)
        before = torch.where(first_pos > 0, c.gather(2, (first_pos - 1).clamp(min=0)), 0.0)
        total = c.gather(2, last_pos) - before
        left = c - before.gather(2, kk)
        return left, total.gather(2, kk) - left

    wl, wr = split_sums(ws)
    pos = torch.arange(n, device=dev).view(1, 1, n)
    n_left = pos - node_start + 1
    n_right = node_end - pos - 1
    nxt = torch.cat([xs[:, :, 1:], xs[:, :, -1:]], dim=2)
    same = torch.cat([ks[:, :, 1:] == ks[:, :, :-1],
                      torch.zeros((T, F, 1), dtype=torch.bool, device=dev)], dim=2)
    valid = (same & (ks < N) & (nxt > xs + FEATURE_THRESHOLD) & (n_left >= min_leaf)
             & (n_right >= min_leaf))
    ok_node = torch.cat([splittable, torch.zeros((T, 1), dtype=torch.bool, device=dev)], 1)
    valid &= ok_node.gather(1, ks.view(T, -1)).view(T, F, n)
    if max_features is not None and max_features < F:
        # a feature is constant in a node when its last value is within
        # 1e-7 of its first
        first = xs.gather(2, node_start.clamp(max=n - 1))
        last = xs.gather(2, (node_end - 1).clamp(min=0))
        lo = torch.full((T, N + 1, F), float("inf"), dtype=xs.dtype, device=dev)
        hi = torch.full((T, N + 1, F), float("-inf"), dtype=xs.dtype, device=dev)
        kidx = ks.transpose(1, 2).reshape(T, n, F)
        lo.scatter_reduce_(1, kidx, first.transpose(1, 2), "amin")
        hi.scatter_reduce_(1, kidx, last.transpose(1, 2), "amax")
        const = (hi <= lo + FEATURE_THRESHOLD)[:, :N]
        r = _feature_keys(seeds, depth, N, F).masked_fill(const, float("inf"))
        kth = torch.kthvalue(r, min(max_features, F), dim=2, keepdim=True).values
        allowed = (r <= kth) & ~const  # (T, N, F)
        allowed = torch.cat([allowed, torch.zeros((T, 1, F), dtype=torch.bool, device=dev)], 1)
        valid &= allowed.gather(1, kidx).transpose(1, 2)
    if gini:
        codes = y.gather(1, idx.view(T, -1)).view(T, F, n)
        gl, gr = torch.ones_like(wl), torch.ones_like(wr)
        for c in range(n_classes):
            sl, sr = split_sums(ws * (codes == c))
            gl -= (sl / wl.clamp(min=1e-300)) ** 2
            gr -= (sr / wr.clamp(min=1e-300)) ** 2
        proxy = -wr * gr - wl * gl
    else:
        sl, sr = split_sums(ws * y.gather(1, idx.view(T, -1)).view(T, F, n))
        proxy = sl * sl / wl.clamp(min=1e-300) + sr * sr / wr.clamp(min=1e-300)
    proxy = torch.where(valid, proxy, float("-inf"))
    flat = proxy.view(T, -1)
    kflat = ks.view(T, -1)
    best = torch.full((T, N + 1), float("-inf"), dtype=flat.dtype, device=dev)
    best.scatter_reduce_(1, kflat, flat, "amax")
    top = best.gather(1, kflat)
    at_best = (flat >= top - TIE_RTOL * top.abs()) & valid.view(T, -1)
    big = F * n
    where = torch.where(at_best, torch.arange(big, device=dev).view(1, -1), big)
    first_at = torch.full((T, N + 1), big, dtype=torch.long, device=dev)
    first_at.scatter_reduce_(1, kflat, where, "amin")
    first_at = first_at[:, :N]
    found = first_at < big
    p = first_at.clamp(max=big - 1)
    feat = torch.where(found, p // n, -1)
    a = xs.view(T, -1).gather(1, p).to(torch.float64)
    b = nxt.view(T, -1).gather(1, p).to(torch.float64)
    thr = a / 2.0 + b / 2.0
    thr = torch.where((thr == b) | torch.isinf(thr), a, thr)
    return feat, torch.where(found, thr, 0.0)


def predict(levels: List[Level], X: torch.Tensor, max_depth: Optional[int] = None):
    """(T, m, V) node values reached by each sample of X (m, F) in each tree,
    stopping at a leaf or at depth ``max_depth``."""
    T = levels[0].feature.shape[0]
    m, F = X.shape
    node = torch.zeros((T, m), dtype=torch.long, device=X.device)
    Xe = X.unsqueeze(0).expand(T, m, F)
    out, done = None, torch.zeros((T, m), dtype=torch.bool, device=X.device)
    for depth, lv in enumerate(levels):
        value = lv.value.gather(1, node.unsqueeze(-1).expand(-1, -1, lv.value.shape[-1]))
        out = value if out is None else torch.where(done.unsqueeze(-1), out, value)
        if max_depth is not None and depth >= max_depth:
            break
        done = done | (lv.feature.gather(1, node) < 0)
        if bool(done.all()):
            break
        f = lv.feature.gather(1, node).clamp(min=0)
        x = Xe.gather(2, f.unsqueeze(-1)).squeeze(-1).to(torch.float64)
        go = lv.child.gather(1, node) + (x > lv.threshold.gather(1, node)).long()
        node = torch.where(done, 0, go)
    return out


def feature_importances(levels: List[Level], n_features: int) -> torch.Tensor:
    """(T, F) impurity-based importances of each tree, as sklearn's
    ``tree_.compute_feature_importances()``: each split's weighted impurity
    decrease ``w·i - w_l·i_l - w_r·i_r`` summed per feature, normalised to
    sum 1 (all 0 for a tree without a split)."""
    T = levels[0].feature.shape[0]
    out = torch.zeros((T, n_features + 1), dtype=torch.float64, device=levels[0].feature.device)
    for lv, nxt in zip(levels[:-1], levels[1:]):
        split = lv.feature >= 0
        left = lv.child.clamp(min=0)
        dec = lv.weight * lv.impurity \
            - (nxt.weight * nxt.impurity).gather(1, left) \
            - (nxt.weight * nxt.impurity).gather(1, left + 1)
        out.scatter_add_(1, torch.where(split, lv.feature, n_features),
                         torch.where(split, dec, 0.0))
    out = out[:, :n_features]
    total = out.sum(1, keepdim=True)
    return torch.where(total > 0, out / torch.where(total > 0, total, 1.0), 0.0)


def presort(X: torch.Tensor) -> torch.Tensor:
    """(F, n) each feature's ascending stable order of the samples."""
    return torch.sort(X.t(), dim=1, stable=True).indices
