"""The port's co-expression network against flexynesis_tpu.coexpression.

Held: Spearman ranks equal to scipy's on count data with ties; the edge set
equal to JAX's for both methods at several block sizes (one block, G larger
than the block with a ragged last block); scores within 1e-5 (float32 Gram
products in two summation orders); the only pairs excepted from set
equality are those with ||r| - threshold| < 1e-6, which are counted and must
be few. The orientation rule (which of r_ij and r_ji is kept) is held
bitwise against a re-enactment of JAX's edge loop on the same products.
``--max_genes`` picks JAX's genes, and the CLI's file reads back through
``data.graph.read_user_graph``."""

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import rankdata

from flexynesis_torch import coexpression as pc
from flexynesis_torch.data.graph import read_user_graph
from flexynesis_tpu import coexpression as jc

SCORE_ATOL = 1e-5
EDGE_BAND = 1e-6


def _modules(seed, G=150, n=40, counts=False):
    """Genes in modules of 10 driven by one shared factor, plus noise genes."""
    rng = np.random.default_rng(seed)
    n_mod = G // 20
    factors = rng.normal(size=(n_mod, n))
    X = rng.normal(size=(G, n))
    for m in range(n_mod):
        w = rng.uniform(0.8, 1.5, 10)[:, None] * rng.choice([-1, 1], (10, 1))
        X[m * 10:(m + 1) * 10] = w * factors[m] + 0.45 * rng.normal(size=(10, n))
    if counts:
        X = rng.poisson(np.exp(1.0 + 0.6 * X))
    genes = [f"g{i}" for i in range(G)]
    return genes, X.astype(np.float64)


def test_ranks_equal_scipy_on_ties():
    _, X = _modules(0, counts=True)
    X[5, :7] = np.nan
    got = pc.rank_rows(torch.as_tensor(X)).numpy()
    want = np.apply_along_axis(rankdata, 1, X)
    assert (X[:, :, None] == X[:, None, :]).sum() > X.size  # ties present
    np.testing.assert_array_equal(got, want)


def _edges(net):
    return {(a, b) if a < b else (b, a): s
            for a, b, s in zip(net["GeneA"], net["GeneB"], net["Score"])}


def _pos(genes):
    where = {g: k for k, g in enumerate(genes)}
    return lambda e: tuple(sorted(e, key=where.get))


@pytest.mark.parametrize("method", ["spearman", "pearson"])
@pytest.mark.parametrize("block_size", [2048, 64, 50])
def test_edge_set_equals_jax(method, block_size):
    genes, X = _modules(1, counts=method == "spearman")
    expr = pd.DataFrame(X, index=genes)
    thr = 0.5
    want = jc.build_network(expr, method=method, correlation_threshold=thr, top_k=5,
                            block_size=block_size)
    got, _ = pc.build_network(genes, X, method=method, correlation_threshold=thr, top_k=5,
                              block_size=block_size, device="cpu")
    w = _edges({k: list(v) for k, v in want.items()})
    w = {_pos(genes)(k): v for k, v in w.items()}
    g = {_pos(genes)(k): v for k, v in _edges(got).items()}
    assert len(w) > 100
    differ = set(w) ^ set(g)
    near = [k for k in differ if abs(abs(w.get(k, g.get(k))) - thr) < EDGE_BAND]
    assert len(near) == len(differ), sorted(differ - set(near))[:5]
    assert len(near) <= 2
    common = set(w) & set(g)
    np.testing.assert_allclose([g[k] for k in sorted(common)], [w[k] for k in sorted(common)],
                               atol=SCORE_ATOL, rtol=0)
    keys = list(zip(got["GeneA"], got["GeneB"]))  # ascending gene positions
    pos = {x: k for k, x in enumerate(genes)}
    assert keys == sorted(keys, key=lambda e: (pos[e[0]], pos[e[1]]))
    assert all(pos[a] < pos[b] for a, b in keys)


def _jax_loop(corr_blocks, block_size, thr, top_k):
    """flexynesis_tpu/coexpression.py's edge loop over given block products."""
    edges = {}
    for start, corr in corr_blocks:
        idx = np.argsort(-np.abs(corr), axis=1, kind="stable")[:, : top_k + 1]
        for bi in range(corr.shape[0]):
            gi = start + bi
            for j in idx[bi]:
                j = int(j)
                if j == gi:
                    continue
                r = float(corr[bi, j])
                if abs(r) < thr:
                    continue
                key = (gi, j) if gi < j else (j, gi)
                if key not in edges or abs(edges[key]) < abs(r):
                    edges[key] = r
        for bi, j in np.argwhere(np.abs(corr) >= thr):
            gi = start + int(bi)
            if int(j) == gi:
                continue
            key = (gi, int(j)) if gi < j else (int(j), gi)
            edges.setdefault(key, float(corr[bi, j]))
    return edges


@pytest.mark.parametrize("block_size", [16, 40, 64])
def test_orientation_rule_matches_jax_loop(block_size):
    """Asymmetric products (rows of U against V) make r_ij and r_ji differ by
    far more than rounding, so the kept orientation shows."""
    rng = np.random.default_rng(3)
    G, thr, top_k = 40, 0.3, 3
    U = rng.normal(size=(G, 6)).astype(np.float32)
    V = (U + 0.5 * rng.normal(size=(G, 6))).astype(np.float32)
    U /= np.linalg.norm(U, axis=1, keepdims=True)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    Ut, Vt = torch.as_tensor(U), torch.as_tensor(V)
    parts, blocks = [], []
    for s in range(0, G, block_size):
        parts.append(pc._block_edges(Ut[s:s + block_size], Vt, s, thr, top_k))
        blocks.append((s, (Ut[s:s + block_size] @ Vt.T).numpy()))
    i, j, r, top = (torch.cat(p) for p in zip(*parts))
    a, b, score = pc._merge_orientations(i, j, r, top, G, block_size)
    want = _jax_loop(blocks, block_size, thr, top_k)
    got = {(int(x), int(y)): float(s) for x, y, s in zip(a, b, score)}
    assert got == want
    assert sum(abs(blocks[0][1][x, y] - blocks[0][1][y, x]) > 1e-3
               for x in range(min(block_size, G)) for y in range(x)) > 10


def test_max_genes_and_cli_round_trip(tmp_path):
    genes, X = _modules(2)
    X[7] *= 3.0  # a clearly most variable gene
    path = tmp_path / "gex.csv"
    pd.DataFrame(X, index=genes, columns=[f"s{k}" for k in range(X.shape[1])]).to_csv(path)
    expr = pd.read_csv(path, index_col=0)
    want = list(expr.var(axis=1).sort_values(ascending=False).index[:60])
    got_genes, _ = pc.read_expression(str(path), max_genes=60)
    assert got_genes == want
    out = tmp_path / "net.csv"
    pc.main(["--input", str(path), "--output", str(out), "--method", "pearson",
             "--correlation_threshold", "0.4", "--max_genes", "60", "--device", "cpu"])
    jax_out = tmp_path / "jax_net.csv"
    jc.main(["--input", str(path), "--output", str(jax_out), "--method", "pearson",
             "--correlation_threshold", "0.4", "--max_genes", "60"])
    g = read_user_graph(str(out))
    jx = pd.read_csv(jax_out)
    assert set(zip(g["protein1"], g["protein2"])) == \
        {tuple(sorted(e, key=want.index)) for e in zip(jx["GeneA"], jx["GeneB"])}
    assert len(g["protein1"]) > 20 and np.all(np.abs(g["weight"]) >= 0.4)


def test_card_is_the_default_device(monkeypatch):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    genes, X = _modules(0, G=20)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pc.build_network(genes, X)
