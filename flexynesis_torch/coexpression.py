"""Co-expression network generator CLI.

Counterpart of ``flexynesis_tpu/coexpression.py``: a gene-gene graph from a
genes x samples expression CSV by Spearman or Pearson correlation, written as
a GeneA,GeneB,Score CSV that ``--user_graph`` (``data/graph.read_user_graph``)
reads. On the caller's device (the card unless ``--device cpu``):

* Spearman ranks are scipy's ``rankdata(method="average")`` per gene: each
  row sorted, each tie group given the mean of its positions (equal to
  scipy's, not merely close: the means are half-integers);
* rows are standardised, and the correlation is one float32 Gram product per
  block of ``block_size`` genes against all genes, TF32 off;
* the edges are gathered on the device.

The edge set is the JAX package's: every unordered pair i != j with
|r| >= ``correlation_threshold`` (a top-k partner below the threshold is
skipped; every pair above it is kept, top-k or not). ``top_k`` decides only
which of the two orientations' scores (r_ij from row i's block, r_ji from row
j's, equal up to rounding) is kept, by JAX's rule: the score of the
orientation seen first, replaced by the other where that gene lists the pair
among its top-k partners with a larger |r| (within one block, a top-k hit is
seen before any other edge). Edges are written in ascending (GeneA, GeneB)
gene position, GeneA before GeneB.

Usage: python -m flexynesis_torch.coexpression --input gex.csv --output net.csv
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from .utils.device import full_f32, resolve_device


def rank_rows(X: torch.Tensor) -> torch.Tensor:
    """Average ranks (1-based) of each row, as ``scipy.stats.rankdata``; a row
    holding NaN ranks as all NaN (scipy's ``nan_policy="propagate"``)."""
    n = X.shape[1]
    vals, idx = torch.sort(X, dim=1, stable=True)
    pos = torch.arange(n, device=X.device).expand_as(idx)
    first = torch.ones_like(vals, dtype=torch.bool)
    first[:, 1:] = vals[:, 1:] != vals[:, :-1]
    last = torch.ones_like(first)
    last[:, :-1] = first[:, 1:]
    start = torch.cummax(torch.where(first, pos, 0), dim=1).values
    end = torch.cummin(torch.where(last, pos, n).flip(1), dim=1).values.flip(1)
    avg = (start + end).to(torch.float64) / 2 + 1
    ranks = torch.empty_like(avg).scatter_(1, idx, avg)
    nan_rows = torch.isnan(X).any(dim=1)
    return torch.where(nan_rows.unsqueeze(1), float("nan"), ranks)


def _standardize(X: torch.Tensor) -> torch.Tensor:
    X = X - X.mean(dim=1, keepdim=True)
    norm = torch.linalg.vector_norm(X, dim=1, keepdim=True)
    return X / torch.where(norm == 0, 1.0, norm)


def _block_edges(rows: torch.Tensor, full: torch.Tensor, start: int, threshold: float,
                 top_k: int):
    """(i, j, r_ij, j among i's top-k) of every pair of this block's rows with
    |r_ij| >= threshold, i != j."""
    corr = rows @ full.T
    acorr = corr.abs()
    B, G = corr.shape
    top = torch.topk(acorr, min(top_k + 1, G), dim=1).indices  # includes self
    in_top = torch.zeros_like(acorr, dtype=torch.bool).scatter_(1, top, True)
    strong = acorr >= threshold
    bi = torch.arange(B, device=rows.device)
    strong[bi, bi + start] = False
    r, j = strong.nonzero(as_tuple=True)
    return r + start, j, corr[r, j], in_top[r, j]


def _merge_orientations(i, j, r, top, G: int, block_size: int):
    """One (a < b, score) per unordered pair from its directed records, with
    JAX's rule for which orientation's score is kept; ascending (a, b)."""
    a, b = torch.minimum(i, j), torch.maximum(i, j)
    fwd = i < j  # r_ab, computed in row a's block
    order = torch.argsort((a * G + b) * 2 + (~fwd).long())
    a, b, r, top, fwd = a[order], b[order], r[order], top[order], fwd[order]
    key = a * G + b
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    lead = first.nonzero(as_tuple=True)[0]  # each pair's first record
    nxt = (lead + 1).clamp(max=len(key) - 1)
    both = (nxt != lead) & ~first[nxt]  # two records: r_ab, then r_ba
    A, Bn = a[lead], b[lead]
    r_ab, r_ba, in_a, in_b = r[lead], r[nxt], top[lead], top[nxt]
    same_block = (A // block_size) == (Bn // block_size)
    # r_ab unless b's top-k hit is larger; in one block without a's top-k hit,
    # b's hit is seen first
    score = torch.where(in_b & (r_ba.abs() > r_ab.abs()), r_ba, r_ab)
    score = torch.where(same_block & ~in_a & in_b, r_ba, score)
    return A, Bn, torch.where(both, score, r_ab)  # one record: its own score


def build_network(genes: List[str], X, method: str = "spearman",
                  correlation_threshold: float = 0.5, top_k: int = 5,
                  block_size: int = 2048,
                  device="auto") -> Tuple[Dict[str, list], Dict[str, float]]:
    """The edge list {GeneA, GeneB, Score} of a genes x samples matrix, and
    the seconds of its parts (ranking, gram_and_selection, gather), each
    ending in a device synchronisation."""
    dev = resolve_device(device)
    if method not in ("spearman", "pearson"):
        raise ValueError("method must be 'spearman' or 'pearson'")
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    timings = {}
    t0 = time.perf_counter()
    Xd = torch.as_tensor(np.asarray(X, dtype=np.float32), device=dev)
    if method == "spearman":
        Xd = rank_rows(Xd).to(torch.float32)
    Xd = _standardize(Xd)
    sync()
    timings["ranking"] = time.perf_counter() - t0
    G = Xd.shape[0]
    t0 = time.perf_counter()
    with full_f32():
        parts = [_block_edges(Xd[s:s + block_size], Xd, s, correlation_threshold, top_k)
                 for s in range(0, G, block_size)]
        sync()
    timings["gram_and_selection"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    i, j, r, top = (torch.cat(p) for p in zip(*parts))
    a, b, score = _merge_orientations(i, j, r, top, G, block_size)
    a, b, score = a.cpu().numpy(), b.cpu().numpy(), score.cpu().numpy()
    timings["gather"] = time.perf_counter() - t0
    print(f"[INFO] Correlation sweep over {G} genes took "
          f"{timings['ranking'] + timings['gram_and_selection'] + timings['gather']:.2f}s; "
          f"{len(score)} edges")
    net = {"GeneA": [genes[k] for k in a], "GeneB": [genes[k] for k in b],
           "Score": score.astype(np.float64)}
    return net, timings


def write_network(net: Dict[str, list], path: str) -> None:
    """``pd.DataFrame(net).to_csv(path, index=False)``: scores in their
    shortest round-trip form, a gene name quoted where it holds a comma, a
    quote or a line break."""
    def quoted(g: str) -> str:
        return '"' + g.replace('"', '""') + '"' if any(ch in g for ch in ',"\r\n') else g

    names = {g: quoted(g) for g in set(net["GeneA"]) | set(net["GeneB"])}
    with open(path, "w", newline="") as fh:
        fh.write("GeneA,GeneB,Score\n")
        fh.write("".join(f"{names[a]},{names[b]},{s!r}\n" for a, b, s in
                         zip(net["GeneA"], net["GeneB"], net["Score"].tolist())))


def read_expression(path: str, max_genes: int = 0):
    """(genes, float32 matrix) of a genes x samples CSV; with ``max_genes``
    below the gene count, the most variable genes (sample variance in
    float64, ddof 1, descending, stable)."""
    from .data.fastcsv import read_matrix_csv

    genes, _, mat = read_matrix_csv(path)
    if max_genes and len(genes) > max_genes:
        var = np.nanvar(mat.astype(np.float64), axis=1, ddof=1)
        keep = np.argsort(-var, kind="stable")[:max_genes]
        genes, mat = [genes[k] for k in keep], mat[keep]
        print(f"[INFO] Restricted to top {max_genes} most-variable genes")
    return genes, mat


def _generate(input_csv: str, output_csv: str, method: str, correlation_threshold: float,
              top_k: int, max_genes: int, device):
    """(network, seconds of read, ranking, gram_and_selection, gather and write)."""
    t0 = time.perf_counter()
    genes, X = read_expression(input_csv, max_genes)
    timings = {"read": time.perf_counter() - t0}
    net, parts = build_network(genes, X, method=method,
                               correlation_threshold=correlation_threshold, top_k=top_k,
                               device=device)
    timings.update(parts)
    t0 = time.perf_counter()
    write_network(net, output_csv)
    timings["write"] = time.perf_counter() - t0
    print(f"[INFO] Wrote {len(net['Score'])} edges to {output_csv}")
    return net, timings


def generate_coexpression_network(input_csv: str, output_csv: str, method: str = "spearman",
                                  correlation_threshold: float = 0.5, top_k: int = 5,
                                  max_genes: int = 0, device="auto") -> Dict[str, list]:
    return _generate(input_csv, output_csv, method, correlation_threshold, top_k, max_genes,
                     device)[0]


def main(argv=None) -> dict:
    """The CLI; returns the seconds of each part (read, ranking,
    gram_and_selection, gather, write)."""
    ap = argparse.ArgumentParser(
        description="Generate a co-expression network usable as --user_graph")
    ap.add_argument("--input", required=True, help="Expression CSV (genes x samples)")
    ap.add_argument("--output", required=True, help="Output edge-list CSV")
    ap.add_argument("--method", choices=["spearman", "pearson"], default="spearman")
    ap.add_argument("--correlation_threshold", type=float, default=0.5)
    ap.add_argument("--top_k", type=int, default=5)
    ap.add_argument("--max_genes", type=int, default=0,
                    help="Restrict to N most-variable genes (0 = all)")
    ap.add_argument("--device", default="auto", choices=["auto", "cuda", "cpu"],
                    help="cuda (the default, 'auto') or cpu")
    args = ap.parse_args(argv)
    _, timings = _generate(args.input, args.output, args.method, args.correlation_threshold,
                           args.top_k, args.max_genes, args.device)
    print("[INFO] Seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items()))
    return timings


if __name__ == "__main__":
    main()
