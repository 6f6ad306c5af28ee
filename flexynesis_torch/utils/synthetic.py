"""Synthetic multi-omics dataset generator (numpy + csv).

Counterpart of ``flexynesis_tpu/utils/synthetic.py``: the same random draws
in the same order, so one seed gives the same numbers, NaN cells and missing
labels as the JAX package, written in the same folder layout
(``train/`` and ``test/`` with ``{layer}.csv`` as features x samples and
``clin.csv`` as samples x variables). Latent clusters drive both the omic
matrices and the labels, so a model can learn from the data.

``gene_names=True`` names every layer's rows ``g0, g1, ...`` (the layers
share gene names, as a GNN's folder does, in place of ``{layer}_f{j}``);
``write_user_graph`` writes a GeneA/GeneB/Score network over such names: a
ring plus random edges per gene.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Optional

import numpy as np

from .csvio import format_cell


def make_synthetic_arrays(
    n_train: int = 120,
    n_test: int = 60,
    n_features: Dict[str, int] = None,
    n_classes: int = 3,
    seed: int = 0,
    survival: bool = True,
    missing_label_rate: float = 0.05,
    nan_rate: float = 0.01,
):
    """(sample_ids, {layer: (n_all, nf) float64}, clin columns {name: array})."""
    n_features = n_features or {"gex": 200, "cnv": 150}
    rng = np.random.default_rng(seed)
    n_all = n_train + n_test
    centers = {
        layer: rng.normal(0, 2.0, size=(n_classes, nf))
        for layer, nf in n_features.items()
    }
    cls = rng.integers(0, n_classes, size=n_all)
    sample_ids = [f"S{i:05d}" for i in range(n_all)]

    mats = {}
    for layer, nf in n_features.items():
        X = centers[layer][cls] + rng.normal(0, 1.0, size=(n_all, nf))
        mask = rng.random(X.shape) < nan_rate
        X[mask] = np.nan
        mats[layer] = X

    age = 50 + 5 * cls + rng.normal(0, 3, n_all)
    risk = 0.8 * cls + 0.02 * (age - 50)
    time = rng.exponential(np.exp(-risk) * 20)
    event = (rng.random(n_all) < 0.7).astype(float)
    labels = np.array([f"grp{c}" for c in cls], dtype=object)
    miss = rng.random(n_all) < missing_label_rate
    labels[miss] = np.nan

    clin = {"subtype": labels, "age": age}
    if survival:
        clin["OS_MONTHS"] = time
        clin["OS_STATUS"] = event
    return sample_ids, mats, clin


def write_synthetic_folder(
    path: str,
    n_train: int = 120,
    n_test: int = 60,
    n_features: Optional[Dict[str, int]] = None,
    n_classes: int = 3,
    seed: int = 0,
    survival: bool = True,
    gene_names: bool = False,
) -> List[str]:
    """Write the synthetic dataset as train/ + test/ CSV folders; returns layers."""
    sample_ids, mats, clin = make_synthetic_arrays(
        n_train=n_train, n_test=n_test, n_features=n_features,
        n_classes=n_classes, seed=seed, survival=survival,
    )
    n_all = n_train + n_test
    for split, sl in (("train", slice(0, n_train)), ("test", slice(n_train, n_all))):
        ids = sample_ids[sl]
        os.makedirs(os.path.join(path, split), exist_ok=True)
        for layer, X in mats.items():
            with open(os.path.join(path, split, f"{layer}.csv"), "w", newline="") as fh:
                writer = csv.writer(fh, lineterminator="\n")
                writer.writerow(["", *ids])
                for j, col in enumerate(X[sl].T):
                    name = f"g{j}" if gene_names else f"{layer}_f{j}"
                    writer.writerow([name, *(format_cell(v) for v in col)])
        with open(os.path.join(path, split, "clin.csv"), "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(["", *clin])
            for i in range(sl.start, sl.stop):
                writer.writerow(
                    [sample_ids[i], *(format_cell(v[i]) for v in clin.values())]
                )
    return list(mats)


def write_user_graph(path: str, n_genes: int) -> int:
    """A GeneA,GeneB,Score CSV over genes g0..g{n_genes-1}: the ring
    g_i -> g_{i+1} plus two random partners per gene (seed 0), scores
    uniform in [0.4, 1); returns the edge count."""
    rng = np.random.default_rng(0)
    src = np.concatenate([np.arange(n_genes), np.repeat(np.arange(n_genes), 2)])
    dst = np.concatenate([(np.arange(n_genes) + 1) % n_genes,
                          rng.integers(0, n_genes, n_genes * 2)])
    score = rng.uniform(0.4, 1.0, len(src))
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(["GeneA", "GeneB", "Score"])
        writer.writerows((f"g{a}", f"g{b}", f"{w:.4f}") for a, b, w in zip(src, dst, score))
    return len(src)
