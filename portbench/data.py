"""The benchmark's cohort, made on the device from the run's seed.

A frozen copy of the idea of ``flexynesis_torch/utils/synthetic.py``: latent
classes drive every omic layer (class centres N(0, 2^2) per feature, unit
noise per sample), so a model can learn the labels. Where the program's
generator writes CSV folders that the CLI then imports, selects and scales,
this one makes the matrices as the CLI hands them to the model after its
feature selection: ``features`` columns per layer, standardised with the
training rows' mean and standard deviation, no missing cells and no missing
labels. Everything is drawn by one ``torch.Generator`` on the device, in one
call per matrix, so the same seed gives the same cohort on any card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch


@dataclass
class Cohort:
    x: Dict[str, torch.Tensor]      # layer -> (n_train + n_test, F) float32 on the device
    y: torch.Tensor                 # (n_train + n_test,) int64 class codes on the device
    n_train: int
    n_test: int

    def rows(self, split: str) -> slice:
        return slice(0, self.n_train) if split == "train" else slice(self.n_train, None)


def make_cohort(config: dict, seed: int, device) -> Cohort:
    """The cohort of ``config`` (n_train, n_test, features, n_classes) from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    n_train, n_test = int(config["n_train"]), int(config["n_test"])
    n_all, n_cls = n_train + n_test, int(config["n_classes"])
    # every class present in both splits: a balanced assignment, shuffled
    cls = torch.arange(n_all, device=device) % n_cls
    cls = cls[torch.randperm(n_all, generator=gen, device=device)]
    x = {}
    for layer, n_feat in config["features"].items():
        centers = 2.0 * torch.randn(n_cls, int(n_feat), generator=gen, device=device)
        mat = centers[cls] + torch.randn(n_all, int(n_feat), generator=gen, device=device)
        train = mat[:n_train]
        mat = (mat - train.mean(0)) / train.std(0).clamp_min(1e-6)
        x[layer] = mat.contiguous()
    return Cohort(x=x, y=cls, n_train=n_train, n_test=n_test)


def to_dataset(cohort: Cohort, split: str, target: str):
    """The split as the program's ``MultiOmicDataset`` (host arrays, as the
    CLI's importer builds it)."""
    from flexynesis_torch.data.dataset import MultiOmicDataset

    rows = cohort.rows(split)
    dat = {k: v[rows].cpu().numpy().astype(np.float32) for k, v in cohort.x.items()}
    codes = cohort.y[rows].cpu().numpy().astype(np.float32)
    n_cls = int(cohort.y.max().item()) + 1
    start = 0 if split == "train" else cohort.n_train
    return MultiOmicDataset(
        dat=dat,
        ann={target: codes},
        variable_types={target: "categorical"},
        features={k: [f"{k}_f{j}" for j in range(v.shape[1])] for k, v in dat.items()},
        samples=[f"S{start + i:05d}" for i in range(len(codes))],
        label_mappings={target: {c: f"grp{c}" for c in range(n_cls)}},
    )
