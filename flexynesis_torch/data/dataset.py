"""Dataset container: per-modality float32 matrices and per-variable labels.

A numpy copy of ``flexynesis_tpu/data/dataset.py::MultiOmicDataset``
(reference data.py:945-1085). ``get_feature_subset`` takes rows with
``layer`` and ``name`` keys in place of a pandas table.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List

import numpy as np


@dataclass
class MultiOmicDataset:
    """dat[modality] -> (n_samples, n_features) float32;
    ann[variable] -> (n_samples,) float32 (categorical codes use -1/NaN for missing)."""

    dat: Dict[str, np.ndarray]
    ann: Dict[str, np.ndarray]
    variable_types: Dict[str, str]
    features: Dict[str, List[str]]
    samples: List[str]
    label_mappings: Dict[str, Dict[int, str]] = field(default_factory=dict)
    feature_ann: Dict[str, dict] = field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.samples)

    def __getitem__(self, idx):
        dat = {k: v[idx] for k, v in self.dat.items()}
        ann = {k: v[idx] for k, v in self.ann.items()}
        return dat, ann, self.samples[idx]

    @property
    def layers(self) -> List[str]:
        return list(self.dat.keys())

    def input_dims(self) -> List[int]:
        return [self.dat[k].shape[1] for k in self.dat.keys()]

    def subset(self, indices) -> "MultiOmicDataset":
        """Row subset (reference data.py:1022-1043)."""
        indices = np.asarray(indices)
        return MultiOmicDataset(
            dat={k: v[indices] for k, v in self.dat.items()},
            ann={k: v[indices] for k, v in self.ann.items()},
            variable_types=self.variable_types,
            features=self.features,
            samples=[self.samples[int(i)] for i in indices],
            label_mappings=self.label_mappings,
            feature_ann=self.feature_ann,
        )

    def get_feature_subset(self, feature_rows: Iterable[dict]) -> "MultiOmicDataset":
        """Column subset by rows with ``layer`` and ``name`` keys
        (reference data.py:1045-1071); layers without rows are kept whole."""
        wanted: Dict[str, set] = {}
        for row in feature_rows:
            wanted.setdefault(row["layer"], set()).add(row["name"])
        new_dat, new_features = {}, {}
        for layer, mat in self.dat.items():
            if layer in wanted:
                keep = [
                    i for i, f in enumerate(self.features[layer]) if f in wanted[layer]
                ]
                new_dat[layer] = mat[:, keep]
                new_features[layer] = [self.features[layer][i] for i in keep]
            else:
                new_dat[layer] = mat
                new_features[layer] = list(self.features[layer])
        return MultiOmicDataset(
            dat=new_dat,
            ann=self.ann,
            variable_types=self.variable_types,
            features=new_features,
            samples=self.samples,
            label_mappings=self.label_mappings,
            feature_ann=self.feature_ann,
        )

    def get_dataset_stats(self) -> dict:
        stats = {
            ": ".join(["feature_count in", k]): v.shape[1] for k, v in self.dat.items()
        }
        stats["sample_count"] = len(self.samples)
        return stats

    def as_arrays(self):
        return self.dat, self.ann
