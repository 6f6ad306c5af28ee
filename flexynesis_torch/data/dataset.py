"""Dataset containers: per-modality float32 matrices and per-variable labels.

Numpy copies of ``flexynesis_tpu/data/dataset.py``:

* ``MultiOmicDataset`` (reference data.py:945-1085); ``get_feature_subset``
  takes rows with ``layer`` and ``name`` keys in place of a pandas table;
* ``TripletMultiOmicDataset`` (data.py:1089-1151): anchors and label groups
  of the triplet model, with a host-side sampler of (anchor, positive,
  negative) tables;
* ``MultiOmicDatasetNW`` (data.py:1154-1304): the GNN's node tensor over a
  gene-interaction graph (a dict of columns from ``data/graph.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional

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


class TripletMultiOmicDataset:
    """Anchor/positive/negative index sampling for triplet training.

    Anchors are the samples with a non-missing main label; positives share
    the anchor's label; negatives come from any other label group, the
    missing-label group included. The triplet model builds its sampler and
    counts its anchors from these groups, and draws its partners on the
    device (``models/triplet_encoder.py``); ``sample_triplets`` draws a full
    (n_anchors, 3) table from a numpy seed."""

    def __init__(self, dataset: MultiOmicDataset, main_var: str):
        self.dataset = dataset
        self.main_var = main_var
        labels = np.asarray(dataset.ann[main_var], dtype=np.float64)
        valid = np.isfinite(labels) & (labels != -1)
        self.anchor_indices = np.where(valid)[0]
        self.labels = labels
        # label -> sample indices (NaN/-1 grouped under key 'missing')
        self.label_groups: Dict[object, np.ndarray] = {}
        for lbl in np.unique(labels[valid]):
            self.label_groups[float(lbl)] = np.where(valid & (labels == lbl))[0]
        if (~valid).any():
            self.label_groups["missing"] = np.where(~valid)[0]

    def __len__(self) -> int:
        return len(self.anchor_indices)

    def sample_triplets(self, seed: int) -> np.ndarray:
        """An (n_anchors, 3) int array of (anchor, positive, negative)."""
        rng = np.random.default_rng(seed)
        keys = list(self.label_groups.keys())
        out = np.empty((len(self.anchor_indices), 3), dtype=np.int64)
        for i, a in enumerate(self.anchor_indices):
            lbl = float(self.labels[a])
            pos_pool = self.label_groups[lbl]
            pos = pos_pool[rng.integers(len(pos_pool))]
            neg_keys = [k for k in keys if k != lbl]
            nk = neg_keys[rng.integers(len(neg_keys))]
            neg_pool = self.label_groups[nk]
            neg = neg_pool[rng.integers(len(neg_pool))]
            out[i] = (a, pos, neg)
        return out


class MultiOmicDatasetNW:
    """Graph overlay: node set = (union of omic features, in the order the
    layers list them) that lie in the graph; node features (samples, nodes,
    layers) filled with each (node, layer)'s nanmedian, then 0; a (2, E)
    ``edge_index`` of the graph's edges within the node set; ``dat["all"]``
    the flattened (samples, nodes * layers) view the GNN reads."""

    def __init__(self, dataset: MultiOmicDataset, interaction_df,
                 node_names: Optional[List[str]] = None):
        self.dataset = dataset
        self.multiomic_dataset = dataset
        self.interaction_df = interaction_df
        if node_names is not None:
            # the caller pins the node set (the test split reuses the train nodes)
            self.node_names = list(node_names)
        else:
            genes_graph = set(interaction_df["protein1"]) | set(interaction_df["protein2"])
            seen = set()
            union_feats: List[str] = []
            for layer in dataset.dat.keys():
                for f in dataset.features[layer]:
                    if f not in seen:
                        union_feats.append(f)
                        seen.add(f)
            self.node_names = [f for f in union_feats if f in genes_graph]
        if not self.node_names:
            raise ValueError("No overlap between omic features and the interaction network.")
        node_pos = {g: i for i, g in enumerate(self.node_names)}

        n_samples = len(dataset.samples)
        n_nodes = len(self.node_names)
        layers = list(dataset.dat.keys())
        tensor = np.full((n_samples, n_nodes, len(layers)), np.nan, dtype=np.float32)
        for li, layer in enumerate(layers):
            fpos = {f: j for j, f in enumerate(dataset.features[layer])}
            nodes = [ni for g, ni in node_pos.items() if g in fpos]
            cols = [fpos[self.node_names[ni]] for ni in nodes]
            tensor[:, nodes, li] = dataset.dat[layer][:, cols]
        # nanmedian fill per (node, layer); nodes absent from a layer are
        # all-NaN there and get 0
        import warnings

        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "All-NaN slice encountered")
            med = np.nanmedian(tensor, axis=0)
        med = np.where(np.isnan(med), 0.0, med)
        nan_mask = np.isnan(tensor)
        tensor[nan_mask] = np.broadcast_to(med, tensor.shape)[nan_mask]
        self.node_features = tensor

        edges = [(node_pos[a], node_pos[b])
                 for a, b in zip(interaction_df["protein1"], interaction_df["protein2"])
                 if a in node_pos and b in node_pos]
        if not edges:
            raise ValueError("Interaction network has no edges within the node set.")
        self.edge_index = np.asarray(edges, dtype=np.int32).T  # (2, E)

        self.ann = dataset.ann
        self.variable_types = dataset.variable_types
        self.samples = dataset.samples
        self.label_mappings = dataset.label_mappings
        self.common_features = list(self.node_names)
        self.features = {"all": [f"{g}:{layer}" for g in self.node_names for layer in layers]}
        self.dat = {"all": self.node_features.reshape(n_samples, -1)}

    def __len__(self) -> int:
        return len(self.samples)

    def as_arrays(self):
        return self.dat, self.ann

    def subset(self, indices) -> "MultiOmicDatasetNW":
        import copy

        indices = np.asarray(indices)
        new = copy.copy(self)
        new.node_features = self.node_features[indices]
        new.dat = {"all": self.dat["all"][indices]}
        new.ann = {k: v[indices] for k, v in self.ann.items()}
        new.samples = [self.samples[int(i)] for i in indices]
        return new

    def print_stats(self) -> None:
        n_nodes = len(self.node_names)
        n_edges = self.edge_index.shape[1]
        deg = np.bincount(self.edge_index.reshape(-1), minlength=n_nodes)
        print(
            f"[INFO] Network stats: {n_nodes} nodes, {n_edges} edges, "
            f"degree mean {deg.mean():.2f} / median {np.median(deg):.0f} / max {deg.max()}"
        )
