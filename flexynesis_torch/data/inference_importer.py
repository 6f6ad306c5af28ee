"""Inference-mode data importer: apply training artifacts to a test folder.

Counterpart of ``flexynesis_tpu/data/inference_importer.py`` (reference
data.py:691-942) without pandas: reads ``{modality}.csv`` (features x samples)
and ``clin.csv``, reorders features to each scaler's ``feature_names_in``
(raising on missing ones), scales them, imputes missing cells as 0 (the
training mean after scaling), intersects the samples and encodes labels with
the stored encoders (missing or unknown -> -1, shown as "Unknown").

Rebuilding covariates from clin.csv and early fusion raise
``NotImplementedError`` for now (ROADMAP A.11).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils.csvio import parse_floats, read_matrix, read_table
from .dataset import MultiOmicDataset
from .preprocessing import apply_standard_scaler, encode_labels, encoder_mapping


class DataImporterInference:
    def __init__(self, test_data_path: str, artifacts, verbose: bool = True):
        from ..inference import load_and_sniff_artifacts

        self.test_data_path = test_data_path
        self.verbose = verbose
        self.artifacts = (
            artifacts if isinstance(artifacts, dict) else load_and_sniff_artifacts(artifacts)
        )
        a = self.artifacts
        self.feature_names = a.get("feature_lists", a.get("feature_names", {}))
        self.scalers = a.get("transforms", a.get("scalers", {}))
        self.label_encoders = a.get("label_encoders", {}) or {}
        self.modalities = list(a.get("data_types", a.get("modalities", [])))
        self.target_variables = a.get("target_variables", [])
        if verbose:
            print(f"[INFO] Loaded artifacts for modalities: {self.modalities}")

    def _read_modality(self, modality: str):
        fp = os.path.join(self.test_data_path, f"{modality}.csv")
        if not os.path.exists(fp):
            raise FileNotFoundError(f"Required file not found: {fp}")
        features, samples, mat = read_matrix(fp)  # features x samples
        scaler = self.scalers[modality]
        expected = list(scaler["feature_names_in"])
        pos = {f: i for i, f in enumerate(features)}
        missing = [f for f in expected if f not in pos]
        if missing:
            raise ValueError(
                f"{modality}: test data is missing {len(missing)} features "
                "required by the trained model."
            )
        extra = len(set(pos) - set(expected))
        if extra and self.verbose:
            print(f"[INFO] {modality}: ignoring {extra} extra features")
        x = mat[[pos[f] for f in expected]].T  # samples x features
        scaled = apply_standard_scaler(scaler, x)
        n_missing = int(np.isnan(scaled).sum())
        if n_missing:
            print(
                f"[INFO] {modality}: imputing {n_missing} missing values "
                "with the training mean"
            )
            scaled[np.isnan(scaled)] = 0.0
        return samples, scaled

    def import_data(self) -> MultiOmicDataset:
        if self.modalities == ["all"]:
            raise NotImplementedError(
                "early-fusion inference is not ported yet (ROADMAP A.11)"
            )
        if "covariates" in self.modalities:
            raise NotImplementedError(
                "rebuilding covariates in inference is not ported yet (ROADMAP A.11)"
            )

        clin_path = os.path.join(self.test_data_path, "clin.csv")
        clin = read_table(clin_path) if os.path.exists(clin_path) else None

        mats: Dict[str, tuple] = {}
        samples: Optional[list] = None
        for modality in self.modalities:
            mod_samples, scaled = self._read_modality(modality)
            mats[modality] = (mod_samples, scaled)
            if samples is None:
                samples = list(mod_samples)
        if mats:
            common = set.intersection(*[set(s) for s, _ in mats.values()])
            samples = [s for s in samples if s in common]

        ann, variable_types, label_mappings = {}, {}, {}
        if clin is not None:
            clin_samples, columns, rows = clin
            clin_pos = {s: i for i, s in enumerate(clin_samples)}
            samples = [s for s in samples if s in clin_pos]
            picked = [rows[clin_pos[s]] for s in samples]
            for j, col in enumerate(columns):
                cells = [r[j] for r in picked]
                enc = self.label_encoders.get(col)
                if enc is not None:
                    ann[col] = encode_labels(enc, cells)
                    variable_types[col] = "categorical"
                    label_mappings[col] = encoder_mapping(enc)
                else:
                    try:
                        ann[col] = parse_floats(cells).astype(np.float32)
                    except ValueError as e:
                        raise ValueError(
                            f"clin.csv column '{col}' is neither numeric nor "
                            "encoded by the training artifacts"
                        ) from e
                    variable_types[col] = "numerical"

        # unlabeled cohorts: class names and kinds still resolve from the
        # trained encoders; ann stays absent and metrics skip the variable
        for var, enc in self.label_encoders.items():
            if var not in variable_types and enc is not None:
                variable_types[var] = "categorical"
                label_mappings[var] = encoder_mapping(enc)
        for var in self.target_variables:
            variable_types.setdefault(var, "numerical")

        dat = {}
        for m, (mod_samples, scaled) in mats.items():
            pos = {s: i for i, s in enumerate(mod_samples)}
            dat[m] = np.ascontiguousarray(
                scaled[[pos[s] for s in samples]], dtype=np.float32
            )
        features = {
            m: list(self.feature_names[m])
            for m in self.modalities
            if m in self.feature_names
        }
        return MultiOmicDataset(
            dat=dat,
            ann=ann,
            variable_types=variable_types,
            features=features,
            samples=list(samples or []),
            label_mappings=label_mappings,
        )
