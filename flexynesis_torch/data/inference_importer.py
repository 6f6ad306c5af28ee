"""Inference-mode data importer: apply training artifacts to a test folder.

Counterpart of ``flexynesis_tpu/data/inference_importer.py`` (reference
data.py:691-942) without pandas: reads ``{modality}.csv`` (features x samples)
and ``clin.csv``, reorders features to each scaler's ``feature_names_in``
(raising on missing ones), scales them, imputes missing cells as 0 (the
training mean after scaling), intersects the samples and encodes labels with
the stored encoders (missing or unknown -> -1, shown as "Unknown").

A model trained with covariates gets its ``covariates`` block rebuilt from
the test clin.csv (``covariates.py``, the column types and medians of the
whole test file, as the JAX package reads it with pandas), also under early
fusion: reindexed to the trained columns, a column the test cohort lacks
filled with 0 (the one-hot "level absent") and an unseen level dropped. If
every trained column of one covariate would be filled, the import raises:
the test cohort encodes that covariate otherwise. Early fusion (artifacts
with the one layer ``all``) reads every ``original_modalities`` layer,
joins them and the covariates in the training order and keeps the trained
``all`` features, raising where they cannot be reproduced.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..utils.csvio import parse_floats, read_matrix, read_table
from .covariates import create_covariate_matrix, get_variable_types
from .dataset import MultiOmicDataset
from .preprocessing import apply_standard_scaler, encode_labels, encoder_mapping


class DataImporterInference:
    def __init__(self, test_data_path: str, artifacts_path, verbose: bool = True):
        from ..inference import load_and_sniff_artifacts

        self.test_data_path = test_data_path
        self.verbose = verbose
        self.artifacts = (
            artifacts_path if isinstance(artifacts_path, dict)
            else load_and_sniff_artifacts(artifacts_path)
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

    def _covariate_block(self, clin, to_load, early_fusion: bool):
        """(trained covariate columns, (clin rows, columns) matrix) rebuilt
        from the test clin.csv and reindexed to the trained columns
        (inference_importer.py:110-208 of the JAX package)."""
        from .importer import Clinical

        cov_vars = self.artifacts.get("covariate_vars", [])
        if self.verbose:
            print(f"[INFO] Rebuilding covariate matrix for: {cov_vars}")
        table = Clinical(*clin)
        names, block = create_covariate_matrix(cov_vars, get_variable_types(table), table)
        col_groups = self.artifacts.get("covariate_columns") or {}
        if early_fusion:
            recorded = {c for cols in col_groups.values() for c in cols}
            if recorded:  # the recorded groups say which 'all' columns are covariates
                train_cols = [f for f in self.feature_names["all"] if f in recorded]
            else:  # older artifacts: what no omics scaler names
                omics = {f for m in to_load for f in self.scalers[m]["feature_names_in"]}
                train_cols = [f for f in self.feature_names["all"] if f not in omics]
        else:
            train_cols = list(self.feature_names.get("covariates", names))
        train_set, rebuilt = set(train_cols), set(names)
        dropped = [c for c in names if c not in train_set]
        filled = [c for c in train_cols if c not in rebuilt]
        # each covariate must keep one trained column: an all-zero block for
        # it would pass every width check while the model reads nothing
        for var in cov_vars:
            cols_v = col_groups.get(var) or [c for c in train_cols
                                             if c == var or c.startswith(f"{var}_")]
            cols_v = [c for c in cols_v if c in train_set]
            if cols_v and not any(c in rebuilt for c in cols_v):
                raise ValueError(
                    f"Inference covariates: none of '{var}'s trained columns "
                    f"({cols_v[:5]}) can be rebuilt from the test clin.csv (rebuilt "
                    f"columns: {names[:8]}). The test cohort likely encodes this "
                    "covariate with different types/levels than the training data."
                )
        if (dropped or filled) and self.verbose:
            print(f"[INFO] covariates: aligning to training columns ({len(filled)} "
                  f"zero-filled, {len(dropped)} unseen test levels dropped)")
        pos = {c: j for j, c in enumerate(names)}
        out = np.zeros((block.shape[0], len(train_cols)))
        for j, c in enumerate(train_cols):
            if c in pos:
                out[:, j] = block[:, pos[c]]
        return train_cols, out

    def import_data(self) -> MultiOmicDataset:
        early_fusion = self.modalities == ["all"]
        if early_fusion:
            to_load = list(self.artifacts.get("original_modalities", []))
            if not to_load:
                raise ValueError("Early fusion artifacts must record original_modalities.")
        else:
            to_load = [m for m in self.modalities if m != "covariates"]

        clin_path = os.path.join(self.test_data_path, "clin.csv")
        clin = read_table(clin_path) if os.path.exists(clin_path) else None

        mats: Dict[str, tuple] = {}
        samples: Optional[list] = None
        for modality in to_load:
            mod_samples, scaled = self._read_modality(modality)
            mats[modality] = (mod_samples, scaled)
            if samples is None:
                samples = list(mod_samples)
        if mats:
            common = set.intersection(*[set(s) for s, _ in mats.values()])
            samples = [s for s in samples if s in common]

        # the covariates of a model trained with them, under early fusion too
        cov_cols = None
        if clin is not None and self.artifacts.get("covariate_vars") and (
                "covariates" in self.modalities or early_fusion):
            cov_cols, block = self._covariate_block(clin, to_load, early_fusion)
            if samples is None:
                samples = list(clin[0])
            mats["covariates"] = (clin[0], block)

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

        if early_fusion:
            features = {m: list(self.scalers[m]["feature_names_in"]) for m in to_load}
            if cov_cols is not None:
                features["covariates"] = cov_cols
            ordered = to_load + ["covariates"]
        else:
            features = {m: list(self.feature_names[m]) for m in self.modalities
                        if m in self.feature_names}
            ordered = self.modalities
        dat = {}
        for m in ordered:
            if m in mats:
                mod_samples, scaled = mats[m]
                pos = {s: i for i, s in enumerate(mod_samples)}
                dat[m] = np.ascontiguousarray(scaled[[pos[s] for s in samples]],
                                              dtype=np.float32)
        if early_fusion:
            dat, features = self._fuse(dat, features)
        return MultiOmicDataset(
            dat=dat,
            ann=ann,
            variable_types=variable_types,
            features=features,
            samples=list(samples or []),
            label_mappings=label_mappings,
        )

    def _fuse(self, dat: dict, features: dict):
        """The one ``all`` layer: the layers joined in the training order
        (``original_modalities``, then the covariates), restricted to the
        trained features, which must come out in the trained order."""
        order = list(self.artifacts.get("original_modalities", list(dat)))
        if "covariates" in dat and "covariates" not in order:
            order.append("covariates")
        concat = np.concatenate([dat[m] for m in order], axis=1)
        all_feats = [f for m in order for f in features[m]]
        expected = list(self.feature_names["all"])
        expected_set = set(expected)
        keep = [i for i, f in enumerate(all_feats) if f in expected_set]
        kept = [all_feats[i] for i in keep]
        if kept != expected:
            missing = sorted(expected_set - set(kept))
            if missing:
                detail = f"{len(missing)} trained features unmatched, e.g. {missing[:5]}"
            else:  # the same features, in another order or repeated
                diff = next((i for i, (a, b) in enumerate(zip(kept, expected)) if a != b),
                            min(len(kept), len(expected)))
                detail = ("features match but the order/multiplicity differs "
                          f"(got {len(kept)} vs {len(expected)} trained; first "
                          f"difference at index {diff})")
            raise ValueError(
                "Early-fusion inference: test features do not reproduce the trained "
                f"'all' block ({detail}). Check that the test folder carries every "
                "training modality (and clinical covariates, if trained with --covariates)."
            )
        return {"all": np.ascontiguousarray(concat[:, keep])}, {"all": kept}
