"""Training-mode data importer for CSV folders, with numpy in place of pandas.

Counterpart of ``flexynesis_tpu/data/importer.py::DataImporter`` (reference
data.py:22-688). A folder holds ``train/`` and ``test/`` with ``{layer}.csv``
(features x samples, read by the native parser of ``data/fastcsv.py``) and
``clin.csv`` (samples x variables, read by ``utils/csvio.py``). ``import_data``
validates the folders, optionally draws ``downsample`` training samples and
restricts the features to a user list, then per split:

* ``cleanup_data``: drops features below the variance quantile or at or above
  the NA threshold, imputes the feature median, and drops samples with zero
  or undefined standard deviation (or no values) in any layer;
* ``get_labels``: keeps the samples present in every layer and in clin.csv;
* ``select_features`` (train only): Laplacian-score selection on the model's
  device (``feature_selection.py``);

then ``harmonize`` keeps the features common to both splits, ``log1p`` if
asked, fits the standard scaler on train and applies it to both, builds the
``covariates`` block from clin.csv after normalisation (``covariates.py``;
``harmonize`` keeps the columns both splits have, and ``covariate_columns``
records each covariate's trained columns for inference), encodes the
categorical clinical variables (ordinal, sorted categories, missing labels
NaN) and builds the datasets; early fusion (``concatenate``) joins the
``data_types`` in order, then the covariates, into one layer ``all``.

pandas' semantics are kept: the matrices hold float32 values, variance and
standard deviation use ddof=1 and skip NaN, quantiles interpolate linearly,
medians skip NaN; the scaler uses ddof=0 and gives zero-variance features a
scale of 1. One difference: the JAX package orders samples by Python set
iteration (its ``get_labels``), which changes with the hash seed; here samples
keep the order of the first layer's file. HDF5 folders take the subclass
``data/h5.py::H5DataImporter``.
"""

from __future__ import annotations

import os
import warnings
from typing import Dict, List, Optional

import numpy as np

from ..utils.csvio import NA_VALUES, read_table
from ..utils.device import resolve_device
from .covariates import create_covariate_matrix, get_variable_types
from .dataset import MultiOmicDataset
from .fastcsv import read_matrix_csv
from .feature_selection import filter_by_laplacian
from .preprocessing import NAN_TOKEN, apply_standard_scaler, fit_standard_scaler


class Layer:
    """One omics matrix: ``values`` (features x samples) float32 with names."""

    def __init__(self, features: List[str], samples: List[str], values: np.ndarray):
        self.features = list(features)
        self.samples = list(samples)
        self.values = values

    def take(self, feature_idx=None, sample_idx=None) -> "Layer":
        v = self.values
        f, s = self.features, self.samples
        if feature_idx is not None:
            v, f = v[np.asarray(feature_idx, dtype=np.int64)], [f[i] for i in feature_idx]
        if sample_idx is not None:
            v, s = v[:, np.asarray(sample_idx, dtype=np.int64)], [s[i] for i in sample_idx]
        return Layer(f, s, np.ascontiguousarray(v))

    def rows(self, names) -> "Layer":
        pos = {n: i for i, n in enumerate(self.features)}
        return self.take(feature_idx=[pos[n] for n in names])

    def columns(self, names) -> "Layer":
        pos = {n: i for i, n in enumerate(self.samples)}
        return self.take(sample_idx=[pos[n] for n in names])


class Clinical:
    """clin.csv: sample names, column names and the raw cells, row by row."""

    def __init__(self, samples: List[str], columns: List[str], rows: List[List[str]]):
        self.samples, self.columns, self.rows = list(samples), list(columns), rows

    def subset(self, names) -> "Clinical":
        pos = {n: i for i, n in enumerate(self.samples)}
        return Clinical(names, self.columns, [self.rows[pos[n]] for n in names])

    def column(self, name: str) -> List[str]:
        j = self.columns.index(name)
        return [r[j] for r in self.rows]


def _as_numbers(cells) -> Optional[np.ndarray]:
    """float64 values if every non-NA cell is a number (pandas would infer a
    numeric column), else None."""
    try:
        return np.array([np.nan if c in NA_VALUES else float(c) for c in cells],
                        dtype=np.float64)
    except ValueError:
        return None


def _nan_var(values: np.ndarray, axis: int) -> np.ndarray:
    """pandas ``var``/``std`` squared: ddof=1, NaN skipped, NaN below 2 values."""
    x = values.astype(np.float64)
    n = np.sum(~np.isnan(x), axis=axis)
    mean = np.nansum(x, axis=axis) / np.maximum(n, 1)
    dev = np.where(np.isnan(x), 0.0, x - np.expand_dims(mean, axis))
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(n > 1, np.sum(dev * dev, axis=axis) / (n - 1), np.nan)


class DataImporter:
    """Imports, cleans and preprocesses multi-omic CSV data folders.

    ``device`` is where feature selection runs: ``auto`` and ``cuda`` mean the
    card and raise without one; ``cpu`` only when asked for."""

    def __init__(
        self,
        path: str,
        data_types: List[str],
        covariates: Optional[List[str]] = None,
        processed_dir: str = "processed",
        log_transform: bool = False,
        concatenate: bool = False,
        restrict_to_features: Optional[str] = None,
        min_features: Optional[int] = None,
        top_percentile: float = 20,
        correlation_threshold: float = 0.9,
        variance_threshold: float = 0.01,
        na_threshold: float = 0.1,
        downsample: int = 0,
        device="auto",
    ):
        self.path = path
        self.data_types = list(data_types)
        # stored as in JAX (importer.py:53), which never reads it either
        self.processed_dir = os.path.join(path, processed_dir)
        self.covariates = covariates
        self.concatenate = concatenate
        self.log_transform = log_transform
        self.min_features = min_features
        self.top_percentile = top_percentile
        self.correlation_threshold = correlation_threshold
        self.variance_threshold = variance_threshold
        self.na_threshold = na_threshold
        self.downsample = downsample
        self.device = resolve_device(device)

        self.encoders: Dict[str, dict] = {}
        self.scalers: Optional[Dict[str, dict]] = None
        self.feature_logs: Dict[str, object] = {}
        # artifacts for inference mode
        self.train_features: Dict[str, List[str]] = {}
        self.label_encoders: Dict[str, dict] = {}
        self.covariate_columns: Dict[str, List[str]] = {}
        self.restrict_to_features = self._load_user_features(restrict_to_features)

    @staticmethod
    def _load_user_features(path: Optional[str]):
        if path is None:
            return None
        if not os.path.isfile(path):
            raise FileNotFoundError(f"File not found: {path}")
        with open(path) as fp:
            return set(x.strip() for x in fp.read().splitlines() if x.strip())

    # ------------------------------------------------------------------ IO

    def validate_data_folders(self, training_path: str, testing_path: str) -> None:
        required = {"clin.csv"} | {f"{dt}.csv" for dt in self.data_types}
        for split, p in (("training", training_path), ("testing", testing_path)):
            missing = required - set(os.listdir(p))
            if missing:
                raise ValueError(
                    f"Missing files in {split} folder: {', '.join(sorted(missing))}"
                )

    def read_layer(self, folder_path: str, name: str) -> Layer:
        fp = os.path.join(folder_path, f"{name}.csv")
        print(f"[INFO] Importing {fp}...")
        return Layer(*read_matrix_csv(fp))

    def read_data(self, folder_path: str) -> dict:
        fp = os.path.join(folder_path, "clin.csv")
        print(f"[INFO] Importing {fp}...")
        # mixed-type columns: the Python reader, as JAX keeps pandas here
        data = {"clin": Clinical(*read_table(fp))}
        for name in self.data_types:
            data[name] = self.read_layer(folder_path, name)
        return data

    def subsample(self, dat: dict, n: int) -> dict:
        """``clin.sample(n, random_state=42)`` and the matching columns."""
        clin = dat["clin"]
        idx = np.random.RandomState(42).choice(len(clin.samples), n, replace=False)
        names = [clin.samples[i] for i in idx]
        out = {x: dat[x].columns(names) for x in self.data_types}
        out["clin"] = clin.subset(names)
        return out

    def filter_by_features(self, dat: dict, features) -> dict:
        out = {}
        for key, d in dat.items():
            if key == "clin":
                out[key] = d
                continue
            out[key] = d.take(feature_idx=[i for i, f in enumerate(d.features) if f in features])
            print(f"[INFO] layer '{key}': {len(out[key].features)} features after user filter")
        return out

    def validate_input_data(self, train_dat: dict, test_dat: dict) -> None:
        errors, warnings = [], []
        for split, dat in (("train", train_dat), ("test", test_dat)):
            for name, d in dat.items():
                names = d.samples if name == "clin" else d.features
                if len(set(names)) != len(names):
                    kind = "Sample labels" if name == "clin" else "Feature names"
                    errors.append(
                        f"Error in {split}/{name}.csv: {kind} in the first column must be unique."
                    )
            clin_samples = set(dat["clin"].samples)
            for name, d in dat.items():
                if name == "clin":
                    continue
                overlap = clin_samples & set(d.samples)
                if not overlap:
                    errors.append(
                        f"Error: No matching sample labels between {split}/clin.csv and {split}/{name}.csv."
                    )
                elif len(overlap) < len(clin_samples):
                    warnings.append(
                        f"Warning: some samples in {split}/clin.csv are missing in {split}/{name}.csv"
                    )
        for name in train_dat:
            if name != "clin" and name in test_dat:
                if not set(train_dat[name].features) & set(test_dat[name].features):
                    errors.append(
                        f"Error: No common features between train/{name}.csv and test/{name}.csv."
                    )
        for w in warnings:
            print(f"[WARNING] {w}")
        if errors:
            for e in errors:
                print(f"[ERROR] {e}")
            raise ValueError("Input data validation failed; see errors above.")

    # ---------------------------------------------------------- processing

    def cleanup_data(self, layers: Dict[str, Layer]) -> Dict[str, Layer]:
        """Variance-quantile + NA-threshold feature filter, median imputation,
        and removal of samples with zero-std (or no values) in any layer."""
        cleaned, sample_ok, logs = {}, {}, {}
        for key, d in layers.items():
            # float32 like pandas' var of a float32 frame
            variances = _nan_var(d.values, axis=1).astype(np.float32)
            na_pct = np.isnan(d.values).mean(axis=1)
            finite_var = variances[~np.isnan(variances)]
            vcut = np.quantile(finite_var, self.variance_threshold) if finite_var.size else np.nan
            with np.errstate(invalid="ignore"):
                keep = (variances >= vcut) & (na_pct < self.na_threshold)
            logs[key] = [
                {"feature": f, "na_percent": float(p), "variance": v, "selected": bool(k)}
                for f, p, v, k in zip(d.features, na_pct, variances, keep)
            ]
            d = d.take(feature_idx=np.flatnonzero(keep))
            values = d.values
            nan = np.isnan(values)
            # degenerate-sample mask BEFORE imputation: a fully-missing sample
            # would otherwise become the median vector and survive
            with np.errstate(invalid="ignore"):
                pre_na_frac = nan.mean(axis=0)
            if nan.any():
                with warnings.catch_warnings():  # an all-NaN feature keeps NaN
                    warnings.simplefilter("ignore", RuntimeWarning)
                    medians = np.nanmedian(values.astype(np.float64), axis=1)
                values = np.where(nan, medians[:, None].astype(np.float32), values)
                d = Layer(d.features, d.samples, values)
            stds = np.sqrt(_nan_var(d.values, axis=0))
            ok = (stds != 0) & ~np.isnan(stds) & (pre_na_frac < 1.0)
            for s, o in zip(d.samples, ok):
                sample_ok[s] = sample_ok.get(s, True) and bool(o)
            cleaned[key] = d
            print(f"[INFO] layer '{key}': kept {len(d.features)} features after cleanup")
        for key, d in cleaned.items():
            cleaned[key] = d.take(sample_idx=[i for i, s in enumerate(d.samples) if sample_ok[s]])
        self.feature_logs["cleanup"] = logs
        return cleaned

    def get_labels(self, layers: Dict[str, Layer], clin: Clinical):
        """Samples present in every layer and in clin.csv, in the order of the
        first layer's file."""
        common = set(clin.samples)
        for d in layers.values():
            common &= set(d.samples)
        samples = [s for s in next(iter(layers.values())).samples if s in common]
        return ({x: d.columns(samples) for x, d in layers.items()},
                clin.subset(samples), samples)

    def select_features(self, layers: Dict[str, Layer],
                        laplacian_sample_cap: int = 10000) -> Dict[str, Layer]:
        out, logs = {}, {}
        for layer, d in layers.items():
            topN = max(int(len(d.features) * self.top_percentile / 100),
                       self.min_features or 0)
            X = d.values.T  # samples x features
            if X.shape[0] > laplacian_sample_cap:
                # pandas X.sample(n, random_state=42)
                rows = np.random.RandomState(42).choice(
                    X.shape[0], laplacian_sample_cap, replace=False)
                X = X[rows]
            chosen, log = filter_by_laplacian(
                X, d.features, layer, topN=topN,
                correlation_threshold=self.correlation_threshold, device=self.device,
            )
            out[layer] = d.rows(chosen)
            logs[layer] = log
        self.feature_logs["select_features"] = logs
        return out

    def process_data(self, data: dict, split: str = "train"):
        layers = self.cleanup_data({x: data[x] for x in self.data_types})
        layers, clin, samples = self.get_labels(layers, data["clin"])
        if split == "train" and self.top_percentile:
            layers = self.select_features(layers)
        return layers, clin, samples

    @staticmethod
    def harmonize(dat1: Dict[str, Layer], dat2: Dict[str, Layer]):
        """Keep the features of each layer present in both splits, in the
        order of the first."""
        out1, out2 = {}, {}
        for x in dat1:
            if x not in dat2:
                continue
            other = set(dat2[x].features)
            common = [f for f in dat1[x].features if f in other]
            out1[x], out2[x] = dat1[x].rows(common), dat2[x].rows(common)
        return out1, out2

    @staticmethod
    def transform_data(layers: Dict[str, Layer]) -> Dict[str, Layer]:
        return {x: Layer(d.features, d.samples, np.log1p(d.values)) for x, d in layers.items()}

    def normalize_data(self, layers: Dict[str, Layer], fit: bool = True) -> Dict[str, np.ndarray]:
        """{layer: (samples, features) float32} scaled by the scaler fitted on
        the training split (``StandardScaler`` state dicts in ``scalers``)."""
        if fit:
            self.scalers = {x: fit_standard_scaler(d.values.T, d.features)
                            for x, d in layers.items()}
        return {x: apply_standard_scaler(self.scalers[x], d.values.T).astype(np.float32)
                for x, d in layers.items()}

    # ------------------------------------------------------------- labels

    def _fit_encoder(self, name: str, cells: List[str]) -> dict:
        """State of ``OrdinalEncoder(handle_unknown="use_encoded_value",
        unknown_value=-1)`` fitted on one column: sorted categories, a
        missing value as the last category."""
        values = sorted({c for c in cells if c not in NA_VALUES})
        if any(c in NA_VALUES for c in cells):
            values.append(NAN_TOKEN)
        state = {
            "type": "OrdinalEncoder",
            "categories": [values],
            "handle_unknown": "use_encoded_value",
            "unknown_value": -1,
            "encoded_missing_value": NAN_TOKEN,
        }
        self.encoders[name] = state
        self.label_encoders[name] = state
        return state

    @staticmethod
    def _encode(state: dict, cells: List[str]) -> np.ndarray:
        """Codes of raw cells: unknown -> -1; missing -> NaN where the encoder
        saw missing values in training, else -1 (sklearn's transform)."""
        categories = state["categories"][0]
        pos = {c: i for i, c in enumerate(categories) if c != NAN_TOKEN}
        missing = np.nan if NAN_TOKEN in categories else -1.0
        return np.array([missing if c in NA_VALUES else pos.get(c, -1.0) for c in cells],
                        dtype=np.float64)

    def encode_labels(self, clin: Clinical):
        """(codes, variable_types, label_mappings): numeric columns as floats,
        the others ordinal-encoded with the training encoders."""
        numeric, categorical = {}, {}
        for col in clin.columns:
            cells = clin.column(col)
            values = _as_numbers(cells)
            if values is not None:
                numeric[col] = values
            else:
                categorical[col] = cells
        label_mappings, encoded = {}, dict(numeric)
        for col, cells in categorical.items():
            state = self.encoders.get(col) or self._fit_encoder(col, cells)
            encoded[col] = self._encode(state, cells)
            label_mappings[col] = {
                i: (np.nan if c == NAN_TOKEN else c)
                for i, c in enumerate(state["categories"][0])
            }
        variable_types = {c: "categorical" for c in categorical}
        variable_types.update({c: "numerical" for c in numeric})
        return encoded, variable_types, label_mappings

    def get_dataset(self, mats: Dict[str, np.ndarray], features: Dict[str, List[str]],
                    clin: Clinical, samples: List[str]) -> MultiOmicDataset:
        ann, variable_types, label_mappings = self.encode_labels(clin)
        return MultiOmicDataset(
            dat={x: np.ascontiguousarray(m, dtype=np.float32) for x, m in mats.items()},
            ann={c: np.asarray(v, dtype=np.float32) for c, v in ann.items()},
            variable_types=variable_types,
            features={x: list(f) for x, f in features.items()},
            samples=list(samples),
            label_mappings=label_mappings,
        )

    def _add_covariates(self, clin_types, clins, mats, features) -> None:
        """The ``covariates`` block of each split (importer.py:373-398 of the
        JAX package): built from its clin.csv rows with the types of its whole
        file, then only the columns both splits have, in the training order;
        ``covariate_columns`` keeps each covariate's trained columns."""
        print(f"[INFO] Building covariate matrix: {self.covariates}")
        groups: Dict[str, List[str]] = {}
        blocks = [create_covariate_matrix(self.covariates, types, clin,
                                          groups_out=groups if split == 0 else None)
                  for split, (types, clin) in enumerate(zip(clin_types, clins))]
        (train_names, train_block), (test_names, test_block) = blocks
        kept = [c for c in train_names if c in set(test_names)]
        for (names, block), mat, feats in zip(blocks, mats, features):
            pos = {c: j for j, c in enumerate(names)}
            mat["covariates"] = block[:, [pos[c] for c in kept]].astype(np.float32)
            feats["covariates"] = list(kept)
        self.covariate_columns = {v: [c for c in cols if c in set(kept)]
                                  for v, cols in groups.items()}

    # ---------------------------------------------------------------- main

    def import_data(self):
        print("[INFO] ================= Importing Data =================")
        training_path = os.path.join(self.path, "train")
        testing_path = os.path.join(self.path, "test")
        self.validate_data_folders(training_path, testing_path)

        train_dat = self.read_data(training_path)
        test_dat = self.read_data(testing_path)
        # column types of the whole files, as pandas types them on reading
        clin_types = [get_variable_types(d["clin"]) for d in (train_dat, test_dat)]
        if self.downsample > 0:
            print(f"[INFO] Randomly drawing {self.downsample} training samples")
            train_dat = self.subsample(train_dat, self.downsample)
        if self.restrict_to_features is not None:
            train_dat = self.filter_by_features(train_dat, self.restrict_to_features)
            test_dat = self.filter_by_features(test_dat, self.restrict_to_features)
        self.validate_input_data(train_dat, test_dat)

        train_layers, train_clin, train_samples = self.process_data(train_dat, "train")
        test_layers, test_clin, test_samples = self.process_data(test_dat, "test")
        train_layers, test_layers = self.harmonize(train_layers, test_layers)
        if self.log_transform:
            print("[INFO] log1p-transforming data")
            train_layers = self.transform_data(train_layers)
            test_layers = self.transform_data(test_layers)
        features = {x: d.features for x, d in train_layers.items()}
        train_mats = self.normalize_data(train_layers, fit=True)
        test_mats = self.normalize_data(test_layers, fit=False)
        test_features = dict(features)
        if self.covariates:
            self._add_covariates(clin_types, (train_clin, test_clin),
                                 (train_mats, test_mats), (features, test_features))

        training_dataset = self.get_dataset(train_mats, features, train_clin, train_samples)
        testing_dataset = self.get_dataset(test_mats, test_features, test_clin, test_samples)
        if self.concatenate:
            for ds in (training_dataset, testing_dataset):
                order = [m for m in self.data_types if m in ds.dat]
                order += [m for m in ds.dat if m not in order]
                ds.dat = {"all": np.concatenate([ds.dat[m] for m in order], axis=1)}
                ds.features = {"all": [f for m in order for f in ds.features[m]]}
        self.train_features = dict(training_dataset.features)
        print("[INFO] Training Data Stats:", training_dataset.get_dataset_stats())
        print("[INFO] Test Data Stats:", testing_dataset.get_dataset_stats())

        logs = self.feature_logs
        if "select_features" in logs:
            self.feature_logs = {
                x: merge_logs(logs["cleanup"][x], logs["select_features"][x])
                for x in self.data_types
            }
        else:
            self.feature_logs = logs["cleanup"]
        print("[INFO] Data import successful.")
        return training_dataset, testing_dataset


def merge_logs(cleanup: List[dict], select: List[dict]) -> List[dict]:
    """``pd.merge(cleanup, select, on="feature", how="outer",
    suffixes=["_cleanup", "_laplacian"])``: rows sorted by feature, columns
    present in both logs suffixed, missing cells None."""
    left = [c for c in cleanup[0] if c != "feature"] if cleanup else []
    right = [c for c in select[0] if c != "feature"] if select else []
    both = set(left) & set(right)
    lname = {c: f"{c}_cleanup" if c in both else c for c in left}
    rname = {c: f"{c}_laplacian" if c in both else c for c in right}
    rows: Dict[str, dict] = {}
    for row in cleanup:
        rows[row["feature"]] = {"feature": row["feature"],
                                **{lname[c]: row[c] for c in left},
                                **{rname[c]: None for c in right}}
    for row in select:
        r = rows.setdefault(row["feature"], {"feature": row["feature"],
                                             **{lname[c]: None for c in left}})
        r.update({rname[c]: row[c] for c in right})
    return [rows[f] for f in sorted(rows)]
