"""StandardScaler and OrdinalEncoder state as the JSON artifact stores it.

flexynesis_tpu keeps fitted sklearn objects and writes their state to JSON
(``flexynesis_tpu/inference.py:232-271``). The port has no sklearn on its
serving path, so it keeps that JSON state as plain dicts and applies it here:

* scaler: ``{"type": "StandardScaler", "with_mean", "with_std", "mean",
  "scale", "var", "n_features_in", "feature_names_in", "n_samples_seen"}``;
* encoder: ``{"type": "OrdinalEncoder", "categories": [[...]],
  "handle_unknown", "unknown_value"[, "encoded_missing_value"]}``, where a
  missing-value category is the string ``"__NaN__"``.

The ``*_to_sklearn`` and ``*_from_sklearn`` functions convert that state to
and from the dict a fitted sklearn object pickles (``__getstate__``: its
attributes in sklearn's order and ``_sklearn_version``), which
``utils/joblib_io`` reads and writes. The version written is
``SKLEARN_VERSION``, scikit-learn 1.9.0, the version that wrote
``tests/fixtures/joblib``; another sklearn warns on loading it, as it does for
any joblib artifact from another version.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..utils.csvio import is_na

NAN_TOKEN = "__NaN__"


def fit_standard_scaler(x: np.ndarray, feature_names: Sequence[str]) -> dict:
    """State of ``StandardScaler().fit(x)`` for x (samples x features), with
    sklearn's arithmetic (the first call of ``_incremental_mean_and_var``:
    the corrected two-pass variance; ``_is_constant_feature`` sets the scale
    of a near-constant feature to 1), so its bits are sklearn's for the same
    x. NaNs are ignored per feature, as sklearn does."""
    x = np.asarray(x)
    if x.dtype not in (np.float32, np.float64):
        x = x.astype(np.float64)
    nan = np.isnan(x)
    op = np.nansum if nan.any() else np.sum

    def total(a):  # sklearn's _safe_accumulator_op: float64 accumulators
        return op(a, axis=0, dtype=np.float64)

    with np.errstate(divide="ignore", invalid="ignore"):
        n = x.shape[0] - total(nan.astype(x.dtype))
        s = total(x)
        mean = (0.0 + s) / n  # sklearn adds the empty running sum (-0.0 becomes 0.0)
        temp = x - s / n
        correction = total(temp)
        temp **= 2
        var = (total(temp) - correction ** 2 / n) / n
        scale = np.sqrt(var)
        eps = np.finfo(np.float64).eps
        scale[var <= n * eps * var + (n * mean * eps) ** 2] = 1.0
    return {
        "type": "StandardScaler",
        "with_mean": True,
        "with_std": True,
        "mean": mean.tolist(),
        "scale": scale.tolist(),
        "var": var.tolist(),
        "n_features_in": int(x.shape[1]),
        "feature_names_in": list(feature_names),
        "n_samples_seen": int(n[0]) if n.size and (n == n[0]).all() else n.tolist(),
    }


def apply_standard_scaler(state: dict, x: np.ndarray) -> np.ndarray:
    """``scaler.transform(x)`` in float64: (x - mean) / scale as configured."""
    x = np.array(x, dtype=np.float64)
    if state.get("with_mean", True) and state.get("mean") is not None:
        x -= np.asarray(state["mean"], dtype=np.float64)
    if state.get("with_std", True) and state.get("scale") is not None:
        x /= np.asarray(state["scale"], dtype=np.float64)
    return x


def ordinal_encoder_state(categories: Sequence) -> dict:
    """State of an OrdinalEncoder fitted on one column with these sorted
    categories (unknown values encode as -1)."""
    return {
        "type": "OrdinalEncoder",
        "categories": [list(categories)],
        "handle_unknown": "use_encoded_value",
        "unknown_value": -1,
        "encoded_missing_value": NAN_TOKEN,
    }


def normalize_encoder_state(state: dict) -> dict:
    """Reference artifacts may carry a LabelEncoder (reference
    __main__.py:1719-1723): same class order, unknowns -> -1."""
    if state.get("type") == "LabelEncoder":
        return ordinal_encoder_state(state["classes"])
    return state


def encoder_categories(state: dict) -> List:
    """The categories of the encoded column, NaN as float('nan')."""
    return [np.nan if c == NAN_TOKEN else c for c in state["categories"][0]]


def encoder_mapping(state: dict) -> Dict[int, object]:
    """code -> class name, with -1 (the unseen/missing sentinel) -> 'Unknown'."""
    mapping = {i: c for i, c in enumerate(encoder_categories(state))}
    mapping[-1] = "Unknown"
    return mapping


def _matches(cell: str, category) -> bool:
    if isinstance(category, str):
        return cell == category
    try:
        return float(cell) == float(category)
    except ValueError:
        return False


def encode_labels(state: dict, cells: Sequence[str]) -> np.ndarray:
    """float32 codes of raw CSV cells: missing values -> -1, unknown values
    -> the encoder's ``unknown_value`` (-1)."""
    categories = encoder_categories(state)
    unknown = float(state.get("unknown_value", -1))
    out = np.full(len(cells), -1, dtype=np.float32)
    for n, cell in enumerate(cells):
        if is_na(cell):
            continue
        out[n] = next(
            (i for i, c in enumerate(categories)
             if not (isinstance(c, float) and np.isnan(c)) and _matches(cell, c)),
            unknown,
        )
    return out


# ------------------------------------------------- sklearn's pickled state

SKLEARN_VERSION = "1.9.0"


def _json_safe(v):
    """A category as the JSON artifact holds it (flexynesis_tpu/inference.py:274-281)."""
    if isinstance(v, float) and np.isnan(v):
        return NAN_TOKEN
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    return v


def scaler_to_sklearn(state: dict) -> dict:
    """The pickled state of the StandardScaler that ``state`` describes, as
    scikit-learn 1.9 fits it (``n_samples_seen_`` a float64 scalar, or an
    array where features saw different counts)."""
    out = {"with_mean": state.get("with_mean", True), "with_std": state.get("with_std", True),
           "copy": True}
    if "feature_names_in" in state:
        out["feature_names_in_"] = np.asarray(state["feature_names_in"], dtype=object)
    if "n_features_in" in state:
        out["n_features_in_"] = int(state["n_features_in"])
    if "n_samples_seen" in state:
        n = np.asarray(state["n_samples_seen"], dtype=np.float64)
        out["n_samples_seen_"] = n if n.ndim else n[()]
    for key in ("mean", "var", "scale"):
        if key in state:
            v = state[key]
            out[f"{key}_"] = None if v is None else np.asarray(v, dtype=np.float64)
    out["_sklearn_version"] = SKLEARN_VERSION
    return out


def scaler_from_sklearn(state: dict) -> dict:
    """The JSON state of a pickled StandardScaler, as
    ``flexynesis_tpu/inference.py::_scaler_to_json`` gives it."""
    d = {"type": "StandardScaler", "with_mean": state["with_mean"],
         "with_std": state["with_std"]}
    for attr, key in (("mean_", "mean"), ("scale_", "scale"), ("var_", "var")):
        if attr in state:
            d[key] = np.asarray(state[attr]).tolist()
    if "n_features_in_" in state:
        d["n_features_in"] = int(state["n_features_in_"])
    if "feature_names_in_" in state:
        d["feature_names_in"] = list(state["feature_names_in_"])
    if "n_samples_seen_" in state:
        n = state["n_samples_seen_"]
        d["n_samples_seen"] = n.tolist() if isinstance(n, np.ndarray) else int(n)
    return d


def encoder_to_sklearn(state: dict, feature_name: str) -> dict:
    """The pickled state of ``OrdinalEncoder(handle_unknown=...,
    unknown_value=...)`` fitted on the one column ``feature_name`` (a
    ``Series.to_frame()``, as ``flexynesis_tpu/data/importer.py:290-293``
    fits it), its categories ``state`` holds."""
    state = normalize_encoder_state(state)
    categories = [np.asarray(encoder_categories({"categories": [c]}), dtype=object)
                  for c in state["categories"]]
    missing = state.get("encoded_missing_value", NAN_TOKEN)
    return {
        "categories": "auto",
        "dtype": np.float64,
        "handle_unknown": state.get("handle_unknown", "use_encoded_value"),
        "unknown_value": state.get("unknown_value", -1),
        "encoded_missing_value": np.nan if missing == NAN_TOKEN else missing,
        "min_frequency": None,
        "max_categories": None,
        "_infrequent_enabled": False,
        "feature_names_in_": np.asarray([feature_name], dtype=object),
        "n_features_in_": len(categories),
        "categories_": categories,
        "_missing_indices": {i: c.index(NAN_TOKEN)
                             for i, c in enumerate(state["categories"]) if NAN_TOKEN in c},
        "_sklearn_version": SKLEARN_VERSION,
    }


def encoder_from_sklearn(state: dict) -> dict:
    """The JSON state of a pickled OrdinalEncoder, as
    ``flexynesis_tpu/inference.py::_encoder_to_json`` gives it."""
    d = {"type": "OrdinalEncoder",
         "categories": [[_json_safe(v) for v in c] for c in state["categories_"]],
         "handle_unknown": state["handle_unknown"],
         "unknown_value": state["unknown_value"]}
    if "encoded_missing_value" in state:
        d["encoded_missing_value"] = _json_safe(state["encoded_missing_value"])
    return d


def label_encoder_from_sklearn(state: dict) -> dict:
    """A pickled LabelEncoder (reference artifacts) as the OrdinalEncoder
    state ``normalize_encoder_state`` gives it."""
    return normalize_encoder_state(
        {"type": "LabelEncoder", "classes": [_json_safe(v) for v in state["classes_"]]})
