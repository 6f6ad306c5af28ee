"""StandardScaler and OrdinalEncoder state as the JSON artifact stores it.

flexynesis_tpu keeps fitted sklearn objects and writes their state to JSON
(``flexynesis_tpu/inference.py:232-271``). The port has no sklearn on its
serving path, so it keeps that JSON state as plain dicts and applies it here:

* scaler: ``{"type": "StandardScaler", "with_mean", "with_std", "mean",
  "scale", "var", "n_features_in", "feature_names_in", "n_samples_seen"}``;
* encoder: ``{"type": "OrdinalEncoder", "categories": [[...]],
  "handle_unknown", "unknown_value"[, "encoded_missing_value"]}``, where a
  missing-value category is the string ``"__NaN__"``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..utils.csvio import is_na

NAN_TOKEN = "__NaN__"


def fit_standard_scaler(x: np.ndarray, feature_names: Sequence[str]) -> dict:
    """State of ``StandardScaler().fit(x)`` for x (samples x features); NaNs
    are ignored per feature, as sklearn does."""
    x = np.asarray(x, dtype=np.float64)
    mean = np.nanmean(x, axis=0)
    var = np.nanvar(x, axis=0)
    scale = np.sqrt(var)
    scale[scale == 0.0] = 1.0
    seen = np.sum(~np.isnan(x), axis=0)
    return {
        "type": "StandardScaler",
        "with_mean": True,
        "with_std": True,
        "mean": mean.tolist(),
        "scale": scale.tolist(),
        "var": var.tolist(),
        "n_features_in": int(x.shape[1]),
        "feature_names_in": list(feature_names),
        "n_samples_seen": seen.tolist() if (seen != x.shape[0]).any() else int(x.shape[0]),
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
