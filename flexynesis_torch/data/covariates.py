"""Clinical covariates as an extra input block, without pandas.

Counterpart of ``flexynesis_tpu/data/covariates.py`` (reference
utils.py:1702-1764). The JAX package reads clin.csv with ``pd.read_csv`` and
takes each column's type from the dtype pandas infers for the whole file;
here the cells are classified as pandas classifies them:

* a column whose every non-missing cell parses as a number (pandas' default
  NA spellings and empty cells are missing; surrounding blanks allowed, so
  `` 2`` is 2) is numerical; an all-missing column is numerical (float64 NaN);
* a column of booleans (``True``/``TRUE``/``true`` and ``False``/``FALSE``/
  ``false``) with no missing cell is numerical (pandas' bool dtype, 1 and 0);
* anything else is categorical, a boolean column with a missing cell
  included (pandas' object dtype of True, False and NaN: its levels are
  ``False`` and ``True``), the cells of the others kept as written.

``create_covariate_matrix`` one-hot encodes a categorical covariate as 0/1
columns ``<var>_<level>``, its levels sorted, a missing value an all-zero row
(``pd.get_dummies``), and fills a numerical covariate's missing values with
its median over the given rows; it returns the column names and a (samples,
columns) matrix, and fills ``groups_out`` with each covariate's columns.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.csvio import NA_VALUES

TRUE_CELLS = frozenset({"True", "TRUE", "true"})
FALSE_CELLS = frozenset({"False", "FALSE", "false"})


def _number(cell: str) -> float:
    """The float of a numeric cell as pandas' parser reads it; ValueError
    otherwise (Python's ``float`` also takes ``1_000``, pandas does not)."""
    if "_" in cell:
        raise ValueError(cell)
    return float(cell)


def _is_boolean(present: Sequence[str]) -> bool:
    return all(c in TRUE_CELLS or c in FALSE_CELLS for c in present)


def numerical_values(cells: Sequence[str]) -> np.ndarray:
    """float64 values of a numerical column (1 and 0 for booleans, NaN where
    missing); ValueError where a cell is text."""
    if _is_boolean([c for c in cells if c not in NA_VALUES]):
        return np.array([np.nan if c in NA_VALUES else float(c in TRUE_CELLS)
                         for c in cells])
    return np.array([np.nan if c in NA_VALUES else _number(c) for c in cells],
                    dtype=np.float64)


def categorical_levels(cells: Sequence[str]) -> List[Optional[str]]:
    """Each cell's level: "True"/"False" in a boolean column, else the
    cell's text; None where missing."""
    present = [c for c in cells if c not in NA_VALUES]
    if present and _is_boolean(present):
        return [None if c in NA_VALUES else str(c in TRUE_CELLS) for c in cells]
    return [None if c in NA_VALUES else c for c in cells]


def column_type(cells: Sequence[str]) -> str:
    """pandas' reading of a column: "numerical" for numbers (or no value at
    all) and for booleans without a missing cell, else "categorical"."""
    present = [c for c in cells if c not in NA_VALUES]
    if present and _is_boolean(present):
        return "numerical" if len(present) == len(cells) else "categorical"
    try:
        for c in present:
            _number(c)
    except ValueError:
        return "categorical"
    return "numerical"


def get_variable_types(clin) -> Dict[str, str]:
    """{column: "categorical" or "numerical"} of a ``Clinical`` table, as
    pandas' dtypes of the same file give them."""
    return {col: column_type(clin.column(col)) for col in clin.columns}


def create_covariate_matrix(covariates: List[str], variable_types: Dict[str, str], clin,
                            groups_out: Optional[Dict[str, List[str]]] = None
                            ) -> Tuple[List[str], np.ndarray]:
    """(column names, (samples, columns) float64 matrix) of the covariates
    over the rows of ``clin``; ``variable_types`` (of the whole file, as
    pandas types a column before rows are dropped) decides each covariate's
    encoding. Levels sort as ``pd.get_dummies`` sorts them ("False" before
    "True")."""
    names: List[str] = []
    blocks: List[np.ndarray] = []
    for var in covariates:
        vtype = variable_types.get(var)
        cells = clin.column(var)
        if vtype == "categorical":
            values = categorical_levels(cells)
            levels = sorted({c for c in values if c is not None})
            cols = [f"{var}_{lv}" for lv in levels]
            pos = {lv: j for j, lv in enumerate(levels)}
            block = np.zeros((len(values), len(levels)))
            for i, c in enumerate(values):
                if c is not None:
                    block[i, pos[c]] = 1.0
        elif vtype == "numerical":
            col = numerical_values(cells)
            missing = np.isnan(col)
            if missing.any() and not missing.all():
                col[missing] = np.median(col[~missing])
            cols, block = [var], col[:, None]
        else:
            raise ValueError(f"Unknown variable type for {var}: {vtype}")
        names.extend(cols)
        blocks.append(block)
        if groups_out is not None:
            groups_out[var] = list(cols)
    matrix = np.concatenate(blocks, axis=1) if blocks else np.zeros((len(clin.samples), 0))
    return names, matrix
