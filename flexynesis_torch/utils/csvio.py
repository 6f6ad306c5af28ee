"""CSV reading and writing with the standard library, laid out as pandas does.

The port's serving path runs where pandas is not installed. Files are read as
``pd.read_csv(path, index_col=0)`` reads them (first column = row names, the
usual NA spellings = NaN) and written as ``DataFrame.to_csv`` writes them
(NaN and None as empty cells, floats in their shortest round-trip form).
"""

from __future__ import annotations

import csv
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

# pandas.read_csv's default NA spellings
NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def is_na(cell: str) -> bool:
    return cell in NA_VALUES


def parse_floats(cells: Sequence[str]) -> np.ndarray:
    """float64 values of CSV cells; NA spellings become NaN."""
    nan = math.nan
    return np.array([nan if c in NA_VALUES else float(c) for c in cells],
                    dtype=np.float64)


def read_table(path: str, convert=list):
    """(row_names, columns, rows) of a CSV whose first column names the rows;
    each row's cells are passed through ``convert`` as they are read."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        names, rows = [], []
        for lineno, row in enumerate(reader, start=2):
            if not row:
                continue
            if len(row) != len(header):
                raise ValueError(
                    f"{path}:{lineno}: {len(row)} cells, header has {len(header)}"
                )
            names.append(row[0])
            rows.append(convert(row[1:]))
    return names, header[1:], rows


def read_matrix(path: str):
    """(row_names, columns, float64 matrix) of a numeric CSV."""
    names, columns, rows = read_table(path, parse_floats)
    return names, columns, np.vstack(rows) if rows else np.zeros((0, len(columns)))


def format_cell(v) -> str:
    if v is None:
        return ""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else str(v)
    return str(v)


def write_rows(path: str, rows: List[Dict]) -> None:
    """Write row dicts as ``pd.DataFrame(rows).to_csv(path, index=False)`` does."""
    with open(path, "w", newline="") as fh:
        if not rows:
            fh.write("\n")
            return
        columns = list(rows[0])
        writer = csv.writer(fh, lineterminator="\n")
        writer.writerow(columns)
        for r in rows:
            writer.writerow([format_cell(r.get(c)) for c in columns])


@dataclass
class Table:
    """A sample-indexed numeric table (what the JAX package returns as a DataFrame)."""

    index: List[str]
    columns: List[str]
    values: np.ndarray

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(["", *self.columns])
            for name, row in zip(self.index, self.values):
                writer.writerow([name, *(format_cell(v) for v in row)])
