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
    each row's cells are passed through ``convert`` as they are read.

    A header one cell shorter than the first data row (R's
    ``write.table(sep=",")``) names the data columns only; the first cell of
    each row is still its name, as pandas reads such a file (its implicit
    index). Quoted cells may hold commas; a row with fewer cells than the
    header ends in NA cells, and one with more raises, as in pandas."""
    with open(path, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        columns, width = header[1:], len(header)
        names, rows = [], []
        for lineno, row in enumerate(reader, start=2):
            if not row:
                continue
            if not names and len(row) == len(header) + 1:
                columns, width = header, len(row)
            if len(row) > width:
                raise ValueError(
                    f"{path}:{lineno}: {len(row)} cells, header has {len(header)}"
                )
            row += [""] * (width - len(row))  # pandas reads missing cells as NA
            names.append(row[0])
            rows.append(convert(row[1:]))
    return names, columns, rows


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
    index_name: str = ""

    def column(self, name: str) -> np.ndarray:
        """The values of one column (``df[name].values``)."""
        return self.values[:, self.columns.index(name)]

    def take(self, rows) -> "Table":
        """The rows at positions ``rows`` (or where a boolean mask is true), in
        that order (``df.iloc[rows]``)."""
        rows = np.asarray(rows)
        rows = np.flatnonzero(rows) if rows.dtype == bool else rows.astype(np.int64)
        return Table([self.index[i] for i in rows], list(self.columns), self.values[rows],
                     self.index_name)

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow([self.index_name, *self.columns])
            for name, row in zip(self.index, self.values):
                writer.writerow([name, *(format_cell(v) for v in row)])
