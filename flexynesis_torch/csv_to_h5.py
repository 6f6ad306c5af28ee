"""CSV -> HDF5 converter, without h5py.

Counterpart of ``flexynesis_tpu/csv_to_h5.py``: turns a features x samples
CSV into the layout ``H5DataImporter`` reads, ``/matrix`` float32 (samples,
features), ``/sample_ids`` and ``/feature_names`` fixed-length byte strings
(``utils/hdf5.py::MatrixWriter``). The CSV is parsed by the port's native
reader (``data/fastcsv.py``), ``chunksize`` feature rows at a time, so the
values are the bits the CSV import gives and memory holds one block; each
block goes into its columns of the matrix through a memory map. The matrix
is contiguous, not chunked: readers load it whole, and JAX's chunk shape
only serves h5py's column-slice writes.

Usage: python -m flexynesis_torch.csv_to_h5 --input in.csv --output out.h5
       python -m flexynesis_torch.csv_to_h5 --input data_dir --output out_dir
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from .data.fastcsv import read_matrix_csv
from .utils.hdf5 import MatrixWriter

DEFAULT_CHUNKSIZE = 2000


def _blocks(src: Path, tmp: Path, chunksize: int):
    """(feature names, sample ids, float32 block) of each run of ``chunksize``
    data rows, each parsed as a CSV of the header and those rows."""
    with open(src, "rb") as fh:
        header = fh.readline()
        while True:
            rows = []
            for line in fh:
                if line.strip():
                    rows.append(line if line.endswith(b"\n") else line + b"\n")
                    if len(rows) == chunksize:
                        break
            if not rows:
                return
            tmp.write_bytes(header + b"".join(rows))
            yield read_matrix_csv(str(tmp))


def convert_csv_to_h5(src_csv, dst_h5, chunksize: int = DEFAULT_CHUNKSIZE) -> Path:
    """Convert one feature-matrix CSV (features x samples) to HDF5."""
    src_csv, dst_h5 = Path(src_csv), Path(dst_h5)
    if not src_csv.exists():
        raise FileNotFoundError(f"Input CSV not found: {src_csv}")
    dst_h5.parent.mkdir(parents=True, exist_ok=True)
    with open(src_csv, "rb") as fh:
        fh.readline()
        n_features = sum(1 for line in fh if line.strip())
    tmp = dst_h5.with_name(f".{dst_h5.name}.block.csv")
    writer, row = None, 0
    feature_names = []
    try:
        for names, samples, block in _blocks(src_csv, tmp, max(1, chunksize)):
            if writer is None:
                sample_ids = samples
                print(f"[INFO] {src_csv.name}: {len(sample_ids):,} samples x "
                      f"{n_features:,} features")
                writer = MatrixWriter(dst_h5, len(sample_ids), n_features)
            elif samples != sample_ids:
                raise ValueError(f"{src_csv}: the header of a block differs")
            writer.matrix[:, row:row + len(names)] = block.T
            feature_names += names
            row += len(names)
        if writer is None:  # no data rows: the header's samples, no features
            sample_ids = read_matrix_csv(str(src_csv))[1]
            writer = MatrixWriter(dst_h5, len(sample_ids), 0)
        if row != n_features:
            raise ValueError(f"Row mismatch: expected {n_features} features, read {row}")
        writer.close([s.encode() for s in sample_ids], [g.encode() for g in feature_names])
    finally:
        if tmp.exists():
            os.remove(tmp)
    print(f"[INFO] Wrote {dst_h5}")
    return dst_h5


def main(argv=None):
    ap = argparse.ArgumentParser(description="Convert flexynesis CSVs to HDF5")
    ap.add_argument("--input", required=True, help="CSV file or folder of CSVs")
    ap.add_argument("--output", required=True, help="Output .h5 file or folder")
    ap.add_argument("--chunksize", type=int, default=DEFAULT_CHUNKSIZE)
    ap.add_argument("--exclude", default="clin", help="Comma-separated basenames to skip")
    args = ap.parse_args(argv)

    src = Path(args.input)
    excl = set(args.exclude.split(","))
    if src.is_dir():
        out_dir = Path(args.output)
        for csv in sorted(src.glob("*.csv")):
            if csv.stem in excl:
                continue
            convert_csv_to_h5(csv, out_dir / f"{csv.stem}.h5", args.chunksize)
    else:
        convert_csv_to_h5(src, args.output, args.chunksize)


if __name__ == "__main__":
    main()
