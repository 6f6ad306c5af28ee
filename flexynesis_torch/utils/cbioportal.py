"""cBioPortal study fetcher.

Counterpart of ``flexynesis_tpu/utils/cbioportal.py`` without pandas or
requests: downloads (``urllib``) and extracts a study archive from the
cBioPortal datahub into the cache folder (``data.graph.get_cache_dir``),
reads its tab-separated files as pandas reads them (``#`` comments, columns
typed int, float or text), binarizes the long mutations table into a
gene x sample 0/1 ``Table`` and writes a train/test split in the framework's
folder layout (train/{name}.csv, test/...), as ``DataFrame.to_csv`` writes
them.
"""

from __future__ import annotations

import csv
import math
import os
import shutil
import tarfile
from typing import Dict, List, Optional

import numpy as np

from .csvio import NA_VALUES, Table


def _typed(cells: List[str]):
    """A column's cells typed as pandas infers them: ints (float where NA
    cells sit among them), floats, else text with NA cells as NaN."""
    present = [c for c in cells if c not in NA_VALUES]
    for kind in (int, float):
        try:
            vals = [kind(c) for c in present]
        except ValueError:
            continue
        if kind is int and len(present) < len(cells):
            kind = float
        it = iter(vals)
        return np.array([math.nan if c in NA_VALUES else kind(next(it)) for c in cells],
                        dtype=np.int64 if kind is int else np.float64)
    return np.array([math.nan if c in NA_VALUES else c for c in cells], dtype=object)


def read_tsv(path: str):
    """(header, {column: typed cells}) of a tab-separated file whose text
    after a ``#`` on a line is a comment (``pd.read_csv(sep="\\t",
    comment="#")``)."""
    with open(path, newline="") as fh:
        lines = [line.split("#", 1)[0].rstrip("\r\n") for line in fh]
    rows = [r for r in csv.reader((ln for ln in lines if ln.strip()), delimiter="\t")]
    header, body = rows[0], rows[1:]
    width = len(header)
    body = [r + [""] * (width - len(r)) for r in body]
    return header, {name: _typed([r[j] for r in body]) for j, name in enumerate(header)}


class CBioPortalData:
    def __init__(self, study_id: str, base_url: str = "https://datahub.assets.cbioportal.org",
                 cache_dir: Optional[str] = None):
        self.study_id = study_id
        self.base_url = base_url
        from ..data.graph import get_cache_dir

        self.cache_dir = cache_dir or get_cache_dir()
        os.makedirs(self.cache_dir, exist_ok=True)
        self.study_dir = os.path.join(self.cache_dir, study_id)
        self.dat: Dict[str, Table] = {}

    # ------------------------------------------------------------ download

    def download_study_archive(self, force: bool = False, timeout: int = 120) -> str:
        archive = os.path.join(self.cache_dir, f"{self.study_id}.tar.gz")
        if os.path.exists(archive) and not force:
            return archive
        import urllib.request

        url = f"{self.base_url}/{self.study_id}.tar.gz"
        print(f"[INFO] Downloading {url}")
        tmp = archive + ".part"
        with urllib.request.urlopen(url, timeout=timeout) as r, open(tmp, "wb") as fh:
            shutil.copyfileobj(r, fh, 1 << 20)
        os.replace(tmp, archive)
        return archive

    def extract_archive(self, archive_path: str) -> str:
        with tarfile.open(archive_path, "r:gz") as tar:
            tar.extractall(self.cache_dir, filter="data")
        return self.study_dir

    def print_data_files(self) -> None:
        for f in sorted(os.listdir(self.study_dir)):
            print(f)

    # ------------------------------------------------------------- reading

    def read_data(self, files: Optional[Dict[str, str]] = None) -> Dict[str, Table]:
        """files: {short_name: filename}, e.g. {'mut': 'data_mutations.txt'}."""
        files = files or {"clin": "data_clinical_patient.txt", "mut": "data_mutations.txt"}
        out = {}
        for name, fname in files.items():
            header, cols = read_tsv(os.path.join(self.study_dir, fname))
            out[name] = (self.binarize_mutations(header, cols) if name == "mut"
                         else self.process_data(header, cols))
        self.dat = out
        return out

    @staticmethod
    def process_data(header: List[str], cols: Dict[str, np.ndarray]) -> Table:
        """A table indexed by PATIENT_ID (else SAMPLE_ID, else row numbers)."""
        id_col = next((c for c in ("PATIENT_ID", "SAMPLE_ID") if c in cols), None)
        rest = [c for c in header if c != id_col]
        n = len(cols[header[0]]) if header else 0
        index = ([str(v) for v in cols[id_col].tolist()] if id_col
                 else [str(i) for i in range(n)])
        values = np.empty((n, len(rest)), dtype=object)
        for j, c in enumerate(rest):
            values[:, j] = cols[c].tolist()
        return Table(index, rest, values, id_col or "")

    @staticmethod
    def binarize_mutations(header: List[str], cols: Dict[str, np.ndarray]) -> Table:
        """gene x sample 0/1 mutation matrix from a long mutations table:
        genes and samples sorted."""
        sample_col = "Tumor_Sample_Barcode" if "Tumor_Sample_Barcode" in cols else "SAMPLE_ID"
        genes_of = [str(v) for v in cols["Hugo_Symbol"].tolist()]
        samples_of = [str(v) for v in cols[sample_col].tolist()]
        genes, samples = sorted(set(genes_of)), sorted(set(samples_of))
        gi = {g: i for i, g in enumerate(genes)}
        si = {s: i for i, s in enumerate(samples)}
        mat = np.zeros((len(genes), len(samples)), dtype=np.int64)
        for g, s in zip(genes_of, samples_of):
            mat[gi[g], si[s]] = 1
        return Table(genes, samples, mat, "Hugo_Symbol")

    # ----------------------------------------------------------- split/write

    def get_cbioportal_data(self, study_id: str, files=None) -> Dict[str, Table]:
        archive = self.download_study_archive()
        self.extract_archive(archive)
        return self.read_data(files)

    def split_data(self, samples: Optional[List[str]] = None, ratio: float = 0.7):
        """Random train/test sample split across all loaded matrices."""
        if not self.dat:
            raise RuntimeError("No data loaded; call read_data first.")
        if samples is None:
            sets = [set(t.index if name == "clin" else t.columns) for name, t in self.dat.items()]
            samples = sorted(set.intersection(*sets))
        perm = np.random.default_rng(42).permutation(len(samples))
        n_train = int(len(samples) * ratio)
        train = [samples[i] for i in perm[:n_train]]
        test = [samples[i] for i in perm[n_train:]]
        out = {"train": {}, "test": {}}
        for name, t in self.dat.items():
            for split, chosen in (("train", train), ("test", test)):
                if name == "clin":
                    keep = set(chosen)
                    out[split][name] = t.take([i for i, s in enumerate(t.index) if s in keep])
                else:
                    cols = [t.columns.index(c) for c in chosen if c in t.columns]
                    out[split][name] = Table(list(t.index), [t.columns[j] for j in cols],
                                             t.values[:, cols], t.index_name)
        return out

    @staticmethod
    def print_dataset(dataset: dict, outdir: str) -> None:
        """Write the split in the framework's train/test folder layout."""
        for split, tables in dataset.items():
            d = os.path.join(outdir, split)
            os.makedirs(d, exist_ok=True)
            for name, t in tables.items():
                t.to_csv(os.path.join(d, f"{name}.csv"))
        print(f"[INFO] Wrote dataset folders under {outdir}")
