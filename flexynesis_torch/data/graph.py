"""Gene-interaction graphs: STRING-DB links and user-provided networks.

Counterpart of ``flexynesis_tpu/data/graph.py`` (reference data.py:1307-1646)
without pandas. A graph is a dict of columns, ``protein1`` and ``protein2``
(lists of node names) and, for a user graph, ``weight`` (float64 array), which
``data/dataset.py::MultiOmicDatasetNW`` reads as the JAX package reads its
DataFrame.

* ``STRING`` - STRING v12.0 links and aliases of an organism from a cache
  folder (``FLEXYNESIS_CACHE``), filtered to combined_score > 400 and each
  protein's top-5 partners, nodes mapped to gene names or Ensembl gene ids.
  The raw gz files keep the JAX package's cache names; the filtered table is
  cached as a tab-separated ``.tsv`` beside them (JAX writes parquet). A file
  missing from the cache is downloaded under a lock (``fcntl``).
* ``read_user_graph`` - GeneA/GeneB[/Score] tables with separator sniffing
  and fuzzy column matching (exact > substring > fuzzy ratio, position and
  dtype bonuses, acceptance threshold 30).
"""

from __future__ import annotations

import csv
import gzip
import os
import tempfile
from difflib import SequenceMatcher
from typing import Dict, List, Optional

import numpy as np

# the strings pandas.read_csv reads as NaN by default
_NA_VALUES = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
    "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
    "nan", "null",
})


def get_cache_dir() -> str:
    env = os.environ.get("FLEXYNESIS_CACHE")
    if env:
        return env
    return os.path.join(tempfile.gettempdir(), "flexynesis_tpu_cache")


def _fetch(url: str, dest: str) -> str:
    """``dest``, downloaded from ``url`` first if it is not there; one
    process downloads while the others wait on the lock."""
    if os.path.exists(dest):
        return dest
    import fcntl
    import urllib.request

    with open(dest + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(dest):
                print(f"[INFO] Downloading {url}")
                tmp = dest + ".part"
                with urllib.request.urlopen(url, timeout=300) as r, open(tmp, "wb") as fh:
                    while True:
                        chunk = r.read(1 << 20)
                        if not chunk:
                            break
                        fh.write(chunk)
                os.replace(tmp, dest)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return dest


class STRING:
    """STRING v12.0 links/aliases loader with on-disk caching; the graph is
    ``graph_df`` (columns protein1, protein2, combined_score)."""

    BASE_LINKS = (
        "https://stringdb-downloads.org/download/protein.links.v12.0/"
        "{organism}.protein.links.v12.0.txt.gz"
    )
    BASE_ALIASES = (
        "https://stringdb-downloads.org/download/protein.aliases.v12.0/"
        "{organism}.protein.aliases.v12.0.txt.gz"
    )

    def __init__(self, root: Optional[str] = None, organism: int = 9606,
                 node_name: str = "gene_name", score_threshold: int = 400,
                 top_k: int = 5):
        self.root = root or get_cache_dir()
        self.organism = organism
        self.node_name = node_name
        self.score_threshold = score_threshold
        self.top_k = top_k
        os.makedirs(self.root, exist_ok=True)
        self.graph_df = self._load()

    def _load(self) -> Dict[str, list]:
        cache = os.path.join(
            self.root,
            f"string_{self.organism}_{self.node_name}_{self.score_threshold}"
            f"_{self.top_k}.tsv",
        )
        if os.path.exists(cache):
            return _read_cache(cache)
        links_gz = _fetch(self.BASE_LINKS.format(organism=self.organism),
                          os.path.join(self.root, f"{self.organism}.links.txt.gz"))
        alias_gz = _fetch(self.BASE_ALIASES.format(organism=self.organism),
                          os.path.join(self.root, f"{self.organism}.aliases.txt.gz"))
        links = read_stringdb_links(links_gz, self.score_threshold, self.top_k)
        if self.node_name != "protein_id":
            alias = read_stringdb_aliases(alias_gz, self.node_name)
            keep = [i for i, (a, b) in enumerate(zip(links["protein1"], links["protein2"]))
                    if a in alias and b in alias]
            links = {
                "protein1": [alias[links["protein1"][i]] for i in keep],
                "protein2": [alias[links["protein2"][i]] for i in keep],
                "combined_score": links["combined_score"][keep],
            }
        try:
            _write_cache(cache, links)
        except OSError:
            pass
        return links


def _write_cache(path: str, links: Dict[str, list]) -> None:
    tmp = path + ".part"
    with open(tmp, "w", newline="") as fh:
        w = csv.writer(fh, delimiter="\t", lineterminator="\n")
        w.writerow(["protein1", "protein2", "combined_score"])
        w.writerows(zip(links["protein1"], links["protein2"],
                        (int(s) for s in links["combined_score"])))
    os.replace(tmp, path)


def _read_cache(path: str) -> Dict[str, list]:
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh, delimiter="\t"))[1:]
    return {"protein1": [r[0] for r in rows], "protein2": [r[1] for r in rows],
            "combined_score": np.asarray([int(r[2]) for r in rows], dtype=np.int64)}


def _descending_order(values: np.ndarray) -> np.ndarray:
    """The row order of pandas' ``sort_values(ascending=False)`` (its default
    quicksort through ``nargsort``), so that ties keep the JAX package's
    order."""
    idx = np.arange(len(values))[::-1]
    return idx[values[::-1].argsort(kind="quicksort")][::-1]


def read_stringdb_links(path: str, score_threshold: int = 400,
                        top_k: int = 5) -> Dict[str, list]:
    """Parse protein.links: keep combined_score > ``score_threshold``, then
    each protein1's ``top_k`` strongest rows, strongest first."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        next(fh)
        rows = [line.split() for line in fh if line.strip()]
    p1 = [r[0] for r in rows]
    p2 = [r[1] for r in rows]
    score = np.asarray([int(r[2]) for r in rows], dtype=np.int64)
    keep = np.flatnonzero(score > score_threshold)
    order = keep[_descending_order(score[keep])]
    seen: Dict[str, int] = {}
    picked = []
    for i in order:
        n = seen.get(p1[i], 0)
        if n < top_k:
            picked.append(i)
        seen[p1[i]] = n + 1
    return {"protein1": [p1[i] for i in picked], "protein2": [p2[i] for i in picked],
            "combined_score": score[np.asarray(picked, dtype=np.int64)]}


def read_stringdb_aliases(path: str, node_name: str = "gene_name") -> dict:
    """protein id -> gene symbol (or Ensembl gene id) from the aliases file."""
    source = "Ensembl_HGNC_symbol" if node_name == "gene_name" else "Ensembl_gene"
    mapping = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        next(fh)
        for line in fh:
            pid, alias, src = line.rstrip("\n").split("\t")[:3]
            if source in src and pid not in mapping:
                mapping[pid] = alias
    return mapping


# ------------------------------------------------------------- user graphs


def _sniff_sep(path: str) -> str:
    with open(path) as fh:
        sample = fh.read(8192)
    try:
        return csv.Sniffer().sniff(sample, delimiters=",;\t| ").delimiter
    except csv.Error:
        return ","


def _to_float(cell: str) -> float:
    return np.nan if cell.strip() in _NA_VALUES else float(cell)


def _floats(cells: List[str]) -> Optional[np.ndarray]:
    """The float64 values of a column pandas would give a numeric dtype
    (every cell a number or one of its NA strings, read as NaN), else None.
    Plain numbers convert in one numpy call; a column holding NA strings
    takes the cell-by-cell path."""
    try:
        return np.asarray(cells, dtype=np.float64)
    except ValueError:
        pass
    try:
        return np.array([_to_float(c) for c in cells], dtype=np.float64)
    except ValueError:
        return None


def _as_str(cells: List[str], floats: Optional[np.ndarray] = None) -> List[str]:
    """``astype(str)`` of the column as pandas would read it: numbers in
    their dtype's repr, NA cells as 'nan'; ``floats`` the column's values
    where it is numeric."""
    if floats is None:
        return ["nan" if c in _NA_VALUES else c for c in cells]
    values = floats.tolist()
    if all(np.isfinite(v) and "." not in c and "e" not in c.lower()
           for v, c in zip(values, cells)):
        return [str(int(c)) for c in cells]
    return [str(v) for v in values]


def _score_column(name: str, is_numeric: bool, role: str, position: int) -> float:
    """Heuristic score for how well a column fits a role (geneA/geneB/score)."""
    name = str(name).lower()
    targets = {
        "genea": ["genea", "gene_a", "gene1", "protein1", "source", "from", "node1"],
        "geneb": ["geneb", "gene_b", "gene2", "protein2", "target", "to", "node2"],
        "score": ["score", "weight", "combined_score", "confidence", "corr"],
    }[role]
    s = 0.0
    if name in targets:
        s += 100
    elif any(t in name for t in targets):
        s += 60
    else:
        s += 40 * max(SequenceMatcher(None, name, t).ratio() for t in targets)
    expected_pos = {"genea": 0, "geneb": 1, "score": 2}[role]
    if position == expected_pos:
        s += 15
    if role == "score":
        s += 20 if is_numeric else -30
    else:
        s += 10 if not is_numeric else -20
    return s


def read_user_graph(path: str, sep: Optional[str] = None, gene_a: Optional[str] = None,
                    gene_b: Optional[str] = None, score_col: Optional[str] = None,
                    accept_threshold: float = 30.0) -> Dict[str, list]:
    """Read a GeneA/GeneB[/Score] network with fuzzy column detection.

    Returns columns protein1, protein2 (lists of names) and weight (float64,
    1.0 without a score column); rows with an unparsable score are dropped."""
    sep = sep or _sniff_sep(path)
    with open(path, newline="") as fh:
        rows = [r for r in csv.reader(fh, delimiter=sep) if r]
    header, body = rows[0], rows[1:]
    if len(header) < 2:
        raise ValueError(
            f"User graph file needs >=2 columns (GeneA, GeneB[, Score]); "
            f"got {len(header)} with separator '{sep}'"
        )
    width = len(header)
    if any(len(r) < width for r in body):  # short rows end in empty cells
        body = [r + [""] * (width - len(r)) for r in body]
    columns = dict(zip(header, (list(c) for c in zip(*body)))) if body else \
        {name: [] for name in header}
    cols = list(header)
    floats = {c: _floats(columns[c]) for c in cols}  # each column parsed once
    picked: Dict[str, str] = {}
    for role, override in (("genea", gene_a), ("geneb", gene_b), ("score", score_col)):
        if override is not None:
            picked[role] = override
            continue
        scores = {c: _score_column(c, floats[c] is not None, role, cols.index(c))
                  for c in cols if c not in picked.values()}
        if not scores:
            continue  # e.g. 2-column files have no score candidate left
        best_col, best_score = max(scores.items(), key=lambda kv: kv[1])
        if best_score >= accept_threshold:
            picked[role] = best_col

    if "genea" not in picked or "geneb" not in picked:
        raise ValueError("Could not identify GeneA/GeneB columns in user graph.")
    a = _as_str(columns[picked["genea"]], floats[picked["genea"]])
    b = _as_str(columns[picked["geneb"]], floats[picked["geneb"]])
    if "score" in picked:
        weight = floats[picked["score"]]
        if weight is None:
            w = []
            for c in columns[picked["score"]]:
                try:
                    w.append(_to_float(c))
                except ValueError:
                    w.append(np.nan)
            weight = np.asarray(w, dtype=np.float64)
    else:
        weight = np.ones(len(a), dtype=np.float64)
    keep = np.flatnonzero(~np.isnan(weight))
    if len(keep) < len(weight):
        a, b = [a[i] for i in keep], [b[i] for i in keep]
    out = {"protein1": a, "protein2": b, "weight": weight[keep]}
    print(
        f"[INFO] User graph: {len(keep)} edges "
        f"(columns: {picked.get('genea')}, {picked.get('geneb')}, "
        f"{picked.get('score', '<none>')})"
    )
    return out
