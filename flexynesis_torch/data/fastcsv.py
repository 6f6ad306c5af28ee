"""ctypes binding of the port's multi-threaded CSV matrix parser.

Counterpart of ``flexynesis_tpu/data/fastcsv.py``. The C++ reader
(``csrc/fastcsv.cpp``) mmaps a numeric features-as-rows matrix and parses it
in parallel straight into a float32 buffer, one correctly rounded
``std::from_chars`` conversion per cell. It is built with g++ at first use
(``kernels/build.py``); a failed build or load raises with the compiler's
message. Where the parser refuses a file (quoted cells, an R-style header,
ragged rows, cells pandas would not read as numbers), the file goes to the
Python reader ``utils.csvio.read_matrix``, as the JAX package hands such
files to pandas.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..kernels import build
from ..utils.csvio import read_matrix


class _FcsvMatrix(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_float)),
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("row_names", ctypes.POINTER(ctypes.c_char)),
        ("row_names_len", ctypes.c_int64),
        ("col_names", ctypes.POINTER(ctypes.c_char)),
        ("col_names_len", ctypes.c_int64),
        ("error", ctypes.c_char_p),
    ]


def _library() -> ctypes.CDLL:
    lib = build.load("fastcsv")
    lib.fastcsv_read.restype = ctypes.POINTER(_FcsvMatrix)
    lib.fastcsv_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.fastcsv_free.restype = None
    lib.fastcsv_free.argtypes = [ctypes.POINTER(_FcsvMatrix)]
    return lib


def _split_names(blob_ptr, blob_len: int, count: int):
    raw = ctypes.string_at(blob_ptr, blob_len)
    return raw.decode("utf-8", errors="replace").split("\x00")[:count]


def read_matrix_csv(path: str, n_threads: int = 0, fallback: bool = True):
    """(row_names, columns, float32 matrix) of a numeric CSV whose first
    column names the rows, as ``csvio.read_matrix`` returns them; the parser
    runs on ``n_threads`` threads (0: every core). A file the parser refuses
    goes to the Python reader, or with ``fallback`` False raises a
    RuntimeError."""
    lib = _library()
    ptr = lib.fastcsv_read(os.fsencode(path), int(n_threads))
    try:
        m = ptr.contents
        if m.error:
            if not fallback:
                raise RuntimeError(m.error.decode())
            print(f"[WARN] {m.error.decode()}; using the Python reader for {path}")
            names, columns, mat = read_matrix(path)
            return names, columns, mat.astype(np.float32)
        n_rows, n_cols = int(m.n_rows), int(m.n_cols)
        # one flat memmove; np.ctypeslib.as_array would build a
        # ((c_float * n_cols) * n_rows) ctypes type, which costs seconds at
        # matrix scale
        mat = np.empty((n_rows, n_cols), dtype=np.float32)
        ctypes.memmove(mat.ctypes.data, m.data, mat.nbytes)
        return (_split_names(m.row_names, m.row_names_len, n_rows),
                _split_names(m.col_names, m.col_names_len, n_cols), mat)
    finally:
        lib.fastcsv_free(ptr)
