"""A numpy codec for the safetensors file format.

Layout: an 8-byte little-endian header length, a JSON header mapping each
tensor name to ``{"dtype", "shape", "data_offsets": [begin, end]}`` (offsets
into the data section, plus an optional ``"__metadata__"`` of strings), then
the raw little-endian buffers. Files written here load with
``safetensors.numpy.load_file`` and the reverse; the port's serving path does
not need the ``safetensors`` package.
"""

from __future__ import annotations

import json
from typing import Dict, Optional

import numpy as np

_DTYPES = {
    "F64": np.float64, "F32": np.float32, "F16": np.float16,
    "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
    "U64": np.uint64, "U32": np.uint32, "U16": np.uint16, "U8": np.uint8,
    "BOOL": np.bool_,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def save_file(tensors: Dict[str, np.ndarray], path: str,
              metadata: Optional[Dict[str, str]] = None) -> None:
    header: dict = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    buffers, offset = [], 0
    for name in sorted(tensors):
        arr = np.asarray(tensors[name])
        if arr.dtype not in _NAMES:
            raise TypeError(f"{name}: dtype {arr.dtype} has no safetensors code")
        data = np.ascontiguousarray(arr, dtype=arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {
            "dtype": _NAMES[arr.dtype],
            "shape": list(arr.shape),
            "data_offsets": [offset, offset + len(data)],
        }
        buffers.append(data)
        offset += len(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as fh:
        fh.write(len(raw).to_bytes(8, "little"))
        fh.write(raw)
        for data in buffers:
            fh.write(data)


def load_file(path: str) -> Dict[str, np.ndarray]:
    with open(path, "rb") as fh:
        blob = fh.read()
    if len(blob) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    n = int.from_bytes(blob[:8], "little")
    if 8 + n > len(blob):
        raise ValueError(f"{path}: header length {n} exceeds the file")
    header = json.loads(blob[8:8 + n])
    data = memoryview(blob)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = np.dtype(_DTYPES[info["dtype"]]).newbyteorder("<")
        begin, end = info["data_offsets"]
        shape = tuple(info["shape"])
        if not 0 <= begin <= end <= len(data):
            raise ValueError(f"{path}: offsets of '{name}' lie outside the data")
        if end - begin != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{path}: '{name}' size does not match its shape")
        arr = np.frombuffer(data[begin:end], dtype=dtype).reshape(shape)
        out[name] = arr.astype(dtype.newbyteorder("="))
    return out
