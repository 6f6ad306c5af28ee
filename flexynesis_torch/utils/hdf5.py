"""The HDF5 subset that flexynesis' matrix files use, read and written with
the standard library and numpy (no h5py).

``read_datasets`` reads what h5py writes under its default ``libver``
("earliest"): superblock version 0 or 1, version-1 object headers (with
continuation blocks), the root group's symbol table (a version-1 group
B-tree of any depth over symbol table nodes, names in a local heap), and
datasets whose messages are a dataspace (version 1 or 2), a datatype
(IEEE float32 little-endian, or fixed-length strings padded NULLTERM or
NULLPAD), fill values and a version-3 layout: contiguous (allocated, or not
yet allocated, which reads as the fill value) or chunked, through a
version-1 chunk B-tree (node type 1) of any depth. Anything else raises
``ValueError`` naming what it met: another superblock, object header,
layout or message version, a compact layout, an external file, another
datatype, and any filter pipeline (gzip, shuffle, ...), by the filter's
name. Nothing outside this list is guessed at.

``MatrixWriter`` writes the layout ``csv_to_h5`` makes: ``/matrix`` float32
(samples, features), contiguous, streamed in through a memory map, and
``/sample_ids`` and ``/feature_names`` as fixed-length NULLPAD byte strings,
in the same superblock-0 structures, so h5py and the JAX package read it.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, List, Optional, Sequence

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# message types (HDF5 file format specification, section IV.A.2)
NIL, DATASPACE, DATATYPE, FILL_OLD, FILL, EXTERNAL, LAYOUT = 0x0, 0x1, 0x3, 0x4, 0x5, 0x7, 0x8
FILTERS, CONTINUATION, SYMBOL_TABLE = 0xB, 0x10, 0x11
FILTER_NAMES = {1: "deflate (gzip)", 2: "shuffle", 3: "fletcher32", 4: "szip",
                5: "nbit", 6: "scaleoffset"}
# messages that change nothing this reader returns
IGNORED = {NIL, 0xC, 0xD, 0xE, 0x12, 0x15, 0x16, 0x2, 0x6, 0xA, 0x13, 0x14, 0x17, 0x18}
STRING_PADS = {0: "NULLTERM", 1: "NULLPAD", 2: "SPACEPAD"}


class _File:
    """Little-endian reads at absolute addresses of an open file."""

    def __init__(self, fh, path: str):
        self.fh, self.path = fh, path

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        data = self.fh.read(n)
        if len(data) != n:
            self.fail(f"truncated: {n} bytes wanted at {addr}, {len(data)} there")
        return data

    def fail(self, msg: str):
        raise ValueError(f"{self.path}: {msg}")

    def uint(self, buf: bytes, pos: int, size: int) -> int:
        return int.from_bytes(buf[pos:pos + size], "little")


def _superblock(f: _File) -> int:
    """The root group's object header address."""
    f.fh.seek(0)
    if f.fh.read(8) != SIGNATURE:
        f.fail("not an HDF5 file (no signature at offset 0)")
    head = f.read(0, 24)
    version = head[8]
    if version not in (0, 1):
        f.fail(f"superblock version {version} is not supported (only 0 and 1, h5py's "
               "default libver)")
    if (head[13], head[14]) != (8, 8):
        f.fail(f"offset/length sizes {head[13]}/{head[14]} are not supported (only 8/8)")
    pos = 24 + (4 if version == 1 else 0)  # v1: indexed storage K and reserved
    rest = f.read(0, pos + 4 * 8 + 40)
    # base, free-space, end-of-file, driver addresses, then the root entry
    entry = pos + 32
    return f.uint(rest, entry + 8, 8)


def _messages(f: _File, addr: int):
    """(type, data) of every message of the version-1 object header at addr,
    continuation blocks included."""
    prefix = f.read(addr, 16)
    if prefix[0] != 1:
        f.fail(f"object header version {prefix[0]} at {addr} is not supported (only 1)")
    blocks = [(addr + 16, f.uint(prefix, 8, 4))]
    out = []
    while blocks:
        start, size = blocks.pop(0)
        buf = f.read(start, size)
        pos = 0
        while pos + 8 <= size:
            mtype, msize = f.uint(buf, pos, 2), f.uint(buf, pos + 2, 2)
            data = buf[pos + 8:pos + 8 + msize]
            pos += 8 + msize
            if mtype == CONTINUATION:
                blocks.append((f.uint(data, 0, 8), f.uint(data, 8, 8)))
            out.append((mtype, data))
    return out


def _heap_name(f: _File, heap_addr: int, offset: int) -> str:
    head = f.read(heap_addr, 32)
    if head[:4] != b"HEAP":
        f.fail(f"no local heap at {heap_addr}")
    seg_size, seg_addr = f.uint(head, 8, 8), f.uint(head, 24, 8)
    seg = f.read(seg_addr, seg_size)
    return seg[offset:seg.index(b"\0", offset)].decode("utf-8")


def _group_entries(f: _File, btree_addr: int, heap_addr: int) -> Dict[str, int]:
    """name -> object header address of every entry of a symbol-table group,
    through a version-1 group B-tree of any depth."""
    out = {}
    head = f.read(btree_addr, 24)
    if head[:4] != b"TREE" or head[4] != 0:
        f.fail(f"no group B-tree node at {btree_addr}")
    level, used = head[5], f.uint(head, 6, 2)
    body = f.read(btree_addr + 24, (2 * used + 1) * 8)
    children = [f.uint(body, 8 + 16 * i, 8) for i in range(used)]
    for child in children:
        if level > 0:
            out.update(_group_entries(f, child, heap_addr))
            continue
        node = f.read(child, 8)
        if node[:4] != b"SNOD":
            f.fail(f"no symbol table node at {child}")
        n_sym = f.uint(node, 6, 2)
        entries = f.read(child + 8, 40 * n_sym)
        for i in range(n_sym):
            name_off, header = f.uint(entries, 40 * i, 8), f.uint(entries, 40 * i + 8, 8)
            out[_heap_name(f, heap_addr, name_off)] = header
    return out


def _dataspace(f: _File, data: bytes, where: str):
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos = 8
    elif version == 2:
        if data[3] == 2:  # null dataspace
            return ()
        pos = 4
    else:
        f.fail(f"{where}: dataspace message version {version} is not supported")
    return tuple(f.uint(data, pos + 8 * i, 8) for i in range(rank))


def _datatype(f: _File, data: bytes, where: str):
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits, size = data[1:4], f.uint(data, 4, 4)
    if version not in (1, 2, 3):
        f.fail(f"{where}: datatype message version {version} is not supported")
    if cls == 1:  # floating point
        props = data[8:20]
        ieee_f32 = (size == 4 and bits[0] & 0x01 == 0 and (bits[0] >> 4) & 0x3 == 2
                    and bits[1] == 31 and f.uint(props, 0, 2) == 0 and f.uint(props, 2, 2) == 32
                    and props[4:8] == bytes([23, 8, 0, 23]) and f.uint(props, 8, 4) == 127)
        if not ieee_f32:
            f.fail(f"{where}: only IEEE float32 little-endian is supported "
                   f"(a {8 * size}-bit float, byte order bit {bits[0] & 1})")
        return np.dtype("<f4"), None
    if cls == 3:  # fixed-length string
        pad = bits[0] & 0x0F
        if pad not in (0, 1):
            f.fail(f"{where}: {STRING_PADS.get(pad, pad)} strings are not supported "
                   "(only NULLTERM and NULLPAD)")
        return np.dtype(f"S{size}"), STRING_PADS[pad]
    names = {0: "integer", 2: "time", 4: "bitfield", 5: "opaque", 6: "compound",
             7: "reference", 8: "enumerated", 9: "variable-length", 10: "array"}
    f.fail(f"{where}: datatype class {names.get(cls, cls)} is not supported "
           "(only float32 and fixed-length strings)")


def _fill(f: _File, mtype: int, data: bytes, where: str) -> Optional[bytes]:
    """The fill value's bytes, or None where none is defined (zeros)."""
    if mtype == FILL_OLD:
        size = f.uint(data, 0, 4)
        return data[4:4 + size] if size else None
    version = data[0]
    if version in (1, 2):
        defined = data[3] if version == 2 else 1
        if not defined:
            return None
        size = f.uint(data, 4, 4)
        return data[8:8 + size] if size else None
    if version == 3:
        if not data[1] & 0x20:
            return None
        size = f.uint(data, 2, 4)
        return data[6:6 + size] if size else None
    f.fail(f"{where}: fill value message version {version} is not supported")


def _filter_names(f: _File, data: bytes) -> List[str]:
    version, n = data[0], data[1]
    pos, names = (8 if version == 1 else 2), []
    for _ in range(n):
        fid = f.uint(data, pos, 2)
        name_len = f.uint(data, pos + 2, 2) if (version == 1 or fid >= 256) else 0
        step = 4 if (version == 1 or fid >= 256) else 2
        n_vals = f.uint(data, pos + step + 2, 2)
        pos += step + 4
        name = data[pos:pos + name_len].split(b"\0")[0].decode("ascii", "replace")
        pos += ((name_len + 7) // 8) * 8 if version == 1 else name_len
        pos += 4 * n_vals + (4 if version == 1 and n_vals % 2 else 0)
        names.append(FILTER_NAMES.get(fid, name or f"filter id {fid}"))
    return names


def _chunks(f: _File, addr: int, rank: int):
    """(offsets, address, size) of every chunk under the version-1 chunk
    B-tree (node type 1) at addr, at any depth."""
    head = f.read(addr, 24)
    if head[:4] != b"TREE" or head[4] != 1:
        f.fail(f"no chunk B-tree node at {addr}")
    level, used = head[5], f.uint(head, 6, 2)
    key = 8 + 8 * (rank + 1)
    body = f.read(addr + 24, used * (key + 8) + key)
    for i in range(used):
        k = i * (key + 8)
        child = f.uint(body, k + key, 8)
        if level > 0:
            yield from _chunks(f, child, rank)
        else:
            offsets = tuple(f.uint(body, k + 8 + 8 * d, 8) for d in range(rank))
            yield offsets, child, f.uint(body, k, 4)


def _read_dataset(f: _File, name: str, header: int) -> np.ndarray:
    where = f"dataset '{name}'"
    shape = dtype = layout = pad = None
    fill = None
    for mtype, data in _messages(f, header):
        if mtype == DATASPACE:
            shape = _dataspace(f, data, where)
        elif mtype == DATATYPE:
            dtype, pad = _datatype(f, data, where)
        elif mtype in (FILL_OLD, FILL):
            fill = _fill(f, mtype, data, where)
        elif mtype == LAYOUT:
            layout = data
        elif mtype == FILTERS:
            f.fail(f"{where} uses the filter pipeline {_filter_names(f, data)}; filters are "
                   "not supported (write the file without compression)")
        elif mtype == EXTERNAL:
            f.fail(f"{where} keeps its data in an external file, which is not supported")
        elif mtype not in IGNORED and mtype != CONTINUATION:
            f.fail(f"{where}: object header message type {mtype:#x} is not supported")
    if shape is None or dtype is None or layout is None:
        f.fail(f"{where}: no dataspace, datatype or layout message")
    if layout[0] != 3:
        f.fail(f"{where}: layout message version {layout[0]} is not supported (only 3)")
    out = np.zeros(shape, dtype=dtype)
    if fill is not None:
        out[...] = np.frombuffer(fill, dtype=dtype)[0]
    nbytes = out.nbytes
    if layout[1] == 1:  # contiguous
        addr = f.uint(layout, 2, 8)
        if addr != UNDEFINED and nbytes:
            out = np.frombuffer(f.read(addr, nbytes), dtype=dtype).reshape(shape).copy()
    elif layout[1] == 2:  # chunked
        rank = layout[2] - 1
        if rank != len(shape):
            f.fail(f"{where}: chunk rank {rank} against dataspace rank {len(shape)}")
        addr = f.uint(layout, 3, 8)
        chunk = tuple(f.uint(layout, 11 + 4 * d, 4) for d in range(rank))
        chunk_bytes = int(np.prod(chunk)) * dtype.itemsize
        if addr != UNDEFINED:
            for offsets, caddr, size in _chunks(f, addr, rank):
                if size != chunk_bytes:
                    f.fail(f"{where}: a chunk of {size} bytes, {chunk_bytes} expected")
                block = np.frombuffer(f.read(caddr, size), dtype=dtype).reshape(chunk)
                dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, shape))
                out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
    else:
        kind = {0: "compact"}.get(layout[1], str(layout[1]))
        f.fail(f"{where}: the {kind} layout is not supported (only contiguous and chunked)")
    if pad == "NULLTERM":  # the string ends at its first NUL
        out = np.array([s.split(b"\0", 1)[0] for s in out.ravel()],
                       dtype=dtype).reshape(shape)
    return out


def read_datasets(path: str, names: Optional[Sequence[str]] = None) -> Dict[str, np.ndarray]:
    """{name: array} of the root group's datasets (``names``, or all):
    float32 arrays, and fixed-length strings as numpy bytes arrays (``S``),
    as h5py returns them with ``f[name][:]``."""
    with open(path, "rb") as fh:
        f = _File(fh, str(path))
        root = _superblock(f)
        table = [data for mtype, data in _messages(f, root) if mtype == SYMBOL_TABLE]
        if not table:
            f.fail("the root group has no symbol table (link-message groups, h5py's "
                   "libver='latest', are not supported)")
        entries = _group_entries(f, f.uint(table[0], 0, 8), f.uint(table[0], 8, 8))
        wanted = list(entries) if names is None else list(names)
        missing = [n for n in wanted if n not in entries]
        if missing:
            f.fail(f"no dataset {missing} in the root group (it holds {sorted(entries)})")
        return {n: _read_dataset(f, n, entries[n]) for n in wanted}


def read_matrix_h5(path: str):
    """(feature_names, sample_ids, float32 features x samples matrix) of a
    ``csv_to_h5`` file: what ``data/fastcsv.read_matrix_csv`` returns for the
    CSV it was made from."""
    d = read_datasets(path, ["matrix", "sample_ids", "feature_names"])
    return ([s.decode() for s in d["feature_names"]], [s.decode() for s in d["sample_ids"]],
            np.ascontiguousarray(d["matrix"].T))


# ----------------------------------------------------------------- writing


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (-len(b) % 8)


def _message(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


def _object_header(messages: List[bytes]) -> bytes:
    body = b"".join(messages)
    return struct.pack("<BBHII", 1, 0, len(messages), 1, len(body)) + b"\0" * 4 + body


def _dataspace_msg(shape) -> bytes:
    return struct.pack("<BBB5x", 1, len(shape), 0) + b"".join(
        struct.pack("<Q", n) for n in shape)


F32_TYPE = bytes([0x11, 0x20, 0x1F, 0x00]) + struct.pack("<IHHBBBBI", 4, 0, 32, 23, 8, 0, 23, 127)


def _string_type(size: int) -> bytes:
    return bytes([0x13, 0x01, 0x00, 0x00]) + struct.pack("<I", size)  # NULLPAD, ASCII


# fill value message v2: allocation late, written if set, none defined
FILL_MSG = bytes([2, 2, 2, 0])


def _layout_msg(addr: int, size: int) -> bytes:
    return struct.pack("<BBQQ", 3, 1, addr, size)


def _dataset_header(shape, dtype_msg: bytes, addr: int, nbytes: int) -> bytes:
    return _object_header([
        _message(DATASPACE, _dataspace_msg(shape)),
        _message(DATATYPE, dtype_msg, flags=1),
        _message(FILL, FILL_MSG, flags=1),
        _message(LAYOUT, _layout_msg(addr if nbytes else UNDEFINED, nbytes)),
    ])


class MatrixWriter:
    """Writes ``/matrix`` (samples, features) float32, ``/sample_ids`` and
    ``/feature_names`` into a new file at ``path``: ``matrix`` is a memory
    map of the contiguous matrix to fill (columns may come in blocks), then
    ``close(sample_ids, feature_names)`` writes the strings and the metadata.
    The metadata before the matrix has a size fixed by the names of the three
    datasets, so the matrix's address is known before any value is read."""

    NAMES = (b"feature_names", b"matrix", b"sample_ids")  # sorted, as in the B-tree
    GROUP_K, LEAF_K = 16, 4

    def __init__(self, path: str, n_samples: int, n_features: int):
        self.path, self.shape = str(path), (n_samples, n_features)
        self._layout()
        nbytes = n_samples * n_features * 4
        with open(self.path, "wb") as fh:
            fh.truncate(self.matrix_addr + nbytes)
        self.matrix = (np.memmap(self.path, dtype="<f4", mode="r+", offset=self.matrix_addr,
                                 shape=self.shape) if nbytes else
                       np.zeros(self.shape, dtype="<f4"))

    def _layout(self):
        heap = b"\0" * 8 + b"".join(_pad8(n + b"\0") for n in self.NAMES)
        self.name_offsets, pos = [], 8
        for n in self.NAMES:
            self.name_offsets.append(pos)
            pos += len(_pad8(n + b"\0"))
        self.heap_data = heap
        root_header = _object_header([_message(SYMBOL_TABLE, b"\0" * 16)])
        # every dataset header has the same size whatever its shape's values
        ds_header = len(_dataset_header((0, 0), F32_TYPE, 0, 0))
        str_header = len(_dataset_header((0,), _string_type(1), 0, 0))
        self.root_addr = 96
        self.heap_addr = self.root_addr + len(root_header)
        self.heap_data_addr = self.heap_addr + 32
        self.btree_addr = self.heap_data_addr + len(heap)
        btree_size = 24 + (2 * self.GROUP_K + 1) * 8 + 2 * self.GROUP_K * 8
        self.snod_addr = self.btree_addr + btree_size
        snod_size = 8 + 2 * self.LEAF_K * 40
        self.header_addrs = []
        pos = self.snod_addr + snod_size
        for size in (str_header, ds_header, str_header):
            self.header_addrs.append(pos)
            pos += size
        self.matrix_addr = pos + (-pos % 8)

    def close(self, sample_ids: Sequence[bytes], feature_names: Sequence[bytes]) -> None:
        n, F = self.shape
        if (len(sample_ids), len(feature_names)) != (n, F):
            raise ValueError(f"{self.path}: {len(sample_ids)} sample ids and "
                             f"{len(feature_names)} feature names for a {n} x {F} matrix")
        if isinstance(self.matrix, np.memmap):
            self.matrix.flush()
        self.matrix = None
        strings = {}
        with open(self.path, "r+b") as fh:
            fh.seek(0, os.SEEK_END)
            for key, values in (("sample_ids", sample_ids), ("feature_names", feature_names)):
                arr = np.array(list(values), dtype="S")  # numpy's width, as h5py is given
                strings[key] = (fh.tell(), arr.dtype.itemsize, arr.nbytes, arr.shape)
                fh.write(arr.tobytes())
            eof = fh.tell()
            headers = [
                _dataset_header(strings["feature_names"][3],
                                _string_type(strings["feature_names"][1]),
                                strings["feature_names"][0], strings["feature_names"][2]),
                _dataset_header(self.shape, F32_TYPE, self.matrix_addr, n * F * 4),
                _dataset_header(strings["sample_ids"][3], _string_type(strings["sample_ids"][1]),
                                strings["sample_ids"][0], strings["sample_ids"][2]),
            ]
            fh.seek(0)
            fh.write(self._metadata(headers, eof))

    def _metadata(self, headers: List[bytes], eof: int) -> bytes:
        root_entry = struct.pack("<QQII", 0, self.root_addr, 1, 0) + struct.pack(
            "<QQ", self.btree_addr, self.heap_addr)
        superblock = (SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI", self.LEAF_K, self.GROUP_K, 0)
                      + struct.pack("<QQQQ", 0, UNDEFINED, eof, UNDEFINED) + root_entry)
        root = _object_header([_message(SYMBOL_TABLE,
                                         struct.pack("<QQ", self.btree_addr, self.heap_addr))])
        # no free space: the free list's head is H5HL_FREE_NULL (1)
        heap = b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack(
            "<QQQ", len(self.heap_data), 1, self.heap_data_addr)
        btree = (b"TREE" + bytes([0, 0]) + struct.pack("<HQQ", 1, UNDEFINED, UNDEFINED)
                 + struct.pack("<QQQ", 0, self.snod_addr, self.name_offsets[-1]))
        btree += b"\0" * (24 + (2 * self.GROUP_K + 1) * 8 + 2 * self.GROUP_K * 8 - len(btree))
        snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", len(self.NAMES))
        for off, addr in zip(self.name_offsets, self.header_addrs):
            snod += struct.pack("<QQII", off, addr, 0, 0) + b"\0" * 16
        snod += b"\0" * (8 + 2 * self.LEAF_K * 40 - len(snod))
        out = bytearray(superblock + root + heap + self.heap_data + btree + snod
                        + b"".join(headers))
        assert len(superblock) == self.root_addr and len(out) <= self.matrix_addr
        return bytes(out)
