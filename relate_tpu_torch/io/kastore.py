"""Native kastore container + tskit .trees writer (no tskit dependency).

Counterpart of ``relate_tpu/io/kastore.py``: the same bytes but for the
``uuid`` key, a fresh ``uuid4`` in every file. The reference vendors tskit
0.99.1 in C for its ConvertToTreeSequence mode
(``include/file_formats/ConvertToTreeSequence.cpp``, kastore layout per
``include/file_formats/tskit/kastore.c:113-230``). This module writes the
same on-disk container with numpy, so the exporter needs no ``tskit``
package:

kastore v1.0 layout (all little-endian):
  header (64B): magic ``\\x89KAS\\r\\n\\x1a\\n``, u16 major=1, u16 minor=0,
  u32 num_items, u64 file_size, rest zero.
  per item (64B): u8 type, 7B reserved, u64 key_start, u64 key_len,
  u64 array_start, u64 array_len, rest zero. Items sorted by key; keys
  concatenated after the descriptors; each array 8-byte aligned.

tskit tree-sequence file = kastore with the table columns of file format
12.0 (``tskit/tables.c`` *_table_dump functions; version at
``tskit/core.h:95-96``). Empty tables still need their columns plus the
``*_offset`` arrays (one 0 entry).
"""
from __future__ import annotations

import struct
import uuid as _uuid
from typing import Dict

import numpy as np

MAGIC = b"\x89KAS\r\n\x1a\n"
HEADER_SIZE = 64
DESCRIPTOR_SIZE = 64
ARRAY_ALIGN = 8

_TYPE_CODES = {
    np.dtype("int8"): 0, np.dtype("uint8"): 1,
    np.dtype("int16"): 2, np.dtype("uint16"): 3,
    np.dtype("int32"): 4, np.dtype("uint32"): 5,
    np.dtype("int64"): 6, np.dtype("uint64"): 7,
    np.dtype("float32"): 8, np.dtype("float64"): 9,
}
_CODE_DTYPES = {v: k for k, v in _TYPE_CODES.items()}


def dump(path: str, items: Dict[str, np.ndarray]):
    """Write a kastore v1.0 file."""
    keys = sorted(items.keys())
    arrays = [np.ascontiguousarray(items[k]) for k in keys]
    for k, a in zip(keys, arrays):
        if a.ndim != 1:
            raise ValueError(f"{k}: kastore arrays are 1-D")
        if a.dtype not in _TYPE_CODES:
            raise ValueError(f"{k}: unsupported dtype {a.dtype}")
    kbytes = [k.encode() for k in keys]
    n = len(keys)
    offset = HEADER_SIZE + n * DESCRIPTOR_SIZE
    key_starts = []
    for kb in kbytes:
        key_starts.append(offset)
        offset += len(kb)
    array_starts = []
    for a in arrays:
        if offset % ARRAY_ALIGN:
            offset += ARRAY_ALIGN - offset % ARRAY_ALIGN
        array_starts.append(offset)
        offset += a.nbytes
    file_size = offset

    with open(path, "wb") as f:
        hdr = bytearray(HEADER_SIZE)
        hdr[0:8] = MAGIC
        struct.pack_into("<HHIQ", hdr, 8, 1, 0, n, file_size)
        f.write(hdr)
        for kb, a, ks, as_ in zip(kbytes, arrays, key_starts, array_starts):
            d = bytearray(DESCRIPTOR_SIZE)
            d[0] = _TYPE_CODES[a.dtype]
            struct.pack_into("<QQQQ", d, 8, ks, len(kb), as_, len(a))
            f.write(d)
        for kb in kbytes:
            f.write(kb)
        pos = HEADER_SIZE + n * DESCRIPTOR_SIZE + sum(len(k) for k in kbytes)
        for a, as_ in zip(arrays, array_starts):
            if pos < as_:
                f.write(b"\0" * (as_ - pos))
                pos = as_
            f.write(a.tobytes())
            pos += a.nbytes


def load(path: str) -> Dict[str, np.ndarray]:
    """Read a kastore v1.0 file into {key: array}."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != MAGIC:
        raise ValueError("not a kastore file")
    major, minor, n, file_size = struct.unpack_from("<HHIQ", buf, 8)
    if major != 1:
        raise ValueError(f"unsupported kastore version {major}.{minor}")
    out = {}
    for j in range(n):
        base = HEADER_SIZE + j * DESCRIPTOR_SIZE
        tcode = buf[base]
        ks, kl, as_, al = struct.unpack_from("<QQQQ", buf, base + 8)
        key = buf[ks:ks + kl].decode()
        dt = _CODE_DTYPES[tcode]
        out[key] = np.frombuffer(buf, dtype=dt, count=al, offset=as_).copy()
    return out


def _offsets(lengths) -> np.ndarray:
    out = np.zeros(len(lengths) + 1, dtype=np.uint32)
    np.cumsum(lengths, out=out[1:])
    return out


def _char_col(strings) -> (np.ndarray, np.ndarray):
    data = "".join(strings).encode()
    return (np.frombuffer(data, dtype=np.uint8).copy(),
            _offsets([len(s.encode()) for s in strings]))


def trees_dump(path: str, *, sequence_length: float,
               node_time: np.ndarray, node_flags: np.ndarray,
               edge_left: np.ndarray, edge_right: np.ndarray,
               edge_parent: np.ndarray, edge_child: np.ndarray,
               site_position: np.ndarray, site_ancestral: list,
               mut_site: np.ndarray, mut_node: np.ndarray,
               mut_derived: list, provenance: str = ""):
    """Write a tskit .trees file (file format 12.0) from table columns.

    Edges must satisfy tskit's ordering (sorted by (time[parent], parent,
    child, left)); sites by position; mutations by site. Indexes are
    computed here.
    """
    ne = len(edge_left)
    node_time = np.asarray(node_time, np.float64)
    edge_parent = np.asarray(edge_parent, np.int32)
    edge_child = np.asarray(edge_child, np.int32)
    edge_left = np.asarray(edge_left, np.float64)
    edge_right = np.asarray(edge_right, np.float64)
    # tree-traversal indexes (tables.c:5554): insertion order sweeps left
    # boundaries (ties: older parents last -> increasing parent time),
    # removal order sweeps right boundaries (ties: older parents first)
    tp = node_time[edge_parent]
    ins = np.lexsort((edge_child, edge_parent, tp, edge_left))
    rem = np.lexsort((-edge_child, -edge_parent, -tp, edge_right))

    nn = len(node_time)
    ns = len(site_position)
    nm = len(mut_site)
    anc_data, anc_off = _char_col(site_ancestral)
    der_data, der_off = _char_col(mut_derived)
    prov_data, prov_off = _char_col([provenance] if provenance else [])
    ts_data, ts_off = _char_col([""] if provenance else [])

    z8 = np.zeros(0, np.uint8)
    zu32_1 = np.zeros(1, np.uint32)
    items = {
        "format/name": np.frombuffer(b"tskit.trees", np.int8).copy(),
        "format/version": np.asarray([12, 0], np.uint32),
        "sequence_length": np.asarray([sequence_length], np.float64),
        "uuid": np.frombuffer(str(_uuid.uuid4()).encode(), np.int8).copy(),
        "nodes/time": node_time,
        "nodes/flags": np.asarray(node_flags, np.uint32),
        "nodes/population": np.full(nn, -1, np.int32),
        "nodes/individual": np.full(nn, -1, np.int32),
        "nodes/metadata": z8,
        "nodes/metadata_offset": np.zeros(nn + 1, np.uint32),
        "edges/left": edge_left,
        "edges/right": edge_right,
        "edges/parent": edge_parent,
        "edges/child": edge_child,
        "sites/position": np.asarray(site_position, np.float64),
        "sites/ancestral_state": anc_data,
        "sites/ancestral_state_offset": anc_off,
        "sites/metadata": z8,
        "sites/metadata_offset": np.zeros(ns + 1, np.uint32),
        "mutations/site": np.asarray(mut_site, np.int32),
        "mutations/node": np.asarray(mut_node, np.int32),
        "mutations/parent": np.full(nm, -1, np.int32),
        "mutations/derived_state": der_data,
        "mutations/derived_state_offset": der_off,
        "mutations/metadata": z8,
        "mutations/metadata_offset": np.zeros(nm + 1, np.uint32),
        "individuals/flags": np.zeros(0, np.uint32),
        "individuals/location": np.zeros(0, np.float64),
        "individuals/location_offset": zu32_1,
        "individuals/metadata": z8,
        "individuals/metadata_offset": zu32_1,
        "migrations/left": np.zeros(0, np.float64),
        "migrations/right": np.zeros(0, np.float64),
        "migrations/node": np.zeros(0, np.int32),
        "migrations/source": np.zeros(0, np.int32),
        "migrations/dest": np.zeros(0, np.int32),
        "migrations/time": np.zeros(0, np.float64),
        "populations/metadata": z8,
        "populations/metadata_offset": zu32_1,
        "provenances/timestamp": ts_data if provenance else z8,
        "provenances/timestamp_offset": ts_off if provenance else zu32_1,
        "provenances/record": prov_data if provenance else z8,
        "provenances/record_offset": prov_off if provenance else zu32_1,
        "indexes/edge_insertion_order": ins.astype(np.int32),
        "indexes/edge_removal_order": rem.astype(np.int32),
    }
    dump(path, items)
    return path
