"""Reader for the reference's painting checkpoint files (interop/testing).

Counterpart of ``relate_tpu/io/refpaint.py``: the tests hold the port's
stepping-stone checkpoints against the C++ reference's paint files with it.

Format (``fast_painting.cpp:587-601`` + RLE codec at
``collapsed_matrix.hpp:228-296``): per window file ``paint/relate_<w>.bin``,
for each target haplotype n in 0..N-1:

  int32 section_startpos, int32 section_endpos
  alpha record:  u64 isize(=1), u64 subVectorSize(=N), int32 boundarySNP,
                 f32 logscale, int32 k, f32 unique[k], int32 times[k]
  beta record:   same layout

The RLE is lossy: runs merge values within 1e-3 relative tolerance
(collapsed_matrix.hpp:243), so round-trips are approximate by design.
"""
from __future__ import annotations

import struct
from typing import NamedTuple

import numpy as np


class RefPaintRecord(NamedTuple):
    section_startpos: int
    section_endpos: int
    alpha: np.ndarray      # (N,)
    ls_alpha: float
    bsb: int
    beta: np.ndarray       # (N,)
    ls_beta: float
    bse: int


def _read_rle(f) -> tuple:
    isize, sub = struct.unpack("QQ", f.read(16))
    (boundary,) = struct.unpack("i", f.read(4))
    (logscale,) = struct.unpack("f", f.read(4))
    (k,) = struct.unpack("i", f.read(4))
    uniq = np.frombuffer(f.read(4 * k), dtype=np.float32)
    times = np.frombuffer(f.read(4 * k), dtype=np.int32)
    vec = np.repeat(uniq, times)
    assert len(vec) == isize * sub, (len(vec), isize, sub)
    return vec, boundary, logscale


def read_paint_file(path: str, N: int):
    """Read all N per-target records of one window's paint file."""
    out = []
    with open(path, "rb") as f:
        for _ in range(N):
            ssp, sep = struct.unpack("ii", f.read(8))
            alpha, bsb, lsa = _read_rle(f)
            beta, bse, lsb = _read_rle(f)
            out.append(RefPaintRecord(ssp, sep, alpha, lsa, bsb,
                                      beta, lsb, bse))
    return out
