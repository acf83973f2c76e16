"""The native IO library: ``csrc/relate_io.cpp`` (a zlib ``.haps`` parser
and a threaded text ``.anc`` tree writer), built at first use and loaded
with ``ctypes``.

``build`` compiles the source with ``g++ -O2 -shared -fPIC -pthread`` into
``build/relate_io-<hash>.so`` (the hash covers the source text, the
compiler and the flags, so an edited source is rebuilt), linked against
``libz.so.1``, the zlib that Python's own ``zlib`` module loads. The
source takes ``zlib.h`` where the system has it and declares the few
functions it calls where not. Nothing is built when the module is
imported. A build or load that fails raises with the compiler's output;
nothing falls back to the Python reader or writer (``use_native=False``
asks for those).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "relate_io.cpp")
BUILD_DIR = os.path.join(_PKG, "build")
COMPILER = "g++"
FLAGS = ["-O2", "-shared", "-fPIC", "-pthread", "-std=c++17"]
LIBS = ["-l:libz.so.1"]

_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


def _target(compiler: str) -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join([compiler] + FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"relate_io-{h.hexdigest()[:16]}.so")


def build(compiler: str = COMPILER) -> str:
    """Compile the source unless its library exists; returns its path.
    Raises RuntimeError naming the compiler and its output on failure."""
    out = _target(compiler)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp.{os.getpid()}.{threading.get_ident()}"
    cmd = [compiler] + FLAGS + ["-o", tmp, SOURCE] + LIBS
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(
            f"the native IO library cannot be built: {compiler!r} does "
            f"not run ({e})") from e
    if proc.returncode != 0:
        raise RuntimeError(
            f"{compiler} failed on csrc/relate_io.cpp (exit "
            f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def load() -> ctypes.CDLL:
    """The loaded library, built if need be."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(build())
        lib.rt_scan_haps.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_long)]
        lib.rt_scan_haps.restype = ctypes.c_long
        lib.rt_read_haps.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_long,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_long]
        lib.rt_read_haps.restype = ctypes.c_long
        lib.rt_write_anc_trees.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
        lib.rt_write_anc_trees.restype = ctypes.c_int
        _LIB = lib
        return lib


def read_haps_rows(haps_path: str, N: int):
    """(G (L, N) uint8, bp (L,) int64, chrom, rsid, ancestral, alternative)
    of a ``.haps``/``.haps.gz`` with N alleles a row."""
    lib = load()
    path = haps_path.encode()
    field_bytes = ctypes.c_long(0)
    L = lib.rt_scan_haps(path, ctypes.byref(field_bytes))
    if L < 0:
        raise OSError(f"cannot open {haps_path}")
    if L == 0:
        raise ValueError(f"{haps_path} has no SNP")
    G = np.empty((L, N), dtype=np.uint8)
    bp = np.empty(L, dtype=np.int64)
    cap = field_bytes.value + 4 * L
    text = np.empty(cap, dtype=np.uint8)
    got = lib.rt_read_haps(path, N, L, G.ctypes.data, bp.ctypes.data,
                           text.ctypes.data, cap)
    if got <= -3:
        raise ValueError(f"{haps_path}: SNP {-3 - got} is not 'chr rsid bp "
                         f"ancestral alternative' and {N} alleles 0 or 1")
    if got != L:
        raise RuntimeError(f"{haps_path}: the native parser read {got} of "
                           f"{L} SNPs")
    fields = text.tobytes().split(b"\0")
    cols = [[x.decode() for x in fields[k:4 * L:4]] for k in range(4)]
    return (G, bp) + tuple(cols)


def write_anc_trees(path: str, header: str, pos, parents, bl, ne, sb, se):
    """Append ``header`` and one text ``.anc`` line a tree to ``path``."""
    lib = load()
    arrays = [np.ascontiguousarray(a, dtype=d) for a, d in (
        (pos, np.int32), (parents, np.int32), (bl, np.float64),
        (ne, np.float32), (sb, np.int32), (se, np.int32))]
    T, Mn = arrays[1].shape
    if arrays[0].shape != (T,) or any(a.shape != (T, Mn)
                                      for a in arrays[2:]):
        raise ValueError(f"tree columns of shapes {[a.shape for a in arrays]}"
                         f" for {T} trees of {Mn} nodes")
    rc = lib.rt_write_anc_trees(path.encode(), header.encode(), T, Mn,
                                *(a.ctypes.data for a in arrays))
    if rc != 0:
        raise OSError(f"the native .anc writer failed on {path} ({rc})")
