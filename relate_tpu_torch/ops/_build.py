"""Builds the CUDA sources under ``csrc/`` at first use and loads them.

Each ``csrc/<name>.cu`` has a plain C interface and becomes its own shared
library ``build/<name>-<hash>.so`` (``nvcc`` for ``sm_90a``), loaded with
``ctypes``. The hash covers the source text, the text of the local headers
it includes (``#include "x.cuh"``, from ``csrc/``) and the flags, so an
edited source or header is rebuilt and a stale library is never picked up.
``build_all`` starts one ``nvcc`` per source at the same time.

Nothing here runs when the package is imported: a machine without ``nvcc``
imports every module and only fails when a CUDA tensor reaches a kernel
wrapper. A failed build raises with the compiler's output; nothing falls
back to another implementation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Dict, Iterable, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

BASE_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
# The merge scans' weighted averages w*x + (1-w)*y decide a discrete merge
# list: they must round as two products and a sum, like the plain versions
# and the JAX kernels, so those files are built without FMA contraction.
EXTRA_FLAGS: Dict[str, List[str]] = {
    "merge_scan": ["-fmad=false"],
    "merge_scan_inc": ["-fmad=false"],
}
SOURCES = ("paint_fwd", "paint_bwd", "paint_capture", "merge_scan",
           "merge_scan_inc")

_LOCAL_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.MULTILINE)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()

# launches of each wrapper's kernel by card: {name: {"cuda:k": count}}
launches_by_card: Dict[str, Dict[str, int]] = {}
_COUNT_LOCK = threading.Lock()


def find_nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc was not found (looked on PATH and under $CUDA_HOME or "
        "/usr/local/cuda): the CUDA kernels cannot be built")


def _flags(name: str) -> List[str]:
    return BASE_FLAGS + EXTRA_FLAGS.get(name, [])


def _target(name: str) -> str:
    src = os.path.join(CSRC_DIR, name + ".cu")
    h = hashlib.sha256()
    with open(src, "rb") as f:
        text = f.read()
    h.update(text)
    for header in _LOCAL_INCLUDE.findall(text):
        with open(os.path.join(CSRC_DIR, header.decode()), "rb") as f:
            h.update(f.read())
    h.update(" ".join(_flags(name)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _command(name: str, out: str, verbose: bool) -> List[str]:
    cmd = [find_nvcc()] + _flags(name)
    if verbose:
        cmd += ["-Xptxas", "-v"]
    return cmd + ["-o", out, os.path.join(CSRC_DIR, name + ".cu")]


def _finish(name: str, proc: subprocess.Popen, tmp: str, out: str) -> str:
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names: Optional[Iterable[str]] = None,
              verbose: bool = False) -> Dict[str, str]:
    """Compile every source that has no current library, all ``nvcc``
    processes started together. Returns {name: compiler output}."""
    names = list(names or SOURCES)
    os.makedirs(BUILD_DIR, exist_ok=True)
    logs: Dict[str, str] = {}
    with _LOCK:
        running = []
        for name in names:
            out = _target(name)
            if os.path.exists(out) and not verbose:
                logs[name] = ""
                continue
            tmp = f"{out}.tmp.{os.getpid()}"
            proc = subprocess.Popen(_command(name, tmp, verbose),
                                    stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            running.append((name, proc, tmp, out))
        errors = []
        for name, proc, tmp, out in running:
            try:
                logs[name] = _finish(name, proc, tmp, out)
            except RuntimeError as e:   # let the other compilers end first
                errors.append(e)
        if errors:
            raise errors[0]
    return logs


def load(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built if need be."""
    lib = _LIBS.get(name)
    if lib is None:
        out = _target(name)
        if not os.path.exists(out):
            build_all([name])
        lib = ctypes.CDLL(out)
        _LIBS[name] = lib
    return lib


def count_launch(launches: Dict[str, int], name: str, device) -> None:
    """Add one to ``launches[name]`` and to the count of ``name`` on
    ``device`` in ``launches_by_card``. A kernel wrapper calls this where it
    launches its kernel, from whichever thread drives the card."""
    with _COUNT_LOCK:
        launches[name] += 1
        per = launches_by_card.setdefault(name, {})
        per[str(device)] = per.get(str(device), 0) + 1


def reset_launches(*counters: Dict[str, int]) -> None:
    """Set ``counters`` (the wrappers' ``launches``) and
    ``launches_by_card`` to 0."""
    with _COUNT_LOCK:
        for c in counters:
            for k in c:
                c[k] = 0
        launches_by_card.clear()


def check(err: int, what: str) -> None:
    """Raise if a launch function returned another CUDA error than 0."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")
