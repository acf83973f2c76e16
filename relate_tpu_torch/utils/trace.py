"""Per-stage resource tracing.

The reference prints CPU time + max RSS via getrusage at the end of every
tool (e.g. ``include/pipeline/Paint.cpp:96-105``). This adds the card's
numbers: per-stage wall clock, host CPU time, max RSS and, where a CUDA
device is initialised, the peak device memory PyTorch allocated.

Usage::

    with stage("paint"):
        ...
    # -> [trace] paint: wall 3.21s cpu 2.87s rss 412MB dev_peak 96MB

Structured records accumulate in ``STAGES`` so a caller can print a final
per-stage summary table (and tests can assert on it). Code that runs inside a
stage can add to its record with ``note`` (the MCMC's rounds to convergence,
for one), also from a worker thread that entered the stage's record with
``within``. With ``devices`` (the cards of a mesh) a record gives the peak
memory of each of them under ``dev_peak_mb_by_card``; a worker process of
``parallel.pool.CardPool`` adds its card's peak there (``peak``), and the
record keeps the larger figure a card.
"""
from __future__ import annotations

import contextlib
import resource
import sys
import threading
import time
from typing import Iterable, List, Optional

import torch

STAGES: List[dict] = []
_OPEN = threading.local()      # per thread: the records of its open stages


def note(key: str, item) -> None:
    """Append ``item`` to the list ``key`` of the record of the innermost
    stage open on this thread; nothing happens outside a stage."""
    stack = getattr(_OPEN, "stack", None)
    if stack:
        stack[-1].setdefault(key, []).append(item)


def peak(rec: dict, card: str, mb: float) -> None:
    """Raise ``rec``'s peak device memory of ``card`` to ``mb`` (MB) if it
    is lower (the peak of another process on that card)."""
    by = rec.setdefault("dev_peak_mb_by_card", {})
    by[card] = max(by.get(card, 0.0), mb)


def open_record() -> Optional[dict]:
    """The record of the innermost stage open on this thread, or None."""
    stack = getattr(_OPEN, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def within(rec: Optional[dict]):
    """Make ``rec`` (a stage record open on another thread, or None) the
    innermost open record of this thread while the block runs, so that
    ``note`` from a worker thread lands in the caller's stage."""
    if rec is None:
        yield
        return
    if not hasattr(_OPEN, "stack"):
        _OPEN.stack = []
    _OPEN.stack.append(rec)
    try:
        yield
    finally:
        _OPEN.stack.pop()


def _rss_mb() -> float:
    # ru_maxrss is KB on Linux
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1000.0


def _cpu_s() -> float:
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _device_mem_bytes() -> Optional[int]:
    """Peak bytes PyTorch allocated on the current CUDA device since the
    stage began; None when no CUDA context exists in this process."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        return int(torch.cuda.max_memory_allocated())
    return None


def _cards(devices) -> list:
    if not (devices and torch.cuda.is_available()
            and torch.cuda.is_initialized()):
        return []
    return [torch.device(d) for d in devices
            if torch.device(d).type == "cuda"]


@contextlib.contextmanager
def stage(name: str, verbose: bool = True,
          devices: Optional[Iterable] = None):
    """Time a pipeline stage; record + optionally print its resource use.
    ``devices``: the mesh whose cards' peak memory the record gives."""
    t0 = time.time()
    c0 = _cpu_s()
    cards = _cards(devices)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    rec = {"stage": name}
    if not hasattr(_OPEN, "stack"):
        _OPEN.stack = []
    _OPEN.stack.append(rec)
    try:
        yield
    finally:
        _OPEN.stack.pop()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    cards = cards or _cards(devices)    # CUDA may have started in the stage
    for d in cards:
        torch.cuda.synchronize(d)
    rec.update(
        wall_s=round(time.time() - t0, 3),
        cpu_s=round(_cpu_s() - c0, 3),
        max_rss_mb=round(_rss_mb(), 1))
    dev = _device_mem_bytes()
    if dev is not None:
        rec["dev_peak_mb"] = round(dev / 1e6, 1)
    for d in cards:
        peak(rec, str(d), round(torch.cuda.max_memory_allocated(d) / 1e6, 1))
    STAGES.append(rec)
    if verbose:
        msg = (f"[trace] {name}: wall {rec['wall_s']}s "
               f"cpu {rec['cpu_s']}s rss {rec['max_rss_mb']}MB")
        if "dev_peak_mb" in rec:
            msg += f" dev_peak {rec['dev_peak_mb']}MB"
        print(msg, file=sys.stderr)


def summary(verbose: bool = True) -> List[dict]:
    """Per-stage records accumulated so far; optionally print a table."""
    if verbose and STAGES:
        w = max(len(r["stage"]) for r in STAGES)
        print(f"[trace] {'stage'.ljust(w)}  wall_s  cpu_s  rss_mb",
              file=sys.stderr)
        for r in STAGES:
            print(f"[trace] {r['stage'].ljust(w)}  "
                  f"{r['wall_s']:6.2f}  {r['cpu_s']:5.2f}  "
                  f"{r['max_rss_mb']:6.1f}", file=sys.stderr)
    return list(STAGES)
