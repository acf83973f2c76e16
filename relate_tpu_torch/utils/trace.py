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

Below the stages:

- ``count(name, n)`` adds ``n`` to ``counts[name]`` of the innermost open
  stage record (always on; nothing outside a stage). ``wrote(path)`` counts
  a written file's size under ``bytes_written``.
- ``span(name)`` times a block as a record of ``SPANS`` (name, ``start_ns``,
  ``end_ns``, thread, the enclosing span's ``id`` as ``parent``, and
  ``card`` where one is known). Spans are off until ``record_spans(True)``;
  while off, ``span`` returns one shared context that does nothing, reads
  no clock and touches no device. A span never synchronises the card: it
  ends when the host leaves the block.
- Stage records carry ``start_ns`` and ``end_ns`` beside ``wall_s``. Every
  time in ns is ``now_ns()``, the clock that ``torch.profiler`` stamps its
  events on (the host's real-time clock, which its ``trace_start_ns``
  reads), so that spans, records and the card's activity lie on one
  timeline.
- ``carry(fn)`` runs ``fn``, on whichever thread calls it, in the stage
  record open here, so that what a helper thread counts or notes lands in
  the stage its work belongs to. Spans on a helper thread nest only in
  that thread's own spans.
"""
from __future__ import annotations

import contextlib
import itertools
import os
import resource
import sys
import threading
import time
from typing import Iterable, List, Optional

import torch

STAGES: List[dict] = []
SPANS: List[dict] = []
_OPEN = threading.local()      # per thread: its open stage records and spans
_SPANS_ON = False
_IDS = itertools.count(1)
_COUNT_LOCK = threading.Lock()


def now_ns() -> int:
    """The clock of stage records and spans (see the module docstring)."""
    return time.time_ns()


def record_spans(on: bool = True) -> None:
    """Turn the recording of spans on or off (off at import)."""
    global _SPANS_ON
    _SPANS_ON = bool(on)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``counts[name]`` of the record of the innermost stage
    open on this thread; nothing happens outside a stage."""
    stack = getattr(_OPEN, "stack", None)
    if stack:
        with _COUNT_LOCK:
            c = stack[-1].setdefault("counts", {})
            c[name] = c.get(name, 0) + n


def wrote(path: str) -> None:
    """Count the size of the file just written at ``path`` under
    ``bytes_written``."""
    if getattr(_OPEN, "stack", None):
        count("bytes_written", os.path.getsize(path))


class _NoSpan:
    """The span while spans are off: one shared instance, doing nothing."""

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _NoSpan()


def _span_stack() -> list:
    if not hasattr(_OPEN, "spans"):
        _OPEN.spans = []
    return _OPEN.spans


class _Span:
    __slots__ = ("name", "card", "rec")

    def __init__(self, name: str, card):
        self.name, self.card = name, card

    def __enter__(self):
        stack = _span_stack()
        rec = dict(name=self.name, id=next(_IDS),
                   parent=stack[-1]["id"] if stack else None,
                   thread=threading.current_thread().name,
                   start_ns=now_ns(), end_ns=None)
        if self.card is not None:
            rec["card"] = str(self.card)
        SPANS.append(rec)
        stack.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        self.rec["end_ns"] = now_ns()
        _OPEN.spans.pop()
        return False


def span(name: str, card=None):
    """A context that records the block as a span of ``SPANS`` while spans
    are on (``card``: the device it drives, where one is known)."""
    if not _SPANS_ON:
        return _OFF
    return _Span(name, card)


def merge(rec: dict, other: dict) -> None:
    """Add a record made elsewhere (a pool worker's task) to ``rec``: its
    notes' lists are appended, its counts summed."""
    for key, items in other.items():
        if key == "counts":
            with _COUNT_LOCK:
                c = rec.setdefault("counts", {})
                for name, n in items.items():
                    c[name] = c.get(name, 0) + n
        else:
            rec.setdefault(key, []).extend(items)


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
    ``note`` and ``count`` from a worker thread land in the caller's
    stage."""
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


def carry(fn):
    """``fn`` made to run in the stage record open on this thread now, on
    whichever thread later calls it."""
    rec = open_record()

    def run(*args, **kwargs):
        with within(rec):
            return fn(*args, **kwargs)
    return run


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
    t0 = now_ns()
    c0 = _cpu_s()
    cards = _cards(devices)
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.reset_peak_memory_stats()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    rec = {"stage": name, "start_ns": t0}
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
    t1 = now_ns()
    rec.update(
        end_ns=t1,
        wall_s=round((t1 - t0) / 1e9, 3),
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
