"""What the profiler saw of one job: the card's intervals and kernels.

A job runs under ``torch.profiler`` with CUDA activity only. Busy time is
the union of the kernel, copy and set intervals on each card (kernels of
several streams overlap, so their sum would count time twice); the idle
share of a card is 1 - busy / the job's wall time. The sweeps' launches are
recorded beside it (``SweepLog``) so that their bounds follow their own
arguments.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

from . import roofline

SWEEPS = ("fwd", "bwd", "fwd_capture", "bwd_capture")
KERNEL_OF_SWEEP = {"fwd": "paint_fwd_kernel", "bwd": "paint_bwd_kernel",
                   "fwd_capture": "fwd_capture_kernel",
                   "bwd_capture": "bwd_capture_kernel"}


class SweepLog:
    """While active, every call of the program's four sweep wrappers is
    recorded with its arguments' shapes and step counts (kept on the card
    and summed once the job is over)."""

    def __init__(self, paint_kernels):
        self.pk = paint_kernels
        self.calls = []
        self._saved = {}

    def __enter__(self):
        for name in SWEEPS:
            fn = getattr(self.pk, name)
            self._saved[name] = fn

            def rec(*a, _fn=fn, _name=name, **k):
                D = a[0]
                want = a[1] if "capture" in _name else None
                mism = a[4] if "capture" in _name else a[3]
                self.calls.append((_name, D.clone(), None if want is None
                                   else want.clone(), tuple(mism.shape)))
                return _fn(*a, **k)
            setattr(self.pk, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.pk, name, fn)

    def bounds(self):
        """[(sweep name, least seconds)] in launch order."""
        out = []
        for name, D, want, (Dmax, B, N) in self.calls:
            Dl = D.long()
            if name == "fwd":
                b = roofline.paint_fwd(Dmax, B, N, int(Dl.sum()))
            elif name == "bwd":
                b = roofline.paint_bwd(Dmax, B, N, int(Dl.sum()))
            elif name == "fwd_capture":
                rows = int(torch.minimum(want.long(), Dl - 1).sum())
                b = roofline.paint_fwd_capture(Dmax, B, N, rows)
            else:
                w = want.long()
                rows = int(((Dl - w) * (w < Dl)).sum())
                b = roofline.paint_bwd_capture(Dmax, B, N, rows)
            out.append((name, b))
        return out


def _union_s(intervals) -> float:
    tot = 0.0
    end = None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                tot += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        tot += end - start
    return tot


def _device_events(prof):
    """[(name, card index, start s, end s)] of every device activity, on
    the profiler's clock."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        s = e.time_range.start / 1e6
        out.append((e.name, int(e.device_index), s,
                    s + e.time_range.elapsed_us() / 1e6))
    return out


@contextlib.contextmanager
def profiled_job():
    """Profiles the block's device activity. Yields a dict that holds, once
    the block is over: ``wall_s`` and ``events`` (see ``_device_events``)."""
    from torch.profiler import ProfilerActivity, profile
    res = {}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        yield res
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        res["wall_s"] = time.time() - t0
    res["events"] = _device_events(prof)


def summarize(events, wall_s: float, cards: int, stages=None):
    """Busy seconds by card, kernel seconds by name, and the idle seconds
    of each stage of the job (``stages``: [(name, start s, end s)] on the
    profiler's clock) for the breakdown."""
    by_card = defaultdict(list)
    by_name = defaultdict(float)
    count = defaultdict(int)
    for name, card, s, e in events:
        by_card[card].append((s, e))
        by_name[name] += e - s
        count[name] += 1
    busy = {c: _union_s(by_card.get(c, [])) for c in range(cards)}
    idle = []
    for name, s0, s1 in stages or ():
        gap = 0.0
        for c in range(cards):
            inside = [(max(s, s0), min(e, s1)) for s, e in by_card.get(c, [])
                      if e > s0 and s < s1]
            gap += (s1 - s0) - _union_s(inside)
        idle.append((name, max(0.0, gap / cards)))
    return dict(busy=busy, by_name=dict(by_name), count=dict(count),
                idle=idle, wall_s=wall_s)
