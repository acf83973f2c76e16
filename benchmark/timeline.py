#!/usr/bin/env python3
"""Where one job's time goes, on the program's own clock: a tool beside the
benchmark, for splitting a stage before and after a change to it.

    python3 benchmark/timeline.py --workload <cell> --seed <n>

makes the cell's chromosome and regions as ``run.py`` does (``load_cell``
and the traffic's ``Traffic``), runs the warm-up job, then two jobs with
the program's spans on (``relate_tpu_torch.utils.trace.record_spans``): the
first under ``torch.profiler`` with CUDA activity only, the second without.
It prints one JSON line:

- ``spans``, from the second job: a row a span name (how many, seconds a
  kSNP, seconds a kSNP outside its child spans), and a row
  ``<stage>.unspanned`` a stage record (its seconds a kSNP outside every
  span);
- from the profiled job, its events put on the program's clock:
  ``clock_offset_ns`` (which clock the profiler stamps, found, not
  assumed), ``idle_s.build_topology`` (the card's idle seconds inside the
  BuildTopology records, a kSNP), ``idle_covered_share`` (the card's idle
  seconds inside a stage record or a top-level span, over all of the
  job's) with ``idle_outside_s``, and ``launches_per_chain_iter`` (the
  host's launch calls inside ``chains.iteration`` spans, over the records'
  ``chains.iterations``).

It checks no output and gives no end-to-end metric: those are ``run.py``'s.
``run.py`` does not turn spans on; a reader of ``metrics/`` can read only
what it hands them.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import importlib
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# host calls that put work on a card
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cuLaunchCooperativeKernel",
                "cudaGraphLaunch", "cuGraphLaunch")


def program_clock_offset_ns(trace_start_ns: int, real: tuple,
                            mono: tuple) -> int:
    """ns to add to a time on the profiler's clock to put it on the
    program's (the host's real-time clock). ``real`` and ``mono``: the
    real-time and monotonic clocks read before and after the profiler
    started; its ``trace_start_ns`` lies between the readings of its own
    clock."""
    if real[0] <= trace_start_ns <= real[1]:
        return 0
    if mono[0] <= trace_start_ns <= mono[1]:
        return (real[0] - mono[0] + real[1] - mono[1]) // 2
    raise RuntimeError(f"the profiler's start {trace_start_ns} ns is on "
                       "neither the real-time nor the monotonic clock")


@contextlib.contextmanager
def profiled():
    """The block under ``torch.profiler`` (CUDA activity only). The dict it
    yields holds, once the block is over, on the program's clock:
    ``device_events`` [(name, card, start ns, end ns)], ``launches``
    [start ns of each launch call], ``clock_offset_ns``, and the block's
    ``start_ns`` and ``end_ns``. Without a card nothing is profiled and
    both lists are empty."""
    import torch
    from relate_tpu_torch.utils import trace
    res = dict(device_events=[], launches=[], clock_offset_ns=0)
    if not torch.cuda.is_available():
        res["start_ns"] = trace.now_ns()
        yield res
        res["end_ns"] = trace.now_ns()
        return
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    real0, mono0 = time.time_ns(), time.monotonic_ns()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        real1, mono1 = time.time_ns(), time.monotonic_ns()
        res["start_ns"] = trace.now_ns()
        yield res
        for d in range(torch.cuda.device_count()):
            torch.cuda.synchronize(d)
        res["end_ns"] = trace.now_ns()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    off = program_clock_offset_ns(t0, (real0, real1), (mono0, mono1))
    res["clock_offset_ns"] = off
    for e in prof.events():
        s = t0 + off + round(e.time_range.start * 1e3)
        if e.device_type == DeviceType.CUDA:
            res["device_events"].append(
                (e.name, int(e.device_index), s,
                 t0 + off + round(e.time_range.end * 1e3)))
        elif e.name in LAUNCH_CALLS:
            res["launches"].append(s)


def union(intervals):
    """The disjoint union of [(start, end)], sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def count_inside(times, intervals) -> int:
    """How many of ``times`` lie inside one of ``intervals``."""
    spans = union(intervals)
    starts = [a for a, _ in spans]
    n = 0
    for t in times:
        i = bisect.bisect_right(starts, t) - 1
        n += i >= 0 and t <= spans[i][1]
    return n


def idle_ns(device_events, card: int, intervals) -> int:
    """ns of ``intervals`` (disjoint or not) in which ``card`` ran no
    kernel, copy or set."""
    spans = union(intervals)
    busy = union([(max(s, a), min(e, b)) for _, c, s, e in device_events
                  if c == card for a, b in spans if e > a and s < b])
    return sum(b - a for a, b in spans) - sum(b - a for a, b in busy)


def span_table(stages, spans, snps: int) -> dict:
    """{name: [spans, seconds a kSNP, seconds a kSNP outside its child
    spans]} of a job's ``spans``, and {``<stage>.unspanned``: [1, seconds a
    kSNP of the record outside every span]} of its ``stages``."""
    ksnp = snps / 1e3
    inner = {}
    for s in spans:
        if s["parent"] is not None:
            inner[s["parent"]] = inner.get(s["parent"], 0) + \
                s["end_ns"] - s["start_ns"]
    out = {}
    for s in spans:
        d = s["end_ns"] - s["start_ns"]
        row = out.setdefault(s["name"], [0, 0.0, 0.0])
        row[0] += 1
        row[1] += d / 1e9 / ksnp
        row[2] += (d - inner.get(s["id"], 0)) / 1e9 / ksnp
    top = union((s["start_ns"], s["end_ns"]) for s in spans
                if s["parent"] is None)
    for r in stages:
        a, b = r["start_ns"], r["end_ns"]
        covered = sum(min(e, b) - max(s, a) for s, e in top
                      if e > a and s < b)
        out[r["stage"].split(".", 1)[-1] + ".unspanned"] = [
            1, (b - a - covered) / 1e9 / ksnp, (b - a - covered) / 1e9 / ksnp]
    return out


def read_profiled(prof: dict, stages, spans, snps: int) -> dict:
    """The profiled job's numbers (see the module docstring)."""
    ev = prof["device_events"]
    a, b = prof["start_ns"], prof["end_ns"]
    whole = idle_ns(ev, 0, [(a, b)])
    inside = [(r["start_ns"], r["end_ns"]) for r in stages]
    inside += [(s["start_ns"], s["end_ns"]) for s in spans
               if s["parent"] is None]
    got = idle_ns(ev, 0, [(max(s, a), min(e, b)) for s, e in inside
                          if e > a and s < b])
    bt = [(r["start_ns"], r["end_ns"]) for r in stages
          if r["stage"].split(".", 1)[-1] == "build_topology"]
    iters = sum(r.get("counts", {}).get("chains.iterations", 0)
                for r in stages)
    chain = [(s["start_ns"], s["end_ns"]) for s in spans
             if s["name"] == "chains.iteration"]
    return {
        "clock_offset_ns": prof["clock_offset_ns"],
        "idle_s.build_topology": idle_ns(ev, 0, bt) / 1e9 / snps * 1e3,
        "idle_covered_share": got / whole if whole else None,
        "idle_outside_s": (whole - got) / 1e9,
        "launches_per_chain_iter": (
            count_inside(prof["launches"], chain) / iters
            if prof["launches"] and iters else None),
        "launches": len(prof["launches"]),
    }


def timeline(workload: str, seed: int, device=None) -> dict:
    """The JSON line's dict for one cell and seed (``device`` "cpu" for the
    tests; the card by default)."""
    import torch
    from benchmark import run
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import trace

    _, cell, cfg, tparams = run.load_cell(workload)
    if device is None:
        device = torch.device("cuda:0")
    elif "memory_gb_off_card" in tparams:
        tparams = dict(tparams, memory_gb=tparams["memory_gb_off_card"])
    gen = importlib.import_module(
        f"benchmark.traffic.{tparams['generator']}")
    work = tempfile.mkdtemp(prefix="relate_timeline_")
    try:
        traffic = gen.Traffic(cfg, tparams, seed, os.path.join(work, "in"))
        traffic.run(relate, -1, os.path.join(work, "warm"), device)
        trace.record_spans(True)
        jobs = []
        for i in range(2):
            n0, s0 = len(trace.STAGES), len(trace.SPANS)
            ctx = profiled() if i == 0 else contextlib.nullcontext({})
            with ctx as prof:
                snps = traffic.run(relate, i, os.path.join(work, str(i)),
                                   device)
            jobs.append((prof, trace.STAGES[n0:], trace.SPANS[s0:], snps))
    finally:
        trace.record_spans(False)
        shutil.rmtree(work, ignore_errors=True)
    out = dict(workload=workload, seed=seed)
    out.update(read_profiled(*jobs[0]))
    out["spans"] = span_table(*jobs[1][1:])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card: the timeline is read on the card",
              file=sys.stderr)
        return 2
    print(json.dumps(timeline(a.workload, a.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
