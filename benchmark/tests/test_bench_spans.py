"""The program's spans and counters as the benchmark reads them: the
registered readers of the counters on a tiny traced run of ``run.py`` on
the CPU, ``timeline.py`` on a tiny job, and, on the card, the proof that
the profiler's clock and the program's agree:

    python3 -m pytest benchmark/tests/test_bench_spans.py -q -s -k card
"""
import contextlib
import json
import time

import pytest

from benchmark import run, timeline

SEED = 2**33 + 29
COUNTERS = ("syncs_per_build", "written_mb_per_ksnp")


def tiny(monkeypatch, N=24, job_snps=300):
    bench, cell, cfg, tr = run.load_cell("kgp_eur.all")
    cfg = dict(cfg, haplotypes=N, chromosome_snps=4000)
    tr = dict(tr, job_snps=job_snps, regions=2, warmup_snps=100,
              memory_gb_off_card=0.001)
    monkeypatch.setattr(run, "load_cell", lambda name: (bench, cell, cfg, tr))


def test_traced_run_reads_the_counters(monkeypatch):
    """On the CPU, with a profiler that sees no card: the readers of the
    program's counters read, the line keeps its keys, and on records
    without counts (the parent's program) the readers give nothing."""
    from benchmark import devtrace
    tiny(monkeypatch)

    @contextlib.contextmanager
    def no_profiler():             # what the profiler returns seeing no card
        res = {}
        t0 = time.time()
        yield res
        res.update(wall_s=time.time() - t0, events=[])
    monkeypatch.setattr(devtrace, "profiled_job", no_profiler)
    ctxs = []
    read = run.read_metric

    def keep(name, ctx):
        ctxs.append(ctx)
        return read(name, ctx)
    monkeypatch.setattr(run, "read_metric", keep)
    res = run.run_cell("kgp_eur.all", SEED, 0.2, True, time.time(),
                       device="cpu")
    assert res["correct"], res["checks"]
    line = json.loads(run.result_line(res))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "checks"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"stage_s.paint", "stage_s.build_topology",
            "tree_builds_per_ksnp"} <= set(line["metrics"])
    got = {k: line["metrics"][k]["value"] for k in COUNTERS}
    assert 1.0 <= got["syncs_per_build"] <= 3.0
    assert got["written_mb_per_ksnp"] > 0
    ctx = ctxs[-1]
    parent = dict(ctx, jobs=[dict(j, stages=[
        {k: v for k, v in r.items() if k not in ("counts", "start_ns",
                                                   "end_ns")}
        for r in j["stages"]]) for j in ctx["jobs"]])
    assert all(read(name, parent) is None for name in COUNTERS)


def test_timeline_of_a_tiny_job(monkeypatch):
    """``timeline.py`` on the CPU: the spans split the stages, and with no
    device event the whole job is idle, nearly all of it inside a stage
    record or a top-level span."""
    tiny(monkeypatch)
    tl = timeline.timeline("kgp_eur.all", SEED, device="cpu")
    assert tl["clock_offset_ns"] == 0 and tl["launches"] == 0
    assert tl["launches_per_chain_iter"] is None
    assert tl["idle_s.build_topology"] > 0
    assert 0.9 <= tl["idle_covered_share"] <= 1.0
    assert tl["idle_outside_s"] >= 0
    table = tl["spans"]
    assert {"make_chunks", "load_chunk", "paint.sweeps", "paint.write",
            "topology.first_tree", "topology.map", "topology.readback",
            "topology.collect", "topology.tree_from_merges",
            "topology.force_map", "chains.iteration",
            "build_topology.unspanned"} <= set(table)
    rebuilds = table.get("topology.rebuild", [0])[0]
    n, total, own = table["topology.map"]
    assert n == table["topology.readback"][0] - rebuilds
    assert 0 < own < total
    for n, total, own in table.values():
        assert n > 0 and 0 <= own <= total


def test_clock_offset_follows_the_profilers_clock():
    real, mono = (1000, 1010), (50, 60)
    assert timeline.program_clock_offset_ns(1005, real, mono) == 0
    assert timeline.program_clock_offset_ns(55, real, mono) == 950
    with pytest.raises(RuntimeError):
        timeline.program_clock_offset_ns(500, real, mono)


def test_idle_and_counts_inside_intervals():
    ev = [("k", 0, 10, 20), ("k", 0, 15, 30), ("c", 1, 0, 100),
          ("k", 0, 50, 60)]
    assert timeline.idle_ns(ev, 0, [(0, 40)]) == 20
    assert timeline.idle_ns(ev, 0, [(0, 40), (30, 70)]) == 40
    assert timeline.idle_ns(ev, 1, [(0, 40)]) == 0
    assert timeline.count_inside([5, 10, 25, 40, 41], [(10, 20), (20, 40)]) \
        == 3


@pytest.mark.card
def test_a_kernel_lies_inside_its_span_on_the_shared_clock(card):
    """A span around a kernel of known length and the readback after it:
    on the program's clock the card's interval of the kernel lies inside
    the span, within 50 us (the clocks' agreement), and the span ends at
    most 250 us after the readback's copy ends (200 us for the host's
    return from its wait, plus those 50 us)."""
    import torch
    from relate_tpu_torch.utils import trace
    x = torch.ones(16, device=card)
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    trace.record_spans(True)
    try:
        with timeline.profiled() as res:
            for _ in range(3):
                with trace.span("sleep") as s:
                    torch.cuda._sleep(20_000_000)
                    x.sum().cpu()
                time.sleep(0.01)
    finally:
        trace.record_spans(False)
    spans = [s for s in trace.SPANS[-3:] if s["name"] == "sleep"]
    ev = sorted(res["device_events"], key=lambda e: e[2])
    sleeps = [e for e in ev if "spin_kernel" in e[0]]
    assert len(spans) == 3 and len(sleeps) == 3, ev
    tol = 50_000
    for s, k in zip(spans, sleeps):
        copy = next(e for e in ev if e[2] >= k[3] and "DtoH" in e[0])
        print(f"[clock] offset {res['clock_offset_ns']} ns; kernel "
              f"{(k[2] - s['start_ns']) / 1e3:.1f} us after the span's "
              f"start, {(k[3] - k[2]) / 1e3:.1f} us long, ends "
              f"{(s['end_ns'] - k[3]) / 1e3:.1f} us before the span; "
              f"span ends {(s['end_ns'] - copy[3]) / 1e3:.1f} us after "
              f"the readback's copy", flush=True)
        assert s["start_ns"] - tol <= k[2] < k[3] <= s["end_ns"] + tol
        assert -tol <= s["end_ns"] - copy[3] <= 200_000 + tol
