"""The port's spans and counters (``relate_tpu_torch/utils/trace.py``):
spans nest and are recorded only when on, stage records carry their times
on the spans' clock, counters sum into the open record, and on a small
``run_all`` the counters agree with what the code and the files imply.
"""
import os
import threading
import time

import numpy as np
import pytest
import torch

from relate_tpu_torch.core import topology_device as ttd
from relate_tpu_torch.io.chunking import ArtifactStore
from relate_tpu_torch.parallel.pool import CardPool
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.utils import synth as tsynth
from relate_tpu_torch.utils import trace

torch.set_num_threads(1)

N, L, SEED = 8, 200, 5
MEMORY_GB = 1.1e-5           # two to three windows at this size


@pytest.fixture
def spans():
    """Spans on, on an empty list, for the test; off after it, and the list
    as it was."""
    saved = list(trace.SPANS)
    del trace.SPANS[:]
    trace.record_spans(True)
    yield trace.SPANS
    trace.record_spans(False)
    trace.SPANS[:] = saved


def test_spans_nest_carry_their_parent_and_thread(spans):
    """A span's parent is the span open around it on its own thread; a
    helper thread's spans nest in its own, even where the helper was
    carried into the caller's stage."""
    with trace.span("outer", card="cpu") as outer:
        with trace.span("inner") as inner:
            with trace.span("innermost"):
                pass

        def helper():
            with trace.span("helper"):
                with trace.span("helper.inner"):
                    pass
        t = threading.Thread(target=trace.carry(helper), name="helper-t")
        t.start()
        t.join()
    with trace.span("alone"):
        pass
    by = {s["name"]: s for s in spans}
    assert [s["name"] for s in spans] == [
        "outer", "inner", "innermost", "helper", "helper.inner", "alone"]
    assert outer is by["outer"] and inner is by["inner"]
    assert by["outer"]["parent"] is by["alone"]["parent"] is \
        by["helper"]["parent"] is None
    assert by["inner"]["parent"] == by["outer"]["id"]
    assert by["innermost"]["parent"] == by["inner"]["id"]
    assert by["helper.inner"]["parent"] == by["helper"]["id"]
    assert by["outer"]["card"] == "cpu" and "card" not in by["inner"]
    assert by["helper"]["thread"] == by["helper.inner"]["thread"] == \
        "helper-t"
    assert by["inner"]["thread"] == threading.current_thread().name
    o = by["outer"]
    for s in (by["inner"], by["innermost"], by["helper"]):
        assert o["start_ns"] <= s["start_ns"] <= s["end_ns"] <= o["end_ns"]
    assert len({s["id"] for s in spans}) == 6


def test_spans_off_record_nothing_and_touch_no_device(monkeypatch):
    """Off, a span is one shared context: nothing appended, no clock read,
    no ``torch.cuda`` function called."""
    trace.record_spans(False)
    calls = []

    def recorder(name):
        def f(*a, **k):
            calls.append(name)
            raise AssertionError(name)
        return f
    for name in ("synchronize", "is_available", "is_initialized",
                 "current_device", "current_stream", "Event",
                 "max_memory_allocated", "memory_allocated"):
        monkeypatch.setattr(torch.cuda, name, recorder(name))
    monkeypatch.setattr(trace, "now_ns", recorder("now_ns"))
    n0 = len(trace.SPANS)
    a = trace.span("x", card="cuda:0")
    b = trace.span("y")
    assert a is b
    with a as got:
        with b:
            assert got is None
    assert len(trace.SPANS) == n0 and calls == []


def test_stage_records_carry_their_times_on_the_spans_clock(spans):
    before = time.time_ns()
    with trace.stage("timed", verbose=False):
        with trace.span("in_stage"):
            time.sleep(0.01)
    after = time.time_ns()
    rec = trace.STAGES.pop()
    (s,) = spans
    assert before <= rec["start_ns"] <= s["start_ns"] < s["end_ns"] \
        <= rec["end_ns"] <= after
    assert abs((rec["end_ns"] - rec["start_ns"]) / 1e9 - rec["wall_s"]) \
        <= 5e-4
    assert s["end_ns"] - s["start_ns"] >= 10_000_000


def test_counts_sum_into_the_open_record(tmp_path):
    trace.count("nowhere", 5)                 # outside a stage: nothing
    with trace.stage("outer", verbose=False):
        trace.count("a")
        trace.count("a", 2)
        with trace.stage("inner", verbose=False):
            trace.count("a", 10)
            t = threading.Thread(target=trace.carry(trace.count),
                                 args=("b", 7))
            t.start()
            t.join()
        p = tmp_path / "f.bin"
        p.write_bytes(b"x" * 123)
        trace.wrote(str(p))
    outer = trace.STAGES.pop()
    inner = trace.STAGES.pop()
    assert inner["counts"] == {"a": 10, "b": 7}
    assert outer["counts"] == {"a": 3, "bytes_written": 123}
    rec = {"counts": {"a": 1}, "k": [1]}
    trace.merge(rec, {"counts": {"a": 2, "c": 1}, "k": [2]})
    assert rec == {"counts": {"a": 3, "c": 1}, "k": [1, 2]}


def _panel(tmp):
    G, bp = tsynth.synth_coalescent_panel(N, L, seed=SEED)[:2]
    rng = np.random.default_rng(SEED)
    G = np.where(rng.random(G.shape) < 0.03, 1 - G, G).astype(np.uint8)
    prefix = str(tmp / "panel")
    tsynth.write_haps_sample(G, bp, prefix)
    tsynth.write_flat_map(str(tmp / "map.txt"), int(bp[-1]), cm_per_mb=40.0)
    return (prefix + ".haps", prefix + ".sample", str(tmp / "map.txt"))


@pytest.mark.parametrize("fault", [False, True], ids=["sound", "no_rebuild"])
def test_run_all_counts_what_the_code_and_the_files_imply(
        spans, tmp_path, monkeypatch, fault):
    """On the small panel: one read back a mapping (a block's pass or a
    candidate's), two a rebuild at most plus one a block of ``KB`` SNPs;
    the reverts are the trees built and not kept; ``bytes_written`` of each
    stage is the size of the files it wrote, as they lie in the store."""
    maps = []
    orig = ttd._map_on_tree

    def mapped(leafmat, csize, car, tc, N, M, thr, cc=None):
        maps.append(car.shape[0])
        m = orig(leafmat, csize, car, tc, N, M, thr, cc)
        if fault and car.shape[0] == 1:
            # every one-SNP mapping reads as no better: candidates revert
            m = m._replace(im=torch.full_like(m.im, 3),
                           branch=torch.full_like(m.branch, -1),
                           flipped=torch.zeros_like(m.flipped),
                           minv=torch.full_like(m.minv, float("inf")))
        return m
    monkeypatch.setattr(ttd, "_map_on_tree", mapped)
    out = str(tmp_path / "out")
    n0 = len(trace.STAGES)
    trelate.run_all(*_panel(tmp_path), out, seed=1, memory_gb=MEMORY_GB,
                    verbose=False, device="cpu", cleanup=False)
    recs = {r["stage"]: r for r in trace.STAGES[n0:]}
    store = ArtifactStore(out + ".tmpdir")
    ch = store.load_chunk(0)
    W = ch.windows.num_windows
    assert W >= 2

    bt = recs["chunk0.build_topology"]
    notes = bt["topology"]
    builds = sum(n["tree_builds"] for n in notes)
    rebuilds = builds - W
    bounds = list(ch.windows.boundaries[:W]) + [ch.L]
    blocks = sum(-(-(bounds[w + 1] - bounds[w]) // ttd.KB) for w in range(W))
    reads = bt["counts"]["topology.readbacks"]
    assert reads == len(maps)
    assert blocks + rebuilds <= reads <= blocks + 2 * rebuilds
    reverts = bt["counts"].get("topology.reverts", 0)
    assert reverts == builds - sum(n["trees"] for n in notes)
    assert (reverts == rebuilds > 0) if fault else rebuilds > 0
    names = [s["name"] for s in spans]
    assert names.count("topology.readback") == reads
    assert names.count("topology.rebuild") == rebuilds
    assert names.count("topology.map") == reads - rebuilds

    def size(*parts):
        return os.path.getsize(store.path(*parts))
    trees = sum(size("chunk_0", f"trees_{w}.anc") for w in range(W))
    want = {
        "chunk0.paint": sum(size("chunk_0", f"paint_{w}.npz")
                            for w in range(W)),
        "chunk0.build_topology": trees + sum(
            size("chunk_0", f"muts_{w}.mut") for w in range(W)),
        "chunk0.find_equivalent_branches": trees,
        "chunk0.infer_branch_lengths": trees,
        "chunk0.combine_sections": sum(size("chunk_0", f) for f in (
            "combined.anc", "combined.mut", "DONE")),
        "finalize": sum(os.path.getsize(out + e) for e in (".anc", ".mut")),
    }
    assert {k: r["counts"]["bytes_written"] for k, r in recs.items()} == want
    iters = recs["chunk0.infer_branch_lengths"]["counts"]["chains.iterations"]
    assert iters == names.count("chains.iteration") > 0
    for r in recs.values():
        assert r["start_ns"] <= r["end_ns"]


def test_clade_rows_count_a_read_a_level(spans):
    """The merge scan's clade rows from its merge lists (the B6 path) read
    back once a level of the tree: each read a span and a count, under the
    merge scan's own names."""
    from relate_tpu_torch.ops.merge_scan import clades_from_merges
    cis = torch.tensor([0, 2, 4], dtype=torch.int32)     # ((0,1),(2,3))
    cjs = torch.tensor([1, 3, 5], dtype=torch.int32)
    with trace.stage("clades", verbose=False):
        C = clades_from_merges(cis, cjs, 4)
    rec = trace.STAGES.pop()
    assert C.tolist() == [[1, 1, 0, 0], [0, 0, 1, 1], [1, 1, 1, 1]]
    assert rec["counts"] == {"merge_scan.readbacks": 3}  # height 2, + 1
    assert [s["name"] for s in spans] == ["merge_scan.readback"] * 3


def test_pool_workers_counts_reach_the_parent(tmp_path):
    """InferBranchLengths through a pool of two ``"cpu"`` workers: the
    workers' counts join the caller's stage record and equal those of the
    same sections run in process."""
    out = str(tmp_path / "out")
    trelate.run_all(*_panel(tmp_path), out, seed=1, memory_gb=MEMORY_GB,
                    verbose=False, device="cpu", cleanup=False)
    store = ArtifactStore(out + ".tmpdir")
    W = store.load_chunk(0).windows.num_windows
    with trace.stage("ibl", verbose=False):
        trelate.infer_branch_lengths(store, 0, seed=1, device="cpu")
    here = trace.STAGES.pop()["counts"]
    with CardPool(["cpu"] * 2, timeout_s=300) as pool:
        with trace.stage("ibl", verbose=False):
            trelate.infer_branch_lengths(store, 0, seed=1, device="cpu",
                                         pool=pool)
    pooled = trace.STAGES.pop()["counts"]
    assert pooled == here
    assert pooled["chains.iterations"] > 0
    assert pooled["bytes_written"] == sum(
        os.path.getsize(store.path("chunk_0", f"trees_{w}.anc"))
        for w in range(W))
