"""The port's pool of one process a card (``relate_tpu_torch/parallel/
pool.py``) and InferBranchLengths on it, on this host: a pool of ``"cpu"``
entries, one spawned process each (at most 3 a test: each imports torch).

Tolerances: InferBranchLengths through a pool writes one device's files
byte for byte; the pool's results and notes are exact.
"""
import filecmp
import multiprocessing
import operator
import os
import shutil
import time

import numpy as np
import pytest
import torch

from relate_tpu_torch.io import ancmut
from relate_tpu_torch.io.chunking import ArtifactStore
from relate_tpu_torch.parallel import mesh as tmesh
from relate_tpu_torch.parallel.pool import HERE, CardPool
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.utils import synth, trace

torch.set_num_threads(1)

MEMORY_GB = 1.1e-5          # the 12 x 200 panel below plans 4 windows


def _no_children():
    for p in multiprocessing.active_children():
        p.join(5.0)
    return not multiprocessing.active_children()


def test_pool_deals_jobs_and_returns_them_in_order():
    """Jobs handed out in a given order to the first free worker; results
    and the tasks' notes come back in the jobs' order, ``HERE`` is each
    worker's device, and both workers take jobs."""
    pool = CardPool(["cpu"] * 2, timeout_s=300)
    try:
        start = pool.start_s()
        assert len(start) == 2 and all(s > 0 for s in start)
        assert pool.map(operator.add, [(1, 2), (3, 4), (5, 6)],
                        order=[2, 0, 1]) == [3, 7, 11]
        assert pool.map(str, [(HERE,)]) == ["cpu"]
        with trace.stage("pool_notes", verbose=False):
            pool.map(trace.note, [("k", i) for i in range(6)],
                     order=[5, 4, 3, 2, 1, 0])
        assert trace.STAGES[-1]["k"] == list(range(6))
        pids = set(pool.map(os.getpid, [()] * 8))
        assert len(pids) == 2 and os.getpid() not in pids
        with pytest.raises(ValueError, match="permutation"):
            pool.map(operator.add, [(1, 2)], order=[1])
    finally:
        pool.close()
    assert _no_children()
    with pytest.raises(RuntimeError, match="closed"):
        pool.map(operator.add, [(1, 2)])


def test_many_threads_share_one_pool():
    """Chunks run on threads share ``run_all``'s pool: 12 threads (more than
    this host's cores), with a short switch interval, each asking for the
    pool's start and mapping jobs at once, all get their own results."""
    import sys
    from concurrent.futures import ThreadPoolExecutor
    pool = CardPool(["cpu"] * 2, timeout_s=300)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            assert len(pool.start_s()) == 2
            return pool.map(operator.mul, [(t, i) for i in range(5)])
        with ThreadPoolExecutor(max_workers=12) as ex:
            futs = [ex.submit(work, t) for t in range(12)]
            got = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
        pool.close()
    assert got == [[t * i for i in range(5)] for t in range(12)]
    assert _no_children()


def test_a_failing_task_raises_with_the_workers_traceback():
    """A task that raises in a worker raises in the caller with the
    worker's traceback; the pool then stops every worker, runs the task
    nowhere else and leaves no process."""
    pool = CardPool(["cpu"] * 2, timeout_s=300)
    with pytest.raises(RuntimeError, match="failed on cpu") as err:
        pool.map(operator.truediv, [(1, 1), (1, 0), (2, 1)])
    msg = str(err.value)
    assert "Traceback (most recent call last)" in msg
    assert "ZeroDivisionError" in msg
    assert _no_children()
    pool.close()                                # a second close is harmless
    assert _no_children()


def test_a_dead_or_late_worker_raises():
    """A worker that dies mid-task, or outlasts the pool's timeout, raises
    in the caller; no process is left either way."""
    pool = CardPool(["cpu"] * 2, timeout_s=300)
    with pytest.raises(RuntimeError, match="exit code 3"):
        pool.map(os._exit, [(3,)])
    assert _no_children()
    pool = CardPool(["cpu"], timeout_s=300)
    pool.start_s()
    pool.timeout_s = 2.0                # a task's limit, once started
    t0 = time.time()
    with pytest.raises(TimeoutError, match="within 2.0 s"):
        pool.map(time.sleep, [(60,)])
    assert time.time() - t0 < 30
    assert _no_children()


def test_a_pool_on_a_card_never_turns_to_the_cpu():
    """Without a card, a worker for ``cuda:0`` fails as it enters the card,
    and the pool raises its traceback; it does not run on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with CardPool(["cuda:0"], timeout_s=300) as pool:
        with pytest.raises(RuntimeError, match="failed to start") as err:
            pool.map(str, [(HERE,)])
    assert "set_device" in str(err.value)
    assert _no_children()


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    """``run_all`` on one device, its store kept: the reference files."""
    tmp = tmp_path_factory.mktemp("one")
    G, bp = synth.synth_coalescent_panel(12, 200, seed=5)[:2]
    prefix = str(tmp / "panel")
    synth.write_haps_sample(G, bp, prefix)
    synth.write_flat_map(prefix + ".map", int(bp[-1]))
    args = (prefix + ".haps", prefix + ".sample", prefix + ".map")
    out = trelate.run_all(*args, str(tmp / "one"), seed=1,
                          memory_gb=MEMORY_GB, verbose=False, device="cpu",
                          cleanup=False)
    return args, out


def _sections(store, W):
    return [store.path("chunk_0", f"trees_{w}.anc") for w in range(W)]


def test_infer_branch_lengths_on_a_given_pool(one_device, tmp_path):
    """InferBranchLengths again on a finished store through a pool of 3
    (two sections go to whichever worker is free first): every section's
    file is written again byte for byte (the chains do not read the
    lengths they replace), the stage record has one ``mcmc`` note a
    section in window order and the pool's start by worker, and the
    cache's trees get the lengths written."""
    _, one = one_device
    shutil.copytree(one + ".tmpdir", str(tmp_path / "store"))
    store = ArtifactStore(str(tmp_path / "store"))
    W = store.load_chunk(0).windows.num_windows
    assert W == 4
    want = [open(p, "rb").read() for p in _sections(store, W)]
    cache = {}
    for w, p in enumerate(_sections(store, W)):
        anc = ancmut.read_anc_bin(p)
        for mt in anc.seq:
            mt.tree.branch_length = np.zeros_like(mt.tree.branch_length)
        cache[("anc", 0, w)] = anc
    with CardPool(tmesh.Mesh(["cpu"] * 3), timeout_s=300) as pool:
        with trace.stage("ibl", verbose=False):
            trelate.infer_branch_lengths(store, 0, seed=1, cache=cache,
                                         device="cpu", pool=pool)
    rec = trace.STAGES[-1]
    assert len(rec["pool_start_s"]) == 3
    assert [m["chains"] for m in rec["mcmc"]] == \
        [len(cache[("anc", 0, w)].seq) for w in range(W)]
    for w, p in enumerate(_sections(store, W)):
        assert open(p, "rb").read() == want[w], w
        got = [mt.tree.branch_length for mt in cache[("anc", 0, w)].seq]
        ref = [mt.tree.branch_length for mt in ancmut.read_anc_bin(p).seq]
        assert all(np.array_equal(a, b) for a, b in zip(got, ref))
    assert _no_children()


def test_no_pool_without_several_devices(one_device, tmp_path, monkeypatch):
    """``mesh=None`` and a mesh of one device start no process: their
    files are those of one device."""
    args, one = one_device

    def no_pool(*a, **kw):
        raise AssertionError("a pool was started")
    monkeypatch.setattr(trelate, "CardPool", no_pool)
    for name, kw in (("none", dict(device="cpu")),
                     ("single", dict(mesh=tmesh.Mesh(["cpu"])))):
        out = trelate.run_all(*args, str(tmp_path / name), seed=1,
                              memory_gb=MEMORY_GB, verbose=False, **kw)
        for ext in (".anc", ".mut"):
            assert filecmp.cmp(one + ext, out + ext, shallow=False), ext
        assert not multiprocessing.active_children()
    store = ArtifactStore(one + ".tmpdir")
    trelate.infer_branch_lengths(store, 0, seed=1, mesh=["cpu"])
    assert not multiprocessing.active_children()


def test_run_all_leaves_no_worker_after_a_failure(one_device, tmp_path,
                                                  monkeypatch):
    """A section's task that fails in a worker of ``run_all``'s pool
    raises from ``run_all`` with the worker's traceback, and the pool's
    processes are gone."""
    args, _ = one_device
    # a stand-in task that raises in the worker (TypeError: too many
    # arguments), picklable by reference
    monkeypatch.setattr(trelate, "section_branch_lengths", operator.neg)
    with pytest.raises(RuntimeError, match="TypeError") as err:
        trelate.run_all(*args, str(tmp_path / "bad"), seed=1,
                        memory_gb=MEMORY_GB, verbose=False,
                        mesh=tmesh.Mesh(["cpu"] * 2))
    assert "Traceback" in str(err.value)
    assert _no_children()
