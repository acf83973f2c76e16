"""The port's mesh (``relate_tpu_torch/parallel/mesh.py`` and the ``mesh=``
of its callers) against one device and against the JAX package's mesh.

On this host the port's meshes are repeated ``"cpu"`` entries, the JAX
package's its 8 virtual CPU devices (``tests/conftest.py``). Tolerances:
the port on a mesh equals the port on one device bit for bit (the sharded
Painter, the chains, ``run_all``'s bytes); against the JAX package the
counts and the shards are equal, the sharded painter against the JAX
package's sharded scan at rtol 1e-6 (slabs and posterior; measured: 4.7e-7
and 9.8e-7) and atol 1e-4 (logscales; measured 1.1e-5), the forward sweep
of ``make_sharded_paint_fn`` at the tolerances of ``test_torch_painting.py``
(rtol 1e-4, atol 1e-3), the branch lengths in distribution as in
``test_torch_mcmc_posterior.py``, and ``run_all``'s files byte for byte
with the chains of both packages replaced by one function of the tree.
"""
import filecmp
import multiprocessing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from relate_tpu.core import mcmc as jmcmc
from relate_tpu.core import painting as jpainting
from relate_tpu.core import topology_device as jtd
from relate_tpu.core.treebuilder import quick_build as jquick_build
from relate_tpu.parallel import mesh as jmesh
from relate_tpu.pipeline import relate as jrelate
from relate_tpu_torch import convert
from relate_tpu_torch.core import mcmc as tmcmc
from relate_tpu_torch.core import painting as tpainting
from relate_tpu_torch.core import topology_device as ttd
from relate_tpu_torch.ops import paint_kernels as pk
from relate_tpu_torch.parallel import mesh as tmesh
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.utils import synth, trace

torch.set_num_threads(1)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="the JAX side needs 8 jax devices")


def cpu_mesh(n):
    return tmesh.Mesh(["cpu"] * n)


@needs_8
def test_dryrun_8_matches_jax():
    """``dryrun(8)``: a painting sweep, one chain step and the reduced
    counts on 8 shards. The port checks its reduced counts against a host
    count itself; both packages count every node of the 16 chains once."""
    got = tmesh.dryrun(8, device="cpu")
    want = np.asarray(jmesh.dryrun(8))
    assert got.shape == want.shape == (4,)
    assert np.isfinite(got).all() and got.sum() == want.sum() == 16 * 31
    assert got[0] >= 16 * 16          # the leaves, at age 0
    with pytest.raises(RuntimeError, match="8-card mesh"):
        tmesh.dryrun(8)               # no card here: the default is cards


@needs_8
@pytest.mark.parametrize("B", [16, 13], ids=["even", "ragged"])
def test_coalescence_counts_psum_matches_numpy_and_jax(B):
    rng = np.random.default_rng(1)
    ages = rng.random((B, 31)).astype(np.float32) * 3.0 - 0.2
    epochs = np.array([0.0, 0.5, 1.0, 2.0], np.float32)
    got = tmesh.coalescence_counts_psum(cpu_mesh(8), ages, epochs)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    e = np.searchsorted(epochs, ages, side="right") - 1
    want = np.bincount(e[e >= 0], minlength=len(epochs)).astype(np.float32)
    assert np.array_equal(got.numpy(), want)
    if B % 8 == 0:
        jgot = jmesh.coalescence_counts_psum(jmesh.default_mesh(8), ages,
                                             epochs)
        assert np.array_equal(got.numpy(), np.asarray(jgot))


def _static(B, M):
    return dict(
        parent=np.zeros((B, M), np.int32), child_left=np.zeros((B, M), np.int32),
        child_right=np.zeros((B, M), np.int32),
        num_events=np.arange(B * M, dtype=np.float32).reshape(B, M),
        mut_rate=np.zeros((B, M), np.float32),
        kc2_pos=np.arange(M, dtype=np.float32),   # M = 31 does not divide 8
        epochs=np.arange(5, dtype=np.float32), rates=np.ones((B, 4), np.float32),
        cumR=np.zeros((B, 5), np.float32))


@needs_8
def test_shard_batch_replicates_constants_as_jax():
    """B = 16 chains on 8 shards: the batch leaves cut in blocks of two rows
    (JAX's shards, device by device), the (M,) and (E,) constants whole on
    every shard; B = 5 leaves the last three shards no rows."""
    B, M = 16, 31
    host = _static(B, M)
    jst = jmcmc.ChainStatic(**{k: jnp.asarray(v) for k, v in host.items()})
    placed = jmesh.shard_batch(jmesh.default_mesh(8), jst, B)
    st = tmcmc.ChainStatic(depth=None, **{k: torch.from_numpy(v)
                                           for k, v in host.items()})
    parts = tmesh.shard_batch(cpu_mesh(8), st, B)
    assert len(parts) == 8
    jshards = sorted(placed.num_events.addressable_shards,
                     key=lambda s: s.device.id)
    for k, part in enumerate(parts):
        assert np.array_equal(part.num_events.numpy(),
                              np.asarray(jshards[k].data))
        assert part.parent.shape == (2, M)
        assert np.array_equal(part.kc2_pos.numpy(), host["kc2_pos"])
        assert np.array_equal(part.epochs.numpy(), host["epochs"])
        assert part.depth is None and part.F is None
    for s in placed.kc2_pos.addressable_shards:
        assert np.array_equal(np.asarray(s.data), host["kc2_pos"])
    rows = [p.parent.shape[0] for p in
            tmesh.shard_batch(cpu_mesh(8), tmcmc.ChainStatic(
                depth=None, **{k: torch.from_numpy(v)
                               for k, v in _static(5, M).items()}), 5)]
    assert rows == [1, 1, 1, 1, 1, 0, 0, 0]


def _panel(seed, N, L, p=0.3):
    rng = np.random.default_rng(seed)
    G = (rng.random((L, N)) < p).astype(np.uint8)
    r = rng.random(L) * 0.05
    return G, r


@needs_8
def test_sharded_painter_equals_one_device_and_matches_jax():
    """N = 12 targets with a mesh of 8 shards (the sweeps on the first,
    a replica a shard for BuildTopology): the checkpoints, the posteriors
    and the plans equal the one-device Painter's bit for bit; against the
    JAX package's sharded Painter (its scan, as in tests/test_mesh.py) at
    rtol 1e-6, the logscales at atol 1e-4."""
    G, r = _panel(3, 12, 200)
    L, N = G.shape
    bounds = np.array([0, 70, 140, L])
    model = tpainting.PaintingModel(N=N, theta=0.001)
    one = tpainting.Painter(G, r, model, device="cpu")
    sh = tpainting.Painter(G, r, model, mesh=cpu_mesh(8))
    assert len(sh.shards) == 8 and sh.device.type == "cpu"
    assert all(p.mesh is None and p.device == sh.device for p in sh.shards)
    jp = jpainting.Painter(G, r, jpainting.PaintingModel(N=N, theta=0.001),
                           mesh=jmesh.default_mesh(8))
    cps1 = one.paint_stepping_stones(bounds)
    cps = sh.paint_stepping_stones(bounds)
    cpsj = jp.paint_stepping_stones(bounds)
    for c1, c, cj in zip(cps1, cps, cpsj):
        for f in ("alpha", "beta", "ls_alpha", "ls_beta", "bsb", "bse"):
            assert np.array_equal(getattr(c1, f), getattr(c, f)), f
        assert np.array_equal(c.bsb, cj.bsb) and np.array_equal(c.bse, cj.bse)
        np.testing.assert_allclose(c.alpha, np.asarray(cj.alpha), rtol=1e-6,
                                   atol=1e-30)
        np.testing.assert_allclose(c.beta, np.asarray(cj.beta), rtol=1e-6,
                                   atol=1e-30)
        np.testing.assert_allclose(c.ls_alpha, cj.ls_alpha, rtol=0,
                                   atol=1e-4)
        np.testing.assert_allclose(c.ls_beta, cj.ls_beta, rtol=0, atol=1e-4)
    for w in range(3):
        o1, o = one.repaint(cps1[w]), sh.repaint(cps[w])
        assert torch.equal(o1.topology, o.topology)
        assert torch.equal(o1.logscale, o.logscale)
        for f in ("idx", "seqk", "pfac", "nxt", "kmask"):
            assert torch.equal(getattr(o1.plan, f), getattr(o.plan, f)), f
        assert np.array_equal(o1.plan.D, o.plan.D)
        assert np.array_equal(o1.ls_base, o.ls_base)
        oj = jp.repaint(cpsj[w])
        D = np.asarray(oj.plan.D)
        assert np.array_equal(o.plan.D, D)
        topo_j = np.asarray(oj.topology)
        ls_j = np.asarray(oj.logscale)
        for b in range(N):
            np.testing.assert_allclose(o.topology[:D[b], b].numpy(),
                                       topo_j[:D[b], b], rtol=1e-6,
                                       atol=1e-30)
            np.testing.assert_allclose(o.logscale[:D[b], b].numpy(),
                                       ls_j[:D[b], b], rtol=0, atol=1e-4)
    # a subset of the targets
    t = np.array([1, 4, 7, 9, 11], dtype=np.int32)
    assert torch.equal(one.repaint(cps1[1], t).topology,
                       sh.repaint(cps[1], t).topology)


@needs_8
def test_sharded_paint_fn_matches_kernel_and_jax():
    """``make_sharded_paint_fn``: the forward sweep with the targets cut
    over 8 shards equals one call of the forward sweep on the whole batch,
    and the JAX package's sharded forward pass (its scan) on the valid
    rows at the tolerances above."""
    G, r = _panel(5, 16, 64)
    L, N = G.shape
    model = tpainting.PaintingModel(N=N, theta=0.001)
    plan = tpainting.build_target_plan(G, r, model, 0, L - 1)
    alpha0 = tpainting.initial_alpha(G, model, 0, plan.targets)
    args = (G, plan.idx, plan.seqk, plan.pfac, plan.nxt, plan.D,
            plan.kmask, alpha0)
    a, ls = tmesh.make_sharded_paint_fn(cpu_mesh(8), model)(*args)
    mism = tpainting.mismatch_rows(torch.from_numpy(G),
                                   torch.from_numpy(plan.idx),
                                   torch.from_numpy(plan.seqk))
    a1, ls1 = pk.fwd(torch.from_numpy(plan.D), torch.from_numpy(alpha0),
                     torch.from_numpy(plan.kmask), mism,
                     torch.from_numpy(plan.pfac), torch.from_numpy(plan.nxt),
                     theta=model.theta)
    assert torch.equal(a, a1) and torch.equal(ls, ls1)
    jmodel = jpainting.PaintingModel(N=N, theta=0.001)
    ja, jls = jmesh.make_sharded_paint_fn(jmesh.default_mesh(8), jmodel)(
        *(jnp.asarray(x) for x in args))
    ja, jls = np.asarray(ja), np.asarray(jls)
    for b in range(N):
        D = int(plan.D[b])
        np.testing.assert_allclose(a[:D, b].numpy(), ja[:D, b], rtol=1e-4,
                                   atol=1e-30)
        np.testing.assert_allclose(ls[:D, b].numpy(), jls[:D, b], rtol=0,
                                   atol=1e-3)


def _mcmc_trees(B=5, N=10, L=64):
    """The trees of tests/test_mesh.py::test_sharded_mcmc_matches_unsharded,
    in both packages."""
    rng = np.random.default_rng(0)
    jtrees = []
    for b in range(B):
        d = rng.random((N, N)).astype(np.float32)
        t = jquick_build(d, theta=0.01, seed=b)
        t.num_events[:] = rng.poisson(1.0, t.num_nodes)
        t.SNP_begin[:] = 0
        t.SNP_end[:] = L - 1
        jtrees.append(t)
    ttrees = [convert.tree_from_numpy(
        t.parent, t.child_left, t.child_right, t.branch_length, t.num_events,
        t.SNP_begin, t.SNP_end) for t in jtrees]
    return jtrees, ttrees


@needs_8
def test_sharded_mcmc_matches_one_device_and_jax():
    """B = 5 chains with a mesh of 8 shards (the batch on the first): the
    branch lengths of one device at rtol 1e-5, atol 1e-3 (here exactly);
    the rounds and the stage record are the batch's. Against the JAX
    package's sharded chains, which draw other random numbers: finite,
    >= 0, and the total tree length in distribution (the bounds of
    test_torch_mcmc_posterior.py: median tree within 25 %, worst within
    90 %)."""
    jtrees, ttrees = _mcmc_trees()
    L = 64
    dist = np.ones(L)
    one = tmcmc.run_mcmc(ttrees, dist, L, seed=11, max_rounds=3,
                         device="cpu")
    with trace.stage("chains", verbose=False):
        sh = tmcmc.run_mcmc(ttrees, dist, L, seed=11, max_rounds=3,
                            mesh=cpu_mesh(8))
    np.testing.assert_allclose(sh, one, rtol=1e-5, atol=1e-3)
    assert np.array_equal(sh, one)
    (rec,) = trace.STAGES[-1]["mcmc"]
    assert rec["chains"] == 5 and rec["nodes"] == 19
    # a batch above the cap runs in parts
    parts = tmcmc.run_mcmc(ttrees, dist, L, seed=11, max_rounds=3,
                           max_batch=2, mesh=cpu_mesh(3))
    assert np.array_equal(parts, tmcmc.run_mcmc(
        ttrees, dist, L, seed=11, max_rounds=3, max_batch=2, device="cpu"))
    want = jmcmc.run_mcmc(jtrees, dist, L, seed=11, max_rounds=3,
                          mesh=jmesh.default_mesh(8))
    assert want.shape == sh.shape and np.isfinite(sh).all()
    assert (sh >= 0).all() and (sh[:, -1] == 0).all()
    rel = np.abs(sh.sum(axis=1) - want.sum(axis=1)) / want.sum(axis=1)
    assert np.median(rel) < 0.25, rel
    assert rel.max() < 0.9, rel


def _inputs(tmp_path, N=12, L=200):
    """A panel that plans as one chunk of four windows at MEMORY_GB."""
    G, bp = synth.synth_coalescent_panel(N, L, seed=5)[:2]
    prefix = str(tmp_path / "panel")
    synth.write_haps_sample(G, bp, prefix)
    synth.write_flat_map(prefix + ".map", int(bp[-1]))
    return prefix + ".haps", prefix + ".sample", prefix + ".map"


MEMORY_GB = 1.1e-5


@pytest.fixture(scope="module")
def one_device(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    args = _inputs(tmp)
    out = trelate.run_all(*args, str(tmp / "one"), seed=1,
                          memory_gb=MEMORY_GB, verbose=False, device="cpu",
                          cleanup=False)
    return args, out


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_run_all_on_a_mesh_writes_the_bytes_of_one_device(one_device,
                                                          tmp_path, shards):
    """Four sections on 2 (two each), 3 (two, one, one) and 8 shards (four
    idle), the chains in a pool of one process a shard: the .anc/.mut and
    every section's artifacts equal the one-device run's, the stages
    record one topology and one chain batch a section, and no worker
    outlives the run."""
    from relate_tpu_torch.io.chunking import ArtifactStore
    args, one = one_device
    del trace.STAGES[:]
    out = trelate.run_all(*args, str(tmp_path / "mesh"), seed=1,
                          memory_gb=MEMORY_GB, verbose=False,
                          mesh=cpu_mesh(shards), cleanup=False)
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(one + ext, out + ext, shallow=False), ext
    s1, s2 = ArtifactStore(one + ".tmpdir"), ArtifactStore(out + ".tmpdir")
    W = s1.load_chunk(0).windows.num_windows
    assert W == 4
    for w in range(W):
        for f in (f"trees_{w}.anc", f"muts_{w}.mut", f"paint_{w}.npz"):
            if f.endswith(".npz"):
                a, b = np.load(s1.path("chunk_0", f)), \
                    np.load(s2.path("chunk_0", f))
                assert all(np.array_equal(a[k], b[k]) for k in a.files), f
            else:
                assert filecmp.cmp(s1.path("chunk_0", f),
                                   s2.path("chunk_0", f), shallow=False), f
    (rec,) = [r for r in trace.STAGES
              if r["stage"] == "chunk0.infer_branch_lengths"]
    assert len(rec["mcmc"]) == W
    assert len(rec["pool_start_s"]) == shards
    (rec,) = [r for r in trace.STAGES
              if r["stage"] == "chunk0.build_topology"]
    assert len(rec["topology"]) == W
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("shards", [2, 3])
def test_run_all_on_a_mesh_with_chunks_at_a_time(tmp_path, monkeypatch,
                                                 shards):
    """``threads=2`` with a mesh: two chunks at a time, each with the
    cards' threads of its own on the same shards. The .anc/.mut equal
    those of one device and one chunk at a time, byte for byte. The chunk
    overlap constants are shrunk so that a 600-SNP panel plans as several
    chunks, as in ``test_torch_pipeline.py::test_run_all_threads_identical``.
    """
    from relate_tpu_torch.io import chunking as tchunking
    monkeypatch.setattr(tchunking, "OVERLAP", 60)
    monkeypatch.setattr(tchunking, "MERGE_DISCARD", 30)
    monkeypatch.setattr(trelate, "MERGE_DISCARD", 30)
    monkeypatch.setattr(tchunking, "MAX_WINDOWS_PER_CHUNK", 4)
    G, bp = synth.synth_panel(8, 600, seed=11)
    prefix = str(tmp_path / "p")
    synth.write_haps_sample(G, bp, prefix)
    synth.write_flat_map(prefix + ".map", int(bp[-1]))
    mem = 1e-5
    plan, _ = tchunking.plan_chunks_and_windows(G, mem)
    assert plan.num_chunks > 2
    args = (prefix + ".haps", prefix + ".sample", prefix + ".map")
    one = trelate.run_all(*args, str(tmp_path / "one"), seed=1,
                          verbose=False, memory_gb=mem, device="cpu")
    out = trelate.run_all(*args, str(tmp_path / "mesh"), seed=1,
                          verbose=False, memory_gb=mem, threads=2,
                          mesh=cpu_mesh(shards))
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(one + ext, out + ext, shallow=False), ext


@needs_8
def test_run_all_on_a_mesh_writes_the_bytes_of_the_jax_mesh(
        tmp_path, monkeypatch):
    """``run_all`` on 8 shards in both packages (the JAX package's merge
    scan in interpret mode, its tie-break seeds injected into the port),
    with the chains of both replaced by one function of the tree (in the
    port's pool workers through their task): the whole .anc and .mut byte
    for byte."""
    from test_torch_pipeline import jax_merge_seeds
    from torch_standins import fixed_lengths, fixed_section_lengths
    args = _inputs(tmp_path)
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")
    monkeypatch.setattr(jtd, "_pallas_available", lambda n: True)
    # the painter's scan (the merge scan stays the Pallas kernel)
    monkeypatch.setattr(jpainting.Painter, "_use_pallas", lambda self: False)
    monkeypatch.setattr(jrelate.mcmc, "run_mcmc", fixed_lengths)
    monkeypatch.setattr(trelate, "section_branch_lengths",
                        fixed_section_lengths)
    cached = set(jtd._KERNEL_CACHE)
    try:
        jrelate.run_all(*args, str(tmp_path / "jax"), seed=1,
                        memory_gb=MEMORY_GB, verbose=False,
                        mesh=jmesh.default_mesh(8))
    finally:
        # the cache's key does not hold the environment switch
        for k in set(jtd._KERNEL_CACHE) - cached:
            del jtd._KERNEL_CACHE[k]
    monkeypatch.setattr(ttd, "default_merge_seeds", jax_merge_seeds)
    out = trelate.run_all(*args, str(tmp_path / "port"), seed=1,
                          memory_gb=MEMORY_GB, verbose=False,
                          mesh=cpu_mesh(8))
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(str(tmp_path / "jax") + ext, out + ext,
                           shallow=False), ext


def test_default_mesh_raises_and_never_shrinks(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.default_mesh() == (torch.device("cuda", 0),
                                    torch.device("cuda", 1))
    assert tmesh.default_mesh(1) == (torch.device("cuda", 0),)
    for n in (3, 8, 0):
        with pytest.raises(RuntimeError, match=f"requested a {n}-card mesh "
                                               "but only 2 CUDA"):
            tmesh.default_mesh(n)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="only 0 CUDA"):
        tmesh.default_mesh()


def test_mesh_names_each_card_once():
    with pytest.raises(ValueError, match="appears twice"):
        tmesh.Mesh(["cuda:0", "cuda:1", "cuda:0"])
    with pytest.raises(ValueError, match="appears twice"):
        tmesh.Mesh([torch.device("cuda", 1), "cuda:1"])
    with pytest.raises(ValueError, match="index"):
        tmesh.Mesh(["cuda"])
    with pytest.raises(ValueError, match="not both"):
        tmesh.Mesh(["cuda:0", "cpu"])
    with pytest.raises(ValueError, match="at least one"):
        tmesh.Mesh([])
    assert len(tmesh.Mesh(["cpu"] * 3)) == 3
    assert tmesh.Mesh(["cuda:1", "cuda:0"]).first == torch.device("cuda", 1)
    assert tmesh.blocks(12, 8) == [(0, 2), (2, 4), (4, 6), (6, 8), (8, 10),
                                   (10, 12)]
    assert tmesh.blocks(5, 2) == [(0, 3), (3, 5)] and tmesh.blocks(0, 4) == []
    # a device beside a mesh may only name its first device
    with pytest.raises(ValueError, match="first device"):
        trelate.paint(None, 0, device="cpu",
                      mesh=["cuda:0", "cuda:1"])


def test_launch_counts_and_the_batch_vote_from_many_threads():
    """The wrappers' launch counters are shared by the cards' threads: 16
    threads (more than this host's cores) with a short switch interval lose
    no count. (The chains' vote between the blocks of a batch went with the
    batch cut over cards; the name is kept.)"""
    import sys
    import threading
    from concurrent.futures import ThreadPoolExecutor
    from relate_tpu_torch.ops import _build
    counts = {"k": 0}
    n_threads, per = 16, 2000

    def work(t):
        for i in range(per):
            _build.count_launch(counts, "k", f"cuda:{t % 4}")

    old = sys.getswitchinterval()
    saved = {k: dict(v) for k, v in _build.launches_by_card.items()}
    _build.launches_by_card.pop("k", None)
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=n_threads) as pool:
            futs = [pool.submit(work, t) for t in range(n_threads)]
            for f in futs:
                f.result(timeout=60)
    finally:
        sys.setswitchinterval(old)
        by_card = _build.launches_by_card.pop("k", {})
        _build.launches_by_card.update(saved)
    assert counts["k"] == n_threads * per
    assert by_card == {f"cuda:{c}": 4 * per for c in range(4)}
    assert threading.active_count() < 50
