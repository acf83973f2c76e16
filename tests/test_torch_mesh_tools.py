"""The CoalescentRate tool on a mesh: ``coalescence_stats(mesh=)``,
``sample_branch_lengths(mesh=)``, ``estimate_popsize_em(mesh=)``, the
functions of ``pipeline/scripts.py`` and ``tools_cli --devices``, against
one device and against the JAX package's mesh.

On this host the port's meshes are repeated ``"cpu"`` entries (2, 3 and 8
shards), the JAX package's its 8 virtual CPU devices (``tests/conftest.py``);
the trees are the reference's final ``golden.anc/.mut`` (N = 8).
The port's tools run the statistics of a mesh on its first device and
give the chain parts of a mesh of several devices (two parts or more) to a
pool of one spawned process a device (``parallel.pool.CardPool``; here a
``"cpu"`` worker each, which runs one thread as this process does), so the
statistics, the draws, the EM's rates and the files equal one device's
exactly, whatever the batches and parts; one part, or one device, starts
no process. Against the JAX package's mesh path, which sums each shard in
float32, the statistics agree at the tolerance of ``test_torch_coalrate.py``
for its float32 path (rtol 1e-5, atol 1e-3). Where the tools call
``sample_branch_lengths`` with the reference's default budget of
proposals a sample (10,000 at N = 8, about 10 s a call on this host), the
tests give it 300 (``fewer_proposals``, which sets it in this process: the
part's budget goes to the workers in its arguments): the chains are real,
only shorter.
"""
import filecmp
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from relate_tpu.evaluate import coalrate as jc
from relate_tpu.parallel import mesh as jmesh
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.core import mcmc as tmcmc
from relate_tpu_torch.core.trees import AncesTree
from relate_tpu_torch.evaluate import coalrate as tc
from relate_tpu_torch.evaluate import sampling as ts
from relate_tpu_torch.io import extract
from relate_tpu_torch.parallel import mesh as tmesh
from relate_tpu_torch.pipeline import scripts as tscripts
from relate_tpu_torch.pipeline import tools_cli as tcli
from relate_tpu_torch.utils import trace
from torch_standins import recording_pools

torch.set_num_threads(1)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="the JAX side needs 8 jax devices")

SNPS = 1200


def cpu_mesh(n):
    return tmesh.Mesh(["cpu"] * n)


@pytest.fixture(scope="module")
def pairs(golden_dir):
    prefix = str(golden_dir / "golden")
    return tscripts._load_pair(prefix), jscripts._load_pair(prefix)


@pytest.fixture(scope="module")
def inputs(golden_dir, tmp_path_factory):
    """``in``: the first 1,200 SNPs of the golden .anc/.mut, and a
    .poplabels of two groups of two individuals."""
    d = tmp_path_factory.mktemp("mesh_tools_in")
    anc, recs, bp, dist, rsid, alleles = tscripts._load_pair(
        str(golden_dir / "golden"))
    a, r, (lo, hi) = extract.anc_mut_for_subregion(anc, recs, bp, bp[0],
                                                   bp[SNPS - 1])
    sl = slice(lo, hi + 1)
    tscripts._dump_pair(str(d / "in"), a, r, bp[sl], dist[sl], rsid[sl],
                        alleles[sl])
    (d / "p.poplabels").write_text(
        "sample population group sex\n"
        "i0 P0 EUR 1\ni1 P1 AFR 2\ni2 P0 EUR NA\ni3 P1 AFR 1\n")
    return d


@pytest.fixture
def fewer_proposals(monkeypatch):
    """``sampling.sample_branch_lengths`` with 300 proposals a sample
    unless its caller names a budget."""
    real = ts.sample_branch_lengths

    def shorter(*a, **kw):
        kw.setdefault("num_proposals", 300)
        return real(*a, **kw)
    monkeypatch.setattr(ts, "sample_branch_lengths", shorter)


def _stats_inputs(pairs, T):
    (anc, recs, bp, dist), (janc, jrecs) = pairs[0][:4], pairs[1][:2]
    spans = tc.tree_spans(anc, recs, dist)[:T].copy()
    spans[min(5, T - 1)] = 0.0                # a tree with factor 0
    return ([mt.tree for mt in anc.seq[:T]],
            [mt.tree for mt in janc.seq[:T]], spans)


@pytest.mark.parametrize("shards,T,batch,groups,batches", [
    (3, 300, 64, "two", 5),                   # more batches than cards
    (8, 40, 16, "two", 3),                    # fewer batches than cards
    (8, 3, 1, "hap", 2),                      # fewer trees than cards
    (2, 100, 16, "hap", 7),
    (2, 100, None, "two", 1),                 # one batch
], ids=["3x300", "8x40", "8x3_hap", "2x100_hap", "2x100_one_batch"])
def test_coalescence_stats_on_a_mesh_equals_one_device(
        pairs, tmp_path, shards, T, batch, groups, batches):
    trees, _, spans = _stats_inputs(pairs, T)
    N = trees[0].N
    grp = (np.arange(N) if groups == "hap"
           else np.array([0, 1, 0, 1, 1, 0, 0, 1]))
    epochs = tc.default_epochs()
    one = tc.coalescence_stats(trees, spans, epochs, grp, batch=batch,
                               device="cpu")
    with trace.stage("stats", verbose=False):
        got = tc.coalescence_stats(trees, spans, epochs, grp, batch=batch,
                                   mesh=cpu_mesh(shards))
    (note,) = trace.STAGES[-1]["coal_stats"]
    assert (note["batches"], note["device"]) == (batches, "cpu")
    assert np.array_equal(got[0], one[0]) and np.array_equal(got[1], one[1])
    assert got[1].sum() > 0
    names = [str(g) for g in range(int(grp.max()) + 1)]
    for name, (c, o) in (("one", one), ("mesh", got)):
        tc.write_coal(str(tmp_path / f"{name}.coal"), epochs,
                      tc.finalize_rates(c, o), names)
    assert filecmp.cmp(tmp_path / "one.coal", tmp_path / "mesh.coal",
                       shallow=False)


@needs_8
@pytest.mark.parametrize("T,groups", [(300, "two"), (5, "hap")],
                         ids=["300_trees", "5_trees_hap"])
def test_coalescence_stats_on_a_mesh_matches_the_jax_mesh(pairs, T, groups):
    """8 shards on both sides; the JAX package's psum path sums each shard
    in float32 (rtol 1e-5, atol 1e-3)."""
    trees, jtrees, spans = _stats_inputs(pairs, T)
    N = trees[0].N
    grp = np.arange(N) if groups == "hap" else np.arange(N) % 2
    epochs = tc.default_epochs()
    got = tc.coalescence_stats(trees, spans, epochs, grp, batch=T // 8 + 1,
                               mesh=cpu_mesh(8))
    want = jc.coalescence_stats(jtrees, spans, epochs, grp,
                                mesh=jmesh.default_mesh(8))
    for g, w in zip(got, want):
        assert g.shape == w.shape == (len(epochs), grp.max() + 1,
                                      grp.max() + 1)
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-3)
    assert got[0].sum() > 0


def _sampling_inputs(pairs, T):
    anc, recs, bp, dist = pairs[0][:4]
    sub = AncesTree(N=anc.N, seq=anc.seq[:T], sample_ages=anc.sample_ages)
    epochs = np.array([0.0, 0.25, 1.0]) * 3e4
    rates = np.array([1.5, 0.7, 1.2]) / 3e4
    return sub, recs, dist, epochs, rates


def _no_children():
    for p in multiprocessing.active_children():
        p.join(5.0)
    return not multiprocessing.active_children()


def _worker_pids(pools, shards):
    """The pids of the one pool made, of ``shards`` workers, which served
    every ``map``; none of them is this process."""
    assert [len(p.mesh) for p in pools] == [shards]
    pids = {m[1] for m in pools[0].maps}
    assert len(pids) == 1
    (pids,) = pids
    assert len(set(pids)) == shards and os.getpid() not in pids
    return pids


@pytest.mark.parametrize("shards,T,cap,parts", [
    (3, 16, 6, 3),        # 16 trees do not divide 3 shards: 6, 6, 4
    (2, 16, 5, 4),        # more parts than cards: 5, 5, 5, 1
    (8, 10, 4, 3),        # fewer parts than cards
    (2, 10, None, 1),     # one part
], ids=["3x16", "2x16", "8x10", "2x10_one_part"])
def test_sample_branch_lengths_on_a_mesh_equals_one_device(
        pairs, monkeypatch, shards, T, cap, parts):
    """The parts on a pool of the mesh (one process a shard), the draws
    one device's; one part runs here and starts no process."""
    anc, recs, dist, epochs, rates = _sampling_inputs(pairs, T)
    if cap is not None:
        monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: cap)
    kw = dict(num_samples=2, num_proposals=300, seed=4)
    one = ts.sample_branch_lengths(anc, recs, dist, 1.25e-8, epochs, rates,
                                   device="cpu", **kw)
    pools = recording_pools(monkeypatch, ts)
    with trace.stage("sample", verbose=False):
        got = ts.sample_branch_lengths(anc, recs, dist, 1.25e-8, epochs,
                                       rates, mesh=cpu_mesh(shards), **kw)
    assert got.shape == one.shape == (2, T, 2 * anc.N - 1)
    assert np.abs(got - one).max() == 0.0
    notes = trace.STAGES[-1]["mcmc"]
    assert [m["device"] for m in notes] == ["cpu"] * parts
    assert sum(m["chains"] for m in notes) == T
    if parts > 1:
        _worker_pids(pools, shards)
        assert [m[0] for m in pools[0].maps] == [parts]
    else:
        assert pools == []
    assert _no_children()


def test_estimate_popsize_em_on_a_mesh_equals_one_device(
        pairs, monkeypatch, fewer_proposals):
    """Two iterations, the chains in two parts on one pool of three
    workers, two groups at the end: equal rates and draws."""
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 8)
    pools = recording_pools(monkeypatch, tc, ts)
    out = {}
    for name, kw in (("one", dict(device="cpu")),
                     ("mesh", dict(mesh=cpu_mesh(3)))):
        anc, recs, dist = _sampling_inputs(pairs, 12)[:3]
        anc = AncesTree(N=anc.N, seq=[type(mt)(pos=mt.pos, tree=mt.tree.copy())
                                      for mt in anc.seq])
        res = tc.estimate_popsize_em(anc, recs, dist, num_iter=2, seed=3,
                                     group_of_hap=np.arange(anc.N) % 2, **kw)
        out[name] = res + (np.stack([mt.tree.branch_length
                                     for mt in anc.seq]),)
    for a, b in zip(out["one"], out["mesh"]):
        assert np.array_equal(a, b, equal_nan=True)
    assert np.isfinite(out["one"][2]).all() and out["one"][2].max() > 0
    _worker_pids(pools, 3)
    assert [m[0] for m in pools[0].maps] == [2, 2]
    assert _no_children()


def test_estimate_population_size_script_on_a_mesh(inputs, tmp_path,
                                                   monkeypatch,
                                                   fewer_proposals):
    """``scripts.estimate_population_size(mesh=)`` with two groups: the
    files of one device, byte for byte; one pool of three workers for the
    EM's draws (108 trees after the filter: 3 parts) and the final
    re-estimate (164 trees: 4 parts)."""
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 48)
    pools = recording_pools(monkeypatch, tscripts, tc, ts)
    for name, kw in (("one", dict(device="cpu")),
                     ("mesh", dict(mesh=cpu_mesh(3)))):
        tscripts.estimate_population_size(
            str(inputs / "in"), str(tmp_path / name),
            poplabels_path=str(inputs / "p.poplabels"), num_iter=1,
            verbose=False, **kw)
    for ext in (".coal", ".pairwise.coal", ".anc", ".mut"):
        assert filecmp.cmp(tmp_path / f"one{ext}", tmp_path / f"mesh{ext}",
                           shallow=False), ext
    _worker_pids(pools, 3)
    assert [m[0] for m in pools[0].maps] == [3, 4]
    assert _no_children()


def test_tools_cli_devices_on_a_cpu_mesh(inputs, tmp_path, monkeypatch,
                                         fewer_proposals):
    """``--devices N`` for EstimatePopulationSize (two groups and
    ``--poplabels hap``), EstimatePopulationSizeEM and SampleBranchLengths,
    the first N cards stood in for by N host shards: the files of
    ``--device cpu``, the chain parts of the last two on a pool of N
    workers (EstimatePopulationSize starts none). Without the stand-in it
    raises on a host with fewer cards (one, mocked); it does not go with
    ``--device`` nor with another tool or mode."""
    i, pl = str(inputs / "in"), str(inputs / "p.poplabels")
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="2-card mesh"):
            tcli.main(["CoalescentRate", "--mode", "EstimatePopulationSize",
                       "-i", i, "-o", str(tmp_path / "x"), "--devices", "2"])
    with pytest.raises(SystemExit, match="--device"):
        tcli.main(["CoalescentRate", "--mode", "EstimatePopulationSize",
                   "-i", i, "-o", str(tmp_path / "x"), "--devices", "2",
                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="not MutationRate --mode Avg"):
        tcli.main(["MutationRate", "--mode", "Avg", "-i", i, "-o",
                   str(tmp_path / "x"), "--devices", "2"])
    assert not list(tmp_path.iterdir())

    made = []
    monkeypatch.setattr(tmesh, "default_mesh",
                        lambda n: made.append(n) or cpu_mesh(n))
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 48)
    pools = recording_pools(monkeypatch, tscripts, tc, ts)
    coal = str(tmp_path / "one_eps.coal")
    for out, mode, args, files, jobs in (
            ("eps", "EstimatePopulationSize", ["--poplabels", pl],
             [".coal", ".pairwise.coal"], None),
            ("hap", "EstimatePopulationSize", ["--poplabels", "hap"],
             [".coal", ".pairwise.coal"], None),
            ("em", "EstimatePopulationSizeEM",
             ["--poplabels", pl, "--num_iter", "1"],
             [".coal", ".pairwise.coal", ".anc", ".mut"], [3, 4]),
            ("sbl", "SampleBranchLengths",
             ["--coal", coal, "--format", "timeb", "--num_samples", "2"],
             [".timeb"], [4])):
        del pools[:]
        for name, dev in (("one", ["--device", "cpu"]),
                          ("mesh", ["--devices", "3"])):
            assert tcli.main(["CoalescentRate", "--mode", mode, "-i", i,
                              "-o", str(tmp_path / f"{name}_{out}")]
                             + args + dev) == 0
        for ext in files:
            assert filecmp.cmp(tmp_path / f"one_{out}{ext}",
                               tmp_path / f"mesh_{out}{ext}",
                               shallow=False), (mode, ext)
        if jobs is None:
            assert pools == []
        else:
            _worker_pids(pools, 3)
            assert [m[0] for m in pools[0].maps] == jobs, mode
        assert _no_children()
    assert made == [3, 3, 3, 3]
