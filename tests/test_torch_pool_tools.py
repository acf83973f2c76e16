"""The CoalescentRate tool's chain parts on the port's pool of one process a
card (``relate_tpu_torch/parallel/pool.py``): ``sample_branch_lengths
(pool=)``, the EM's one pool, the population-size script's final
re-estimate, a part that fails in its worker, and the pooled draws against
the JAX package's mesh.

On this host a pool's workers are ``"cpu"`` entries, one spawned process
each (at most 3 a pool: each imports torch), which run one thread as this
process does. Tolerances: through a pool the draws, the rates and the files
are one device's byte for byte; against the JAX package, whose chains draw
other random numbers, the draws agree in distribution at the bounds of
``test_torch_sampling.py::test_sample_branch_lengths_agrees_with_jax``.
"""
import filecmp
import multiprocessing
import os

import jax
import numpy as np
import pytest
import torch

from relate_tpu.evaluate import sampling as js
from relate_tpu.parallel import mesh as jmesh
from relate_tpu_torch.core import mcmc as tmcmc
from relate_tpu_torch.core.trees import AncesTree
from relate_tpu_torch.evaluate import coalrate as tc
from relate_tpu_torch.evaluate import sampling as ts
from relate_tpu_torch.parallel import mesh as tmesh
from relate_tpu_torch.parallel.pool import CardPool
from relate_tpu_torch.pipeline import scripts as tscripts
from relate_tpu_torch.pipeline import tools_cli as tcli
from relate_tpu_torch.utils import trace
from test_torch_mesh_tools import (_sampling_inputs, cpu_mesh,  # noqa: F401
                                   fewer_proposals, inputs, pairs)
from test_torch_sampling import _sampling_inputs as _jax_inputs
from torch_standins import part_failing_in_a_worker, recording_pools

torch.set_num_threads(1)

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="the JAX side needs 8 jax devices")


def _no_children():
    for p in multiprocessing.active_children():
        p.join(5.0)
    return not multiprocessing.active_children()


def test_sample_branch_lengths_on_a_given_pool(pairs, monkeypatch):
    """Three parts (6, 6, 4 trees) on a given pool of three workers, twice
    with other seeds: the draws of ``device="cpu"`` bit for bit, each part
    noted once, the pool's workers the same for both calls."""
    anc, recs, dist, epochs, rates = _sampling_inputs(pairs, 16)
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 6)
    kw = dict(num_samples=2, num_proposals=300)
    with CardPool(["cpu"] * 3, timeout_s=300) as pool:
        pids = set(pool.map(os.getpid, [()] * 6))
        for seed in (2, 9):
            one = ts.sample_branch_lengths(anc, recs, dist, 1.25e-8, epochs,
                                           rates, seed=seed, device="cpu",
                                           **kw)
            with trace.stage("sample", verbose=False):
                got = ts.sample_branch_lengths(anc, recs, dist, 1.25e-8,
                                               epochs, rates, seed=seed,
                                               pool=pool, **kw)
            assert got.dtype == one.dtype == np.float64
            assert np.array_equal(got, one)
            notes = trace.STAGES[-1]["mcmc"]
            assert [m["chains"] for m in notes] == [6, 6, 4]
            assert {m["device"] for m in notes} == {"cpu"}
        assert set(pool.map(os.getpid, [()] * 6)) == pids
        assert len(pids) == 3 and os.getpid() not in pids
    assert _no_children()


def test_the_em_starts_its_workers_once(pairs, monkeypatch, fewer_proposals):
    """``estimate_popsize_em(mesh=)`` over two iterations with its draws in
    two parts: one pool of the mesh's two workers, whose processes serve
    both iterations, and the rates and last draw of one device."""
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 7)
    pools = recording_pools(monkeypatch, tc, ts)
    out = {}
    for name, kw in (("one", dict(device="cpu")),
                     ("mesh", dict(mesh=cpu_mesh(2)))):
        anc, recs, dist = _sampling_inputs(pairs, 12)[:3]
        anc = AncesTree(N=anc.N, seq=[type(mt)(pos=mt.pos, tree=mt.tree.copy())
                                      for mt in anc.seq])
        res = tc.estimate_popsize_em(anc, recs, dist, num_iter=2, seed=6,
                                     **kw)
        out[name] = res + (np.stack([mt.tree.branch_length
                                     for mt in anc.seq]),)
    for a, b in zip(out["one"], out["mesh"]):
        assert np.array_equal(a, b, equal_nan=True)
    assert len(pools) == 1 and len(pools[0].mesh) == 2
    (first_jobs, first_pids), (second_jobs, second_pids) = pools[0].maps
    assert first_jobs == second_jobs == 2
    assert first_pids == second_pids and len(set(first_pids)) == 2
    assert os.getpid() not in first_pids
    assert _no_children()


def test_the_script_reestimates_in_parts_on_the_pool(inputs, tmp_path,
                                                     monkeypatch,
                                                     fewer_proposals):
    """``scripts.estimate_population_size(mesh=)`` on two workers writes
    one device's ``.coal``/``.pairwise.coal``/``.anc``/``.mut``; the final
    re-estimate of the 164 unfiltered trees runs in three parts of at most
    64 on the EM's pool (its notes, outside the EM's iterations)."""
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 64)
    pools = recording_pools(monkeypatch, tscripts, tc, ts)
    for name, kw in (("one", dict(device="cpu")),
                     ("mesh", dict(mesh=cpu_mesh(2)))):
        with trace.stage(f"script_{name}", verbose=False):
            tscripts.estimate_population_size(
                str(inputs / "in"), str(tmp_path / name),
                poplabels_path=str(inputs / "p.poplabels"), num_iter=1,
                verbose=False, **kw)
        final = trace.STAGES[-1]["mcmc"]
        assert [m["chains"] for m in final] == [64, 64, 36], name
    for ext in (".coal", ".pairwise.coal", ".anc", ".mut"):
        assert filecmp.cmp(tmp_path / f"one{ext}", tmp_path / f"mesh{ext}",
                           shallow=False), ext
    assert len(pools) == 1 and len(pools[0].mesh) == 2
    assert [m[0] for m in pools[0].maps] == [2, 3]
    assert len({m[1] for m in pools[0].maps}) == 1
    assert _no_children()


def test_a_failing_part_raises_from_the_tool(inputs, tmp_path, monkeypatch,
                                             fewer_proposals):
    """SampleBranchLengths ``--devices 2`` whose parts fail in their
    workers: the tool raises with the worker's traceback, writes nothing,
    runs no part in this process (where the stand-in would pass) and
    leaves no process behind."""
    monkeypatch.setattr(tmesh, "default_mesh", cpu_mesh)
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 64)
    monkeypatch.setattr(ts, "sample_part", part_failing_in_a_worker)
    i = str(inputs / "in")
    coal = str(tmp_path / "prior")
    assert tcli.main(["CoalescentRate", "--mode", "EstimatePopulationSize",
                      "-i", i, "-o", coal, "--device", "cpu"]) == 0
    with trace.stage("failing", verbose=False):
        with pytest.raises(RuntimeError, match="failed on cpu") as err:
            tcli.main(["CoalescentRate", "--mode", "SampleBranchLengths",
                       "-i", i, "-o", str(tmp_path / "sbl"), "--coal",
                       coal + ".coal", "--format", "timeb", "--num_samples",
                       "2", "--devices", "2"])
    msg = str(err.value)
    assert "Traceback (most recent call last)" in msg
    assert "the chains of this part failed in their worker" in msg
    assert "mcmc" not in trace.STAGES[-1]
    assert not (tmp_path / "sbl.timeb").exists()
    assert _no_children()


@needs_8
def test_pooled_draws_agree_with_the_jax_mesh(monkeypatch):
    """The port's draws in three parts on a pool of three workers against
    the JAX package's ``sample_branch_lengths(mesh=default_mesh(8))``: the
    mean over 20 samples of each tree's total length within 25 % for the
    median tree and 90 % for the worst (the bounds of
    ``test_torch_sampling.py``); finite lengths >= 0, 0 at the root."""
    janc, tanc, muts, dist, epochs, rates = _jax_inputs()
    kw = dict(num_samples=20, num_proposals=1000, seed=5)
    want = js.sample_branch_lengths(janc, muts, dist, 1.25e-8, epochs, rates,
                                    mesh=jmesh.default_mesh(8), **kw)
    monkeypatch.setattr(tmcmc, "chain_batch_cap", lambda M: 6)
    with CardPool(["cpu"] * 3, timeout_s=300) as pool:
        with trace.stage("sample", verbose=False):
            got = ts.sample_branch_lengths(tanc, muts, dist, 1.25e-8, epochs,
                                           rates, pool=pool, **kw)
    assert [m["chains"] for m in trace.STAGES[-1]["mcmc"]] == [6, 6, 4]
    M = got.shape[2]
    assert got.shape == want.shape == (20, 16, M)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert (got[:, :, M - 1] == 0).all()
    g, w = got.sum(axis=2).mean(axis=0), want.sum(axis=2).mean(axis=0)
    rel = np.abs(g - w) / w
    assert np.median(rel) < 0.25, rel
    assert rel.max() < 0.9, rel
    assert _no_children()
