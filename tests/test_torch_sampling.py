"""The port's branch-length sampling and the .timeb format
(``evaluate/sampling.py``) against the JAX package's.

The .timeb writer sorts a tree's internal node ages once a sample and takes
each record's sets as pre-order ranges of its branch's subtree, where the
JAX writer builds a leaf matrix and sorts a record at a time: both must
write the same bytes. The chains of ``sample_branch_lengths`` draw their own
random numbers, so the samples of the two packages agree in distribution.
"""
import filecmp

import numpy as np
import pytest
import torch

from relate_tpu.core import treebuilder as jtb
from relate_tpu.core.topology import MutationRecord as JRecord
from relate_tpu.core.trees import AncesTree as JAnc
from relate_tpu.core.trees import MarginalTree as JMT
from relate_tpu.evaluate import sampling as js
from relate_tpu_torch import convert
from relate_tpu_torch.core import mcmc as tm
from relate_tpu_torch.core import treebuilder as ttb
from relate_tpu_torch.core.topology import MutationRecord
from relate_tpu_torch.core.trees import AncesTree, MarginalTree
from relate_tpu_torch.evaluate import sampling as ts
from relate_tpu_torch.pipeline import scripts as tscripts
from test_torch_mcmc import L, M, N, _tree_batch

torch.set_num_threads(1)


def test_read_reference_timeb(golden_dir):
    """The reference binary's own .timeb (first 200 records of
    RelateCoalescentRate --mode SampleBranchLengths --format b on the golden
    example): the twin of tests/test_timeb.py::test_read_reference_timeb,
    and the same records as the JAX reader."""
    path = str(golden_dir / "sbl_head.timeb")
    recs = ts.read_timeb(path)
    assert len(recs) == 200
    for r in recs:
        assert r["N"] == 8
        assert 0 <= r["daf"] <= 8
        assert r["anctimes"].shape == (3, max(0, 8 - r["daf"] - 1))
        assert r["dertimes"].shape == (3, max(0, r["daf"] - 1))
        for arr in (r["anctimes"], r["dertimes"]):
            if arr.size:
                assert (np.diff(arr, axis=1) >= 0).all()
    bps = [r["bp"] for r in recs]
    assert bps == sorted(bps)
    for a, b in zip(recs, js.read_timeb(path)):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k]), k


def test_timeb_round_trip(tmp_path):
    """write_timeb -> read_timeb with the reference layout on a tree of the
    port's ``quick_build``: the twin of tests/test_timeb.py::
    test_timeb_round_trip."""
    rng = np.random.default_rng(0)
    n = 8
    d = rng.random((n, n)).astype(np.float32)
    tree = ttb.quick_build(d, theta=0.01, device="cpu")
    tree.branch_length[:] = rng.random(tree.num_nodes) * 100
    anc = AncesTree(N=n, seq=[MarginalTree(pos=0, tree=tree)])
    S = 4
    samples = np.abs(rng.random((S, 1, tree.num_nodes))) * 50
    muts = [MutationRecord(tree=0, branch=[int(tree.child_left[n])]),
            MutationRecord(tree=0, branch=[]),
            MutationRecord(tree=0, branch=[2 * n - 2])]
    path = str(tmp_path / "x.timeb")
    ts.write_timeb(path, anc, samples, muts=muts, bp=np.array([100, 200, 300]),
                   alleles=["A/T", "C/G", "G/A"])
    recs = ts.read_timeb(path)
    assert len(recs) == 3
    assert [r["bp"] for r in recs] == [100, 200, 300]
    assert [r["anc_allele"] for r in recs] == ["A", "C", "G"]
    assert recs[1]["daf"] == 0 and recs[1]["anctimes"].shape == (S, n - 1)
    assert recs[2]["daf"] == n and recs[2]["dertimes"].shape == (S, n - 1)
    b = muts[0].branch[0]
    daf = int(tree.leaf_matrix()[b].sum())
    assert recs[0]["daf"] == daf
    assert recs[0]["anctimes"].shape == (S, n - daf - 1)


def _both_ancs(jtrees, ages=None):
    janc = JAnc(N=jtrees[0].N, seq=[JMT(pos=i, tree=t)
                                    for i, t in enumerate(jtrees)],
                sample_ages=ages)
    tanc = AncesTree(N=jtrees[0].N, seq=[MarginalTree(
        pos=i, tree=convert.tree_from_numpy(
            t.parent, t.child_left, t.child_right, t.branch_length,
            t.num_events, t.SNP_begin, t.SNP_end))
        for i, t in enumerate(jtrees)], sample_ages=ages)
    return janc, tanc


@pytest.mark.parametrize("ages", [None, "ancient"])
def test_timeb_and_newick_bytes_equal_jax(tmp_path, ages):
    """Records on leaves, inner branches, the root and none, several trees,
    with and without sample ages, and the legacy call without records: the
    same bytes as the JAX writer; newick samples likewise."""
    rng = np.random.default_rng(3)
    sa = None if ages is None else np.r_[np.zeros(N - 3), 40.0, 90.0, 300.0]
    jtrees = [jtb.quick_build(d + d.T, theta=0.001, seed=s, sample_ages=sa)
              for s, d in enumerate(rng.random((5, N, N)).astype(np.float32))]
    janc, tanc = _both_ancs(jtrees, sa)
    S = 3
    samples = rng.random((S, 5, M)) * 200
    branches = [[v] for v in range(M)] + [[], [3, 9]]
    jm_, tm_ = [], []
    for i in range(60):
        t = i % 5
        br = branches[rng.integers(len(branches))]
        jm_.append(JRecord(tree=t, branch=list(br)))
        tm_.append(MutationRecord(tree=t, branch=list(br)))
    order = np.argsort([m.tree for m in jm_], kind="stable")
    jm_, tm_ = [jm_[i] for i in order], [tm_[i] for i in order]
    bp = np.arange(60) * 17 + 5
    alleles = ["A/T", "C/", "/G", "", "T/C"] * 12
    for name, kw in (("recs", dict(bp=bp, alleles=alleles)), ("legacy", {})):
        tw, jw = str(tmp_path / f"t_{name}"), str(tmp_path / f"j_{name}")
        ts.write_timeb(tw, tanc, samples, muts=tm_ if kw else None, **kw)
        js.write_timeb(jw, janc, samples, muts=jm_ if kw else None, **kw)
        assert filecmp.cmp(tw, jw, shallow=False), name
    assert len(ts.read_timeb(tw)) == 5
    ts.write_newick_samples(str(tmp_path / "t.nwk"), tanc, samples, 2)
    js.write_newick_samples(str(tmp_path / "j.nwk"), janc, samples, 2)
    assert filecmp.cmp(tmp_path / "t.nwk", tmp_path / "j.nwk", shallow=False)


def _sampling_inputs():
    jtrees = _tree_batch(16, seed=8)
    janc, tanc = _both_ancs(jtrees)
    muts = [MutationRecord(tree=0) for _ in range(L + 1)]
    epochs = np.array([0.0, 0.25, 1.0]) * 3e4
    rates = np.array([1.5, 0.7, 1.2]) / 3e4
    return janc, tanc, muts, np.full(L + 1, 400.0), epochs, rates


def test_sample_branch_lengths_agrees_with_jax():
    """The mean over 20 samples of each tree's total length: the port's
    against the JAX package's, within the bounds of
    test_torch_mcmc_posterior.py (25 % for the median tree, 90 % for the
    worst; measured against the JAX package's seed 5: the port under seeds
    5-8 1.7-3.5 % and 7.6-11 %, the JAX package under seeds 6-7 2.4-3.2 %
    and 7.1-8.2 %); finite lengths >= 0, 0 at the root, and every sample
    its own draw."""
    janc, tanc, muts, dist, epochs, rates = _sampling_inputs()
    kw = dict(num_samples=20, num_proposals=1000, seed=5)
    want = js.sample_branch_lengths(janc, muts, dist, 1.25e-8, epochs, rates,
                                    **kw)
    got = ts.sample_branch_lengths(tanc, muts, dist, 1.25e-8, epochs, rates,
                                   device="cpu", **kw)
    assert got.shape == want.shape == (20, 16, M)
    assert np.isfinite(got).all() and (got >= 0).all()
    assert (got[:, :, M - 1] == 0).all()
    assert all(not np.array_equal(got[s], got[s + 1]) for s in range(19))
    g, w = got.sum(axis=2).mean(axis=0), want.sum(axis=2).mean(axis=0)
    rel = np.abs(g - w) / w
    assert np.median(rel) < 0.25, rel
    assert rel.max() < 0.9, rel


def test_sample_branch_lengths_in_parts(monkeypatch):
    """Above ``chain_batch_cap`` the trees run in parts with the seeds
    ``seed + 7 * (s + 1)``, as in the JAX module."""
    janc, tanc, muts, dist, epochs, rates = _sampling_inputs()
    kw = dict(num_samples=2, num_proposals=200)
    monkeypatch.setattr(tm, "chain_batch_cap", lambda M_: 6)
    got = ts.sample_branch_lengths(tanc, muts, dist, 1.25e-8, epochs, rates,
                                   seed=3, device="cpu", **kw)
    assert got.shape == (2, 16, M)
    for s in (0, 6, 12):
        sub = AncesTree(N=N, seq=tanc.seq[s: s + 6])
        part = ts.sample_branch_lengths(sub, muts, dist, 1.25e-8, epochs,
                                        rates, seed=3 + 7 * (s + 1),
                                        device="cpu", **kw)
        assert np.array_equal(got[:, s: s + 6], part)


def test_reestimate_and_prior_normalisation_equal_jax(monkeypatch):
    """``reestimate_branch_lengths`` hands the chains the same normalised
    prior as the JAX module (rates times, epochs over the average Ne; the
    pair matrix times it, unknown rates 0) and writes their lengths into
    the trees."""
    janc, tanc, muts, dist, epochs, rates = _sampling_inputs()
    rates = np.r_[rates[:2], np.nan]
    gr = np.stack([np.diag([r, 2 * r]) for r in rates])
    gr[2, 0, 1] = np.inf
    for a, b in zip(ts._normalized_prior(epochs, rates),
                    js._normalized_prior(epochs, rates)):
        assert np.array_equal(a, b)
    seen = {}

    def fake(name):
        def run_mcmc(trees, d, L_, **kw):
            seen[name] = kw
            return [np.full(t.num_nodes, float(i)) for i, t in
                    enumerate(trees)]
        return run_mcmc
    monkeypatch.setattr(js.mcmc, "run_mcmc", fake("jax"))
    monkeypatch.setattr(tm, "run_mcmc", fake("port"))
    memb = np.arange(N) % 2
    js.reestimate_branch_lengths(janc, muts, dist, 1e-8, epochs, rates,
                                 seed=4, group_rates=gr, memberships=memb)
    ts.reestimate_branch_lengths(tanc, muts, dist, 1e-8, epochs, rates,
                                 seed=4, group_rates=gr, memberships=memb,
                                 device="cpu")
    port = dict(seen["port"])
    assert port.pop("device") == "cpu"
    assert port.pop("pool") is None
    assert port.keys() == seen["jax"].keys()
    for k, v in port.items():
        assert np.array_equal(v, seen["jax"][k]), k
    assert tanc.seq[3].tree.branch_length[0] == 3.0


def test_scripts_need_a_card_unless_asked_for_the_cpu(golden_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    prefix = str(golden_dir / "golden")
    with pytest.raises(RuntimeError, match="CUDA"):
        tscripts.sample_branch_lengths(prefix, prefix, prefix + ".coal")
    with pytest.raises(RuntimeError, match="CUDA"):
        tscripts.reestimate_branch_lengths(prefix, prefix, prefix + ".coal")
    with pytest.raises(RuntimeError, match="CUDA"):
        tscripts.estimate_population_size(prefix, prefix)
    janc, tanc, muts, dist, epochs, rates = _sampling_inputs()
    with pytest.raises(RuntimeError, match="CUDA"):
        ts.sample_branch_lengths(tanc, muts, dist, 1e-8, epochs, rates)
