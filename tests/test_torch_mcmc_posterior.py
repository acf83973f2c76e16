"""The port's branch-length MCMC against the JAX package's, where the two
draw their own random numbers: (c) posterior mean ages with the thresholds
of ``tests/test_mcmc_sweep.py``; (d) ``run_mcmc`` of both on the same
trees. The exact comparisons under shared uniforms are in
``test_torch_mcmc.py``, whose helpers this file uses."""
import numpy as np
import jax
import pytest
import torch

from relate_tpu.core import mcmc as jm
from relate_tpu_torch import convert
from relate_tpu_torch.core import mcmc as tm
from relate_tpu_torch.utils import trace
from test_torch_mcmc import (AGES, L, M, N, NE, _chain_setup,
                             _initial_state, _static_across, _tree_batch)

torch.set_num_threads(1)


def _jax_means(st, cl, cr, use_vp, seed, snapshots, iters_per):
    s = jm.init_chain_state(*_initial_state(cl, cr, 100 + seed))
    blk = jm._Block(N, M, use_vp)
    key = jax.random.PRNGKey(seed)
    s = blk.run(st, s, key, 400, False)
    for k in range(snapshots):
        s = blk.run(st, s, jax.random.fold_in(key, k + 1), iters_per, True)
    return (np.asarray(s.ssum, np.float64)
            / np.asarray(s.count, np.float64)[:, None])


@pytest.mark.parametrize("use_vp", [False, True],
                         ids=["constNe", "piecewise"])
def test_posterior_means_match_jax(use_vp):
    """Posterior mean node ages of the port's chains (its own generator)
    against the JAX package's, on the tree batch and with the thresholds of
    tests/test_mcmc_sweep.py (mean relative difference < 0.09, q99 < 0.35:
    about twice the seed-to-seed spread measured there at 6,000 iterations
    of both sweeps; a wrong acceptance ratio shifts means by far more). The
    budgets are those of that test's "both" run."""
    trees = _tree_batch(48)
    st, cl, cr = _chain_setup(trees, use_vp)
    want = _jax_means(st, cl, cr, use_vp, seed=3, snapshots=100,
                      iters_per=60)
    tst = _static_across(st)
    s = tm.init_chain_state(*_initial_state(cl, cr, 55), device="cpu")
    draws = tm.Draws(9, "cpu")
    s = tm.run(tst, s, draws, 400, use_vp, False)
    s = tm.run(tst, s, draws, 6000, use_vp, True)
    got = (s.ssum.double() / s.count.double()[:, None]).numpy()
    a0, a1 = want[:, N:], got[:, N:]
    rel = np.abs(a1 - a0) / np.maximum(a0, 1e-3)
    assert rel.mean() < 0.09, rel.mean()
    assert np.quantile(rel, 0.99) < 0.35, np.quantile(rel, 0.99)


@pytest.mark.parametrize("use_vp", [False, True],
                         ids=["constNe", "piecewise"])
def test_run_mcmc_agrees_with_jax(use_vp):
    """``run_mcmc`` of both packages on the same trees: branch lengths
    finite and >= 0, and the total tree length within Monte-Carlo noise.
    Both stop at the convergence gate (>= 50 proposals a node), so a
    tree's total is a mean over a short chain. Measured on these trees, the
    port under four seeds against the JAX package: the median tree differs
    by 5-13 %, the worst of 16 by 35-49 %. The bounds are about twice that:
    25 % for the median tree, 90 % for the worst."""
    jtrees = _tree_batch(16, seed=8)
    ttrees = [convert.tree_from_numpy(
        t.parent, t.child_left, t.child_right, t.branch_length, t.num_events,
        t.SNP_begin, t.SNP_end) for t in jtrees]
    dist = np.full(L + 1, 400.0)
    kw = dict(Ne=3e4, mu=1.25e-8, seed=5)
    if use_vp:
        kw.update(epochs=np.array([0.0, 0.25, 1.0]),
                  rates=np.array([1.5, 0.7, 1.2]))
    want = jm.run_mcmc(jtrees, dist, L + 1, **kw)
    with trace.stage("chains", verbose=False):
        got = tm.run_mcmc(ttrees, dist, L + 1, device="cpu", **kw)
    stats = trace.STAGES[-1]["mcmc"]
    assert got.shape == want.shape == (16, M) and got.dtype == np.float64
    assert np.isfinite(got).all() and (got >= 0).all()
    assert (got[:, M - 1] == 0).all() and (got[:, :M - 1] > 0).mean() > 0.95
    assert stats == [dict(chains=16, nodes=M, rounds=stats[0]["rounds"],
                          converged=16, device="cpu",
                          wall_s=stats[0]["wall_s"])]
    rel = np.abs(got.sum(axis=1) - want.sum(axis=1)) / want.sum(axis=1)
    assert np.median(rel) < 0.25, np.median(rel)
    assert rel.max() < 0.9, rel.max()
    # the same seed gives the same chains; a batch above the cap runs in
    # parts with their own seeds
    again = tm.run_mcmc(ttrees, dist, L + 1, device="cpu", **kw)
    assert np.array_equal(got, again)
    parts = tm.run_mcmc(ttrees[:6], dist, L + 1, device="cpu", max_batch=4,
                         **kw)
    assert parts.shape == (6, M) and not np.array_equal(parts, got[:6])


def _across(jtrees):
    return [convert.tree_from_numpy(
        t.parent, t.child_left, t.child_right, t.branch_length, t.num_events,
        t.SNP_begin, t.SNP_end) for t in jtrees]


def _implied_ages(tree, bl, ages):
    """Node ages from the sample ages and the branch lengths, taken up from
    the left child, and the largest disagreement with the right child's."""
    Mt = len(tree.parent)
    age = np.zeros(Mt)
    age[:N] = ages
    worst = 0.0
    for v in range(N, Mt):        # merge order: children before parents
        a, b = int(tree.child_left[v]), int(tree.child_right[v])
        age[v] = age[a] + bl[a]
        worst = max(worst, abs(age[v] - (age[b] + bl[b])) / age[v])
    return age, worst


def test_run_mcmc_with_sample_ages_agrees_with_jax():
    """``run_mcmc`` with the ancient samples of tests/test_ancient.py on
    trees built with them: the chains keep the tips at their ages (the node
    ages implied from either child agree, every ancient tip's parent is
    older than the tip), and the total tree length agrees with the JAX
    package's within Monte-Carlo noise. Measured on these trees, the port
    under four seeds against the JAX package: the median tree differs by
    8-13 %, the worst of 16 by 22-35 % (the JAX package against itself: 7 %
    and 31 %); the bounds are those of the contemporary test above."""
    jtrees = _tree_batch(16, seed=8, sample_ages=AGES)
    ttrees = _across(jtrees)
    dist = np.full(L + 1, 400.0)
    kw = dict(Ne=NE, mu=1.25e-8, seed=5, sample_ages=AGES)
    want = jm.run_mcmc(jtrees, dist, L + 1, **kw)
    got = tm.run_mcmc(ttrees, dist, L + 1, device="cpu", **kw)
    assert got.shape == (16, M) and np.isfinite(got).all()
    assert (got >= 0).all() and (got[:, M - 1] == 0).all()
    for tree, bl in zip(ttrees, got):
        age, worst = _implied_ages(tree, bl, AGES)
        assert worst < 1e-4, worst
        par = tree.parent[:N]
        assert (age[par] > AGES).all()
    rel = np.abs(got.sum(axis=1) - want.sum(axis=1)) / want.sum(axis=1)
    assert np.median(rel) < 0.25, np.median(rel)
    assert rel.max() < 0.9, rel.max()


def test_run_mcmc_in_parts_keeps_the_sample_ages():
    """A batch above ``max_batch`` runs in parts, and every part gets the
    sample ages: the implied node ages agree from both children in every
    part (a part that dropped the ages would start its ancient tips at 0)."""
    ttrees = _across(_tree_batch(5, seed=4, sample_ages=AGES))
    got = tm.run_mcmc(ttrees, np.full(L + 1, 400.0), L + 1, Ne=NE, seed=2,
                      sample_ages=AGES, max_batch=2, device="cpu")
    assert got.shape == (5, M)
    for tree, bl in zip(ttrees, got):
        assert _implied_ages(tree, bl, AGES)[1] < 1e-4


def test_unported_priors_raise_and_cap_is_a_memory_bound():
    trees = [convert.tree_from_numpy(t.parent, t.child_left, t.child_right)
             for t in _tree_batch(2)]
    dist = np.ones(L + 1)
    # the pairwise-group prior runs (``test_torch_mcmc_pair.py``)
    bl = tm.run_mcmc(trees, dist, L + 1, device="cpu",
                     group_R=np.ones((1, 2, 2)), memberships=np.arange(N) % 2,
                     epochs=np.zeros(1), max_rounds=3)
    assert bl.shape == (2, M) and np.isfinite(bl).all() and (bl >= 0).all()
    # ancient samples run (``test_run_mcmc_with_sample_ages_agrees_with_jax``)
    bl = tm.run_mcmc(trees, dist, L + 1, device="cpu",
                     sample_ages=np.full(N, 10.0), max_rounds=3)
    assert bl.shape == (2, M) and np.isfinite(bl).all()
    assert tm.chain_batch_cap(4095) == jm.chain_batch_cap(4095) == 256
    assert tm.chain_batch_cap(511) == jm.chain_batch_cap(511) == 4096
    assert tm.proposals_per_iteration(N, M) == jm._Block(N, M, False).ppi
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.run_mcmc(trees, dist, L + 1)
