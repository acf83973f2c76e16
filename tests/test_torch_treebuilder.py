"""The port's tree builder (``relate_tpu_torch/core/treebuilder.py``) against
the JAX package's, on ``device="cpu"``.

Tolerances: the clade prior, the same-rpos penalty and UPGMA are bit-exact
(the same float32 / float64 operations in the same order); merge lists are
exact. The JAX ``quick_build`` breaks ties with threefry draws, the port
with the kernels' hash of (min, max, seed, step), so the two are compared:

- as they are, where every step has one best candidate (random float
  matrices, no clade prior: every score is distinct), on the routes of all
  three merge-scan kernels (B5, B6, B7; the port's routes forced at small N
  by lowering its size limits);
- with the JAX module's XLA scan replaced, inside the test only, by the JAX
  package's own Pallas merge scan in interpret mode, which has the port's
  hash and takes the drawn int seed (``PRNGKey(s)`` is ``[0, s]``): with a
  clade prior, whose zero scores tie;
- with sample ages (the age channel, which the Pallas scan lacks): with
  ``jax.random`` inside ``_quick_build_scan`` replaced by the port's hash
  (``port_ties``), exactly, ties included; and as they are where a check
  shows that each step had one best candidate.
"""
import contextlib
import types

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relate_tpu.core import distance as jdistance
from relate_tpu.core import treebuilder as jtb
from relate_tpu.ops import merge_scan as jms
from relate_tpu_torch.core import treebuilder as ttb
from relate_tpu_torch.ops import merge_scan as tms

torch.set_num_threads(1)

THETA = 0.001
ROUTES = ["B5", "B6", "B7"]


class _HashRandom:
    """``jax.random`` as ``_quick_build_scan`` calls it, drawing the port's
    tie hash of (min, max, seed, step) in place of threefry."""

    @staticmethod
    def fold_in(key, t):
        return key[1], t                     # PRNGKey(s) == [0, s]

    @staticmethod
    def uniform(seed_t, shape):
        seed, t = seed_t
        u = jnp.uint32
        ids = jnp.arange(shape[0], dtype=u)
        lo = jnp.minimum(ids[:, None], ids[None, :])
        hi = jnp.maximum(ids[:, None], ids[None, :])
        h = lo * u(2654435769) + hi * u(2246822507)
        h = h ^ (seed.astype(u) * u(747796405) + t.astype(u) * u(374761393))
        h = h ^ (h >> 15)
        h = h * u(739213477)
        h = h ^ (h >> 12)
        return (h & u(0x7FFFFF)).astype(jnp.float32)


def _fixed_ties(tie_of_pair):
    """A ``jax.random`` stand-in whose draw is a fixed function of the
    pair: ``tie_of_pair(flat index matrix)``."""
    class R:
        @staticmethod
        def fold_in(key, t):
            return key

        @staticmethod
        def uniform(key, shape):
            n = shape[0]
            return tie_of_pair(jnp.arange(n * n, dtype=jnp.float32)
                               .reshape(n, n))
    return R


@contextlib.contextmanager
def jax_scan_with(random):
    """Run ``relate_tpu.core.treebuilder``'s scan with ``random`` in place of
    ``jax.random``: a new function object of the scan's code, whose globals
    name the stand-in, so that no trace of it is shared with the module's
    own function (JAX caches traces by function)."""
    f = jtb._quick_build_scan.__wrapped__
    g = types.FunctionType(
        f.__code__, dict(f.__globals__, jax=types.SimpleNamespace(
            random=random, lax=jax.lax)), f.__name__, f.__defaults__,
        f.__closure__)
    mp = pytest.MonkeyPatch()
    mp.setattr(jtb, "_quick_build_scan",
               jax.jit(g, static_argnames=("use_cf", "use_ages")))
    try:
        yield
    finally:
        mp.undo()


def port_ties():
    return jax_scan_with(_HashRandom)


def _pallas_scan(d0, dcf0, key, thr, thr_cf, ages, grid, use_cf, use_ages):
    assert not use_ages
    cis, cjs, _ = jms.merge_scan_pallas(d0, dcf0, use_cf, thr, thr_cf,
                                        jnp.asarray(key[1], jnp.int32),
                                        interpret=True)
    return cis, cjs


@contextlib.contextmanager
def pallas_scan(route="B5"):
    """The JAX module's XLA scan replaced by the JAX package's Pallas merge
    scan in interpret mode, on the kernel ``route``; the port's route forced
    to the same kernel. A fresh jit of nothing: the Pallas scan is called
    where the XLA scan was."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtb, "_quick_build_scan", _pallas_scan)
    if route == "B6":
        mp.setenv("RELATE_TPU_MERGE_LARGE", "1")
        mp.setattr(tms, "MAX_N_SMALL", 2)
    elif route == "B7":
        mp.setenv("RELATE_TPU_MERGE_INC", "1")
        mp.setattr(tms, "MAX_N_SMALL", 2)
        mp.setattr(tms, "MAX_N_LARGE", 2)
    try:
        yield
    finally:
        mp.undo()


@contextlib.contextmanager
def port_route(route):
    mp = pytest.MonkeyPatch()
    if route in ("B6", "B7"):
        mp.setattr(tms, "MAX_N_SMALL", 2)
    if route == "B7":
        mp.setattr(tms, "MAX_N_LARGE", 2)
    try:
        yield
    finally:
        mp.undo()


def _same_tree(a, b):
    return (np.array_equal(a.parent, b.parent)
            and np.array_equal(a.child_left, b.child_left)
            and np.array_equal(a.child_right, b.child_right))


def _jax_tree(N, seed):
    rng = np.random.default_rng(seed)
    return jtb.quick_build(rng.random((N, N)).astype(np.float32),
                           theta=THETA, seed=seed)


def _port_tree(jt):
    return ttb.tree_from_merges(jt.child_left[jt.N:], jt.child_right[jt.N:],
                                jt.N)


def _ancient_ages(N, n_old, rng):
    ages = np.zeros(N)
    ages[N - n_old:] = np.sort(rng.choice([500.0, 2000.0, 3500.0, 9000.0],
                                          n_old))
    return ages


# ---------------------------------------------------------------------------
# the priors and UPGMA: bit-exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N,seed", [(8, 1), (33, 2), (48, 3)])
def test_clade_prior_matrix_is_bit_exact(N, seed):
    jt = _jax_tree(N, seed)
    want = jtb.clade_prior_matrix(jt, THETA)
    got = ttb.clade_prior_matrix(_port_tree(jt), THETA, device="cpu")
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("N,seed", [(9, 4), (40, 5)])
def test_same_rpos_penalty_is_bit_exact(N, seed):
    rng = np.random.default_rng(seed)
    d = rng.random((N, N)).astype(np.float32) * 7
    sets = [np.nonzero(rng.random(N) < 0.3)[0], [], [0, N - 1],
            np.nonzero(rng.random(N) < 0.5)[0]]
    want = jtb.same_rpos_penalty(d, sets, THETA)
    got = ttb.same_rpos_penalty(torch.from_numpy(d), sets, THETA)
    assert np.array_equal(got.numpy(), want)
    assert not np.array_equal(want, d)


@pytest.mark.parametrize("N,seed", [(2, 6), (13, 7), (31, 8)])
def test_upgma_is_bit_exact(N, seed):
    d = np.random.default_rng(seed).random((N, N))
    a, b = jtb.upgma(d), ttb.upgma(d)
    assert _same_tree(a, b)
    assert np.array_equal(a.branch_length, b.branch_length)


# ---------------------------------------------------------------------------
# quick_build without ages: the three merge-scan routes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("N,seed", [(17, 11), (48, 12)])
def test_quick_build_tie_free_matches_jax(route, N, seed):
    """Random float matrices: every score d[i,j] + d[j,i] is distinct, so
    each step has one best candidate and the tie rule never decides."""
    d = np.random.default_rng(seed).random((N, N)).astype(np.float32)
    want = jtb.quick_build(d, theta=THETA, seed=seed)
    with port_route(route):
        got = ttb.quick_build(d, theta=THETA, seed=seed, device="cpu")
    assert _same_tree(want, got)


@pytest.mark.parametrize("route", ROUTES)
def test_quick_build_with_clade_prior_matches_pallas_scan(route):
    """With the previous tree's clade prior, whose mutual pairs all score 0
    and tie: held against the JAX quick_build on its Pallas scan."""
    N = 24
    rng = np.random.default_rng(21)
    prev = _jax_tree(N, 22)
    d_cf = jtb.clade_prior_matrix(prev, THETA)
    for seed in (3, 4):
        d = rng.random((N, N)).astype(np.float32) * 5
        with pallas_scan(route):
            want = jtb.quick_build(d, d_cf=d_cf, theta=THETA, seed=seed)
            got = ttb.quick_build(d, d_cf=torch.from_numpy(d_cf),
                                  theta=THETA, seed=seed, device="cpu")
        assert _same_tree(want, got), (route, seed)


# ---------------------------------------------------------------------------
# quick_build with sample ages
# ---------------------------------------------------------------------------

def test_age_grid():
    """The first bound is the first coalescence of the youngest class,
    2 / (n (n - 1)) Ne, and the bound only grows. (That it is the grid the
    JAX module builds inside its quick_build shows in the age-aware merge
    lists below.)"""
    ages = np.array([0, 0, 0, 500, 500, 2000, 3500, 0.0])
    g = ttb.age_grid(ages, 3e4)
    assert g.shape == (7,) and g.dtype == np.float64
    assert np.all(np.diff(g) > 0)
    # four contemporary lineages first: 2 / (4 * 3) * Ne
    assert g[0] == pytest.approx(2.0 / 12.0 * 3e4)


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["random", "quantized"])
@pytest.mark.parametrize("use_cf", [False, True], ids=["plain", "clade_prior"])
@pytest.mark.parametrize("N,n_old,seed", [(12, 4, 7), (31, 9, 8), (48, 16, 9)])
def test_quick_build_ages_matches_jax_under_the_port_ties(N, n_old, seed,
                                                          use_cf, quantized):
    """The JAX age-aware scan with the port's tie hash in place of threefry
    gives the port's merge lists exactly. With a clade prior (zero scores)
    or a matrix of a few distinct values (as identical haplotypes give),
    some step has several best pairs, which the check below shows: the JAX
    scan's lists then depend on whether its draw prefers the smallest or the
    largest pair index."""
    rng = np.random.default_rng(seed)
    ages = _ancient_ages(N, n_old, rng)
    d = rng.integers(0, 3, (N, N)).astype(np.float32) if quantized \
        else rng.random((N, N)).astype(np.float32)
    d_cf = jtb.clade_prior_matrix(_jax_tree(N, seed + 1), THETA) \
        if use_cf else None
    if use_cf or quantized:
        ends = []
        for tie in (lambda f: f, lambda f: -f):
            with jax_scan_with(_fixed_ties(tie)):
                ends.append(jtb.quick_build(d, d_cf=d_cf, theta=THETA,
                                            seed=1, sample_ages=ages))
        assert not _same_tree(*ends)
    for s in (1, 2):
        with port_ties():
            want = jtb.quick_build(d, d_cf=d_cf, theta=THETA, seed=s,
                                   sample_ages=ages, Ne=3e4)
        got = ttb.quick_build(d, d_cf=d_cf, theta=THETA, seed=s,
                              sample_ages=ages, Ne=3e4, device="cpu")
        assert _same_tree(want, got), s


@pytest.mark.parametrize("N,seed", [(12, 7), (20, 31)])
def test_quick_build_ages_matches_jax_where_each_step_has_one_best(N, seed):
    """Where each step has one best candidate, the tie rule never decides
    and the port equals the JAX quick_build as it is (threefry). Shown
    first: the JAX scan gives the same lists when its draw prefers the
    smallest and when it prefers the largest pair index, which it could
    not if some step had two best pairs."""
    rng = np.random.default_rng(seed)
    ages = np.zeros(N)
    ages[N - 2:] = [500.0, 800.0]
    d = rng.random((N, N)).astype(np.float32)
    trees = []
    for tie in (lambda f: f, lambda f: -f):
        with jax_scan_with(_fixed_ties(tie)):
            trees.append(jtb.quick_build(d, theta=THETA, seed=1,
                                         sample_ages=ages))
    assert _same_tree(*trees)
    want = jtb.quick_build(d, theta=THETA, seed=5, sample_ages=ages)
    got = ttb.quick_build(d, theta=THETA, seed=5, sample_ages=ages,
                          device="cpu")
    assert _same_tree(want, got) and _same_tree(want, trees[0])


@pytest.fixture
def ancient_setup():
    """The fixture of tests/test_ancient.py, built by the port."""
    rng = np.random.default_rng(7)
    N = 12
    ages = np.zeros(N)
    ages[8:] = [500.0, 500.0, 2000.0, 3500.0]      # 4 ancient tips
    d = rng.random((N, N)).astype(np.float32)
    tree = ttb.quick_build(d, theta=0.01, seed=3, sample_ages=ages, Ne=3e4,
                           device="cpu")
    return N, ages, tree


def test_quick_build_ages_properties(ancient_setup):
    """tests/test_ancient.py's properties of a tree built with sample ages:
    every ancient tip's parent sits above the tip's age; and the ancient
    tips merge late (the age bound bars them from the first merges)."""
    N, ages, tree = ancient_setup
    coords = tree.coordinates(ages)
    for i in range(N):
        assert coords[int(tree.parent[i])] >= ages[i] - 1e-6
    grid = ttb.age_grid(ages, 3e4)
    # the merge step of every tip; a tip older than the bound at a step is
    # merged at it only if no younger pair was mutual there
    step = {int(c): t for t, (a, b) in enumerate(
        zip(tree.child_left[N:], tree.child_right[N:])) for c in (a, b)}
    old = [i for i in range(N) if ages[i] > grid[0]]
    assert old and min(step[i] for i in old) > 0


# ---------------------------------------------------------------------------
# the fused rebuild
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,ancestral_state", [
    (1, True), (1, False), (0, False)])
def test_fused_rebuild_matches_jax(mode, ancestral_state):
    """``make_fused_rebuild`` of both packages on one random posterior
    (carried across as numpy), the JAX one on its Pallas scan: equal merge
    lists, for each seed."""
    N, Dmax = 20, 6
    rng = np.random.default_rng(40 + mode)
    topology = rng.random((Dmax, N, N)).astype(np.float32) + 1e-3
    logscale = (rng.random((Dmax, N)) * 4 - 2).astype(np.float32)
    rows = rng.integers(0, Dmax, N).astype(np.int64)
    is_exact = rng.random(N) < 0.5
    wl = rng.random(N).astype(np.float32)
    wr = (1 - wl).astype(np.float32)
    kcol = np.arange(N, dtype=np.int64)
    carriers = (rng.random(N) < 0.3).astype(np.uint8)
    leafmat = _jax_tree(N, 43).leaf_matrix()
    jfn = jtb.make_fused_rebuild(THETA, N, mode, ancestral_state)
    tfn = ttb.make_fused_rebuild(THETA, N, mode, ancestral_state)
    t = torch.from_numpy
    for seed in (5, 6):
        with pallas_scan():
            cj = jfn(jnp.asarray(topology), jnp.asarray(logscale),
                     jnp.asarray(rows.astype(np.int32)),
                     jnp.asarray(is_exact), jnp.asarray(wl), jnp.asarray(wr),
                     jnp.asarray(kcol.astype(np.int32)),
                     jnp.asarray(carriers), jnp.asarray(leafmat),
                     jax.random.PRNGKey(seed))
        ct = tfn(t(topology), t(logscale), t(rows), t(is_exact), t(wl),
                 t(wr), t(kcol), t(carriers), t(leafmat), seed)
        for a, b in zip(cj, ct):
            assert np.array_equal(np.asarray(a), b.numpy()), seed
    # the symmetrised matrix is what the scan saw without an ancestral state
    mat = jdistance._assemble_ops(
        jnp.asarray(topology), jnp.asarray(logscale), jnp.asarray(rows),
        jnp.asarray(is_exact), jnp.asarray(wl), jnp.asarray(wr),
        jnp.asarray(kcol))
    assert not np.array_equal(np.asarray(mat), np.asarray(mat).T)
