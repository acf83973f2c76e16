"""The port's branch-length MCMC against the JAX package's.

(a) Exact arithmetic: from one chain state carried across by ``convert``,
one age sweep per phase, one order sweep per phase, one step of each kind
and 20 whole iterations, each fed the SAME uniforms as the JAX function
(reproduced from its key splits). Integer state must be equal; float state
agrees at rtol 1e-5 / atol 1e-7 (float32, the same operations, but XLA
fuses and orders a few of them otherwise). The Kahan compensation ``scomp``
is the rounding residue of ``ssum`` and as such noise of the last bit: the
compensated sum ``ssum - scomp`` is what is compared.
(b) Invariants of the state after 200 iterations of the port's own draws.
The chains run with contemporary samples and with the ancient samples of
``tests/test_ancient.py`` (``use_ages``: the lineage profile follows the
sorted order; the start state is ``_pseudo_order`` / ``_initial_coords``,
which are bit-exact). The distributional comparison and ``run_mcmc`` are in
``test_torch_mcmc_posterior.py``.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from relate_tpu.core import mcmc as jm
from relate_tpu.core import treebuilder as jtb
from relate_tpu_torch import convert
from relate_tpu_torch.core import mcmc as tm

torch.set_num_threads(1)

N = 12
M = 2 * N - 1
L = 200
INT_FIELDS = ("order", "sorted_idx", "cprop")
# the ancient tips of tests/test_ancient.py, in generations; Ne = 3e4
AGES = np.array([0.0] * 8 + [500.0, 500.0, 2000.0, 3500.0])
NE = 3e4


def _tree_batch(B, seed=3, sample_ages=None):
    """The tree batch of tests/test_mcmc_sweep.py (built with
    ``sample_ages`` where given)."""
    rng = np.random.default_rng(seed)
    trees = []
    for _ in range(B):
        d = rng.random((N, N)).astype(np.float32)
        np.fill_diagonal(d, 1e9)
        t = jtb.quick_build(d + d.T, theta=0.001,
                            seed=int(rng.integers(1 << 30)),
                            sample_ages=sample_ages)
        t.num_events = rng.poisson(2.0, M).astype(np.float32)
        t.SNP_begin = np.zeros(M, np.int32)
        t.SNP_end = np.full(M, L, np.int32)
        trees.append(t)
    return trees


def _chain_setup(trees, use_vp):
    B = len(trees)
    dist = np.ones(L + 1)
    parent = np.stack([t.parent for t in trees])
    cl = np.stack([t.child_left for t in trees])
    cr = np.stack([t.child_right for t in trees])
    nl = np.concatenate([np.full(N, N), 2 * N - 1 - np.arange(N, 2 * N - 1)])
    if use_vp:
        epochs = np.asarray([0.0, 0.25, 1.0], np.float32)
        rt = np.broadcast_to(np.asarray([1.5, 0.7, 1.2], np.float32),
                             (B, 3)).astype(np.float32)
        cumR = np.zeros((B, 3), np.float32)
        cumR[:, 1:] = np.cumsum(rt[:, :2] * np.diff(epochs), axis=1)
    else:
        epochs = np.asarray([0.0], np.float32)
        rt = np.ones((B, 1), np.float32)
        cumR = np.zeros((B, 1), np.float32)
    st = jm.ChainStatic(
        parent=jnp.asarray(parent, jnp.int32),
        child_left=jnp.asarray(cl, jnp.int32),
        child_right=jnp.asarray(cr, jnp.int32),
        num_events=jnp.asarray(np.stack([t.num_events for t in trees])),
        mut_rate=jnp.asarray(
            jm.branch_mut_rates(trees, dist, L + 1, 3e4, 1.25e-8)),
        kc2_pos=jnp.asarray(nl * (nl - 1) / 2.0, jnp.float32),
        epochs=jnp.asarray(epochs), rates=jnp.asarray(rt),
        cumR=jnp.asarray(cumR),
        depth=jnp.asarray(jm.tree_depths(parent), jnp.int32))
    return st, cl, cr


def _initial_state(cl, cr, seed):
    rng = np.random.default_rng(seed)
    sidx0, order0 = jm._initial_orders_batch(cl, cr, N, rng)
    coords0 = jm._initial_coords_batch(sidx0, N).astype(np.float32)
    return coords0, order0, sidx0


def _ancient_state(trees):
    """The JAX package's start state with the ancient samples."""
    ages_n = AGES / NE
    out = [jm._pseudo_order(t, ages_n) for t in trees]
    sidx0 = np.stack([si for si, _ in out])
    order0 = np.stack([o for _, o in out])
    coords0 = np.stack([jm._initial_coords(si, N, ages_n)
                        for si in sidx0]).astype(np.float32)
    return coords0, order0, sidx0


def _static_across(st):
    a = np.asarray
    return convert.chain_static_from_numpy(
        a(st.parent), a(st.child_left), a(st.child_right), a(st.num_events),
        a(st.mut_rate), a(st.kc2_pos), a(st.epochs), a(st.rates), a(st.cumR),
        a(st.depth), device="cpu")


def _state_across(s):
    return convert.chain_state_from_numpy(*[np.asarray(x) for x in s],
                                          device="cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


def _assert_same_state(js, ts, what):
    for f in INT_FIELDS:
        assert np.array_equal(np.asarray(getattr(js, f)),
                              getattr(ts, f).numpy()), (what, f)
    for f in ("coords", "cs", "count"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.asarray(getattr(js, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f"{what}: {f}")
    np.testing.assert_allclose(
        (ts.ssum - ts.scomp).numpy(),
        np.asarray(js.ssum) - np.asarray(js.scomp), rtol=1e-5, atol=1e-7,
        err_msg=f"{what}: compensated sum")


@pytest.fixture(scope="module", params=[
    (False, False), (True, False), (False, True), (True, True)],
    ids=["constNe", "piecewise", "ancient", "ancient-piecewise"])
def chains(request):
    """A generic state: 40 iterations of the JAX chain from its initial
    state, then carried across."""
    use_vp, use_ages = request.param
    trees = _tree_batch(8, sample_ages=AGES if use_ages else None)
    st, cl, cr = _chain_setup(trees, use_vp)
    s = jm.init_chain_state(*(_ancient_state(trees) if use_ages
                              else _initial_state(cl, cr, 7)))
    blk = jm._Block(N, M, use_vp, use_ages=use_ages)
    s = blk.run(st, s, jax.random.PRNGKey(5), 40, True)
    tst = _static_across(st)
    return dict(use_vp=use_vp, use_ages=use_ages, st=st, s=s,
                aux=jm.sweep_aux(st), blk=blk, tst=tst, ts=_state_across(s),
                taux=tm.sweep_aux(tst))


@pytest.mark.parametrize("phase", range(4))
def test_age_sweep_matches_jax(chains, phase):
    c = chains
    B = c["ts"].coords.shape[0]
    r = np.random.default_rng(10 + phase)
    u1 = r.random((B, M)).astype(np.float32)
    u2 = r.random((B, M)).astype(np.float32)
    js = jm.make_sweep_fn(N, M, c["use_vp"], c["use_ages"])(
        c["st"], c["s"], c["aux"], phase, jnp.asarray(u1), jnp.asarray(u2))
    ts = tm.age_sweep(c["tst"], c["ts"], c["taux"], phase, _t(u1), _t(u2),
                      c["use_vp"], use_ages=c["use_ages"])
    _assert_same_state(js, ts, f"age sweep phase {phase}")
    assert (np.asarray(js.coords) != np.asarray(c["s"].coords)).any()


@pytest.mark.parametrize("phase", range(8))
def test_order_sweep_matches_jax(chains, phase):
    c = chains
    B = c["ts"].coords.shape[0]
    u2 = np.random.default_rng(20 + phase).random((B, M)).astype(np.float32)
    js = jm.make_order_sweep_fn(N, M)(c["st"], c["s"], c["aux"], phase,
                                      jnp.asarray(u2))
    ts = tm.order_sweep(c["tst"], c["ts"], c["taux"], phase, _t(u2))
    _assert_same_state(js, ts, f"order sweep phase {phase}")


def _step_draws(key, B):
    """The draws of ``make_step_fn``'s step for ``key``."""
    k_coin, k_node, k_u1, k_u2 = jax.random.split(key, 4)
    return (bool(jax.random.uniform(k_coin) <= jm.P2),
            _t(jax.random.uniform(k_node, (B,))),
            _t(jax.random.uniform(k_u1, (B,))),
            _t(jax.random.uniform(k_u2, (B,))))


@pytest.mark.parametrize("do_ue", [True, False],
                         ids=["update_one_event", "switch_order"])
def test_single_step_matches_jax(chains, do_ue):
    c = chains
    B = c["ts"].coords.shape[0]
    jstep = jm.make_step_fn(N, M, c["use_vp"], use_ages=c["use_ages"])
    # keys whose global coin picks this proposal; several, so that accepted
    # and rejected moves of it are both met
    keys = [k for k in (jax.random.PRNGKey(i) for i in range(60))
            if _step_draws(k, B)[0] == do_ue][:6]
    assert len(keys) == 6
    moved = 0
    for key in keys:
        coin, un, u1s, u2s = _step_draws(key, B)
        js = jstep(c["st"], c["s"], key, True)
        ts = tm.step(c["tst"], c["ts"], coin, un, u1s, u2s, c["use_vp"],
                     True, use_ages=c["use_ages"])
        _assert_same_state(js, ts, f"step do_ue={do_ue}")
        moved += int((np.asarray(js.coords)
                      != np.asarray(c["s"].coords)).any(axis=1).sum())
    assert moved > 0


def _iteration_draws(key, i, B):
    """The draws of ``_Block._iteration`` for (key, i)."""
    coin, un, u1s, u2s = _step_draws(jax.random.fold_in(key, 3 * i), B)
    kk = jax.random.fold_in(key, 3 * i + 1)
    age = []
    for s_i in range(2):
        ku1, ku2 = jax.random.split(jax.random.fold_in(kk, s_i))
        age.append((_t(jax.random.uniform(ku1, (B, M))),
                    _t(jax.random.uniform(ku2, (B, M)))))
    uo = _t(jax.random.uniform(jax.random.fold_in(key, 3 * i + 2), (B, M)))
    return tm.IterationDraws(coin, un, u1s, u2s, tuple(age), uo)


def test_twenty_iterations_match_jax(chains):
    c = chains
    B = c["ts"].coords.shape[0]
    key = jax.random.PRNGKey(11)
    active = np.ones(B, bool)
    active[2] = False                     # one retired chain stays frozen
    js, ts = c["s"], c["ts"]
    jit_iteration = jax.jit(lambda s, i: c["blk"]._iteration(
        c["st"], c["aux"], s, key, i, True, jnp.asarray(active)))
    for i in range(20):
        js = jit_iteration(js, i)
        ts = tm.iteration(c["tst"], c["taux"], ts, i,
                          _iteration_draws(key, i, B), c["use_vp"], True,
                          _t(active), use_ages=c["use_ages"])
    _assert_same_state(js, ts, "20 iterations")
    assert torch.equal(ts.coords[2], c["ts"].coords[2])
    assert float(ts.count[2]) == float(c["ts"].count[2])


def test_ancient_start_state_is_bit_exact():
    """``_pseudo_order`` and ``_initial_coords`` on the fixture of
    tests/test_ancient.py and on the ancient tree batch: equal arrays."""
    rng = np.random.default_rng(7)
    d = rng.random((N, N)).astype(np.float32)
    fixture = jtb.quick_build(d, theta=0.01, seed=3, sample_ages=AGES,
                              Ne=NE)
    ages_n = AGES / NE
    for t in [fixture] + _tree_batch(4, seed=9, sample_ages=AGES):
        tt = convert.tree_from_numpy(t.parent, t.child_left, t.child_right)
        si_j, o_j = jm._pseudo_order(t, ages_n)
        si_t, o_t = tm._pseudo_order(tt, ages_n)
        assert np.array_equal(si_j, si_t) and np.array_equal(o_j, o_t)
        assert si_t.dtype == o_t.dtype == np.int32
        c_j = jm._initial_coords(si_j, N, ages_n)
        c_t = tm._initial_coords(si_t, N, ages_n)
        assert np.array_equal(c_j, c_t)
        assert np.array_equal(c_t[:N], ages_n)
        assert np.array_equal(jm._initial_coords(si_j, N),
                              tm._initial_coords(si_t, N))


def test_lineage_profile_from_the_sorted_order():
    """``_kc2_from_sorted``: the JAX function's values; where the leaves
    sit first, ``kc2_pos`` from the last leaf on (the intervals before it
    are empty)."""
    trees = _tree_batch(3, sample_ages=AGES)
    sidx = np.stack([jm._pseudo_order(t, AGES / NE)[0] for t in trees])
    want = np.stack([np.asarray(jm._kc2_from_sorted(jnp.asarray(si), N))
                     for si in sidx])
    got = tm._kc2_from_sorted(torch.from_numpy(sidx.astype(np.int64)), N)
    assert np.array_equal(got.numpy(), want)
    nl = np.concatenate([np.full(N, N), 2 * N - 1 - np.arange(N, M)])
    first = tm._kc2_from_sorted(torch.arange(M)[None, :], N)
    assert np.array_equal(first[0, N - 1:].numpy(),
                          (nl * (nl - 1) / 2.0)[N - 1:].astype(np.float32))


@pytest.mark.parametrize("use_vp", [False, True],
                         ids=["constNe", "piecewise"])
def test_invariants_after_200_iterations(use_vp):
    trees = _tree_batch(8)
    st, cl, cr = _chain_setup(trees, use_vp)
    tst = _static_across(st)
    tie = tm.Draws(3, "cpu").uniform(8, M, high=0.99)
    s, depth = tm.device_init_state(tst.parent, N, tie, tst.depth)
    assert torch.equal(depth, tm.tree_depths_dev(tst.parent))
    assert np.array_equal(depth.numpy(), tm.tree_depths(np.asarray(st.parent)))
    s = tm.run(tst, s, tm.Draws(4, "cpu"), 200, use_vp, True)
    iota = torch.arange(M).expand(8, M)
    assert torch.equal(s.cs, torch.gather(s.coords, 1, s.sorted_idx))
    assert torch.equal(torch.gather(s.order, 1, s.sorted_idx), iota)
    assert bool((s.cs[:, 1:] >= s.cs[:, :-1]).all())
    par = tst.parent.clamp(min=0)
    older = torch.gather(s.coords, 1, par) > s.coords
    assert bool((older | (tst.parent < 0)).all())
    assert bool((s.coords[:, :N] == 0).all())
    assert float(s.count.min()) == 200 * 4      # step + 2 age + 1 order
    assert int(s.cprop[:, N:].min()) > 50
    assert bool(torch.isfinite(s.ssum).all())
