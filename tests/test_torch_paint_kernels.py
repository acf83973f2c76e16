"""Plain versions of the port's painting sweeps vs the Pallas kernels of the
JAX package (interpret mode on the CPU), on the same inputs.

The port keeps sources contiguous, (B, N) / (Dmax, B, N), and takes the
planner's unshifted (B, Dmax) pfac/nxt; the JAX kernels take (N, B) /
(Dmax, N, B), padded, with pre-shifted (Dmax, B) vectors. Tolerances: rtol
1e-5 on valid rows (the block sums are taken in another order), logscales
atol 1e-4, rows >= D exactly zero on the backward outputs.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from relate_tpu.core import painting as jpainting
from relate_tpu.ops import paint_kernels as jk
from relate_tpu_torch.ops import paint_kernels as tk

torch.set_num_threads(1)

THETA = 0.001
BP, NP = 128, 32     # the JAX kernels' lane / sublane padding


def _fixture(seed, N, L):
    rng = np.random.default_rng(seed)
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    r = rng.random(L) * 0.05
    model = jpainting.PaintingModel(N=N, theta=THETA)
    plan = jpainting.build_target_plan(G, r, model, 0, L - 1)
    alpha0 = jpainting.initial_alpha(G, model, 0, np.arange(N, dtype=np.int32))
    beta_end = (rng.random((N, N)) + 0.5).astype(np.float32)
    return G, plan, alpha0, beta_end, rng


def _jax_layout(D, mism, pfac, nxt, alpha0, beta_end, kmask):
    """Inputs in the port's layout ((Dmax, B, N) / (B, N) / (B, Dmax)) put
    in the JAX kernels' padded layout: (D (BP,), mism (Dmax, NP, BP),
    the pre-shifted (pfacm1, nxtm1, pfacp1, nxtp1) (Dmax, BP), alpha0,
    beta_end, kmask (NP, BP)), the sources padded to a multiple of NP.
    Padded sources have kmask 0."""
    Dmax, B, N = mism.shape
    npad = -(-N // NP) * NP
    Dp = np.zeros(BP, np.int32); Dp[:B] = D
    mp = np.zeros((Dmax, npad, BP), np.int8)
    mp[:, :N, :B] = mism.transpose(0, 2, 1)
    pfacT = np.zeros((Dmax, BP), np.float32); pfacT[:, :B] = pfac.T
    nxtT = np.zeros((Dmax, BP), np.float32); nxtT[:, :B] = nxt.T
    z = np.zeros((1, BP), np.float32)
    shifts = (np.concatenate([z, pfacT[:-1]]), np.concatenate([z, nxtT[:-1]]),
              np.concatenate([pfacT[1:], z]), np.concatenate([nxtT[1:], z]))

    def pad(x):
        out = np.zeros((npad, BP), np.float32)
        out[:N, :B] = x.T
        return out
    return Dp, mp, shifts, pad(alpha0), pad(beta_end), pad(kmask)


def _plan_mism(G, plan):
    return (plan.seqk.T[:, :, None] > G[plan.idx.T]).astype(np.int8)


def _jax_inputs(G, plan, alpha0, beta_end):
    return _jax_layout(plan.D, _plan_mism(G, plan), plan.pfac, plan.nxt,
                       alpha0, beta_end, plan.kmask)


def _torch_inputs(G, plan, alpha0, beta_end):
    mism = _plan_mism(G, plan)
    t = torch.from_numpy
    return dict(D=t(plan.D.astype(np.int32)), kmask=t(plan.kmask),
                mism=t(np.ascontiguousarray(mism)),
                pfac=t(np.ascontiguousarray(plan.pfac)),
                nxt=t(np.ascontiguousarray(plan.nxt)),
                alpha0=t(alpha0), beta_end=t(beta_end))


def _jax_fwd(jin, theta=THETA):
    D, mism, shifts, a0, be, kmask = jin
    return jk.fwd_pallas(jnp.asarray(D[None, :]), jnp.asarray(a0),
                         jnp.asarray(kmask), jnp.asarray(mism),
                         jnp.asarray(shifts[0]), jnp.asarray(shifts[1]),
                         theta=theta, interpret=True)


@pytest.mark.parametrize("seed,N,L", [(3, 8, 64), (5, 13, 90)])
def test_fwd_plain_matches_pallas(seed, N, L):
    G, plan, alpha0, beta_end, _ = _fixture(seed, N, L)
    al_k, ls_k = (np.asarray(x) for x in
                  _jax_fwd(_jax_inputs(G, plan, alpha0, beta_end)))
    ti = _torch_inputs(G, plan, alpha0, beta_end)
    al_t, ls_t = tk.fwd(ti["D"], ti["alpha0"], ti["kmask"], ti["mism"],
                        ti["pfac"], ti["nxt"], theta=THETA)
    al_t, ls_t = al_t.numpy(), ls_t.numpy()
    # every row, held rows past D included
    np.testing.assert_allclose(al_t, al_k[:, :N, :N].transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(ls_t, ls_k[:, :N], rtol=0, atol=1e-4)
    assert np.abs(ls_t).max() > 20.0      # the rescale did trigger


@pytest.mark.parametrize("emit_beta", [False, True])
@pytest.mark.parametrize("seed,N,L", [(3, 8, 64), (5, 13, 90)])
def test_bwd_plain_matches_pallas(seed, N, L, emit_beta):
    G, plan, alpha0, beta_end, _ = _fixture(seed, N, L)
    jin = _jax_inputs(G, plan, alpha0, beta_end)
    D, mism, shifts, a0, be, kmask = jin
    al_k, ls_k = _jax_fwd(jin)
    topo_k, lstot_k = jk.bwd_pallas(
        jnp.asarray(D[None, :]), jnp.asarray(be), jnp.asarray(kmask),
        jnp.asarray(mism), jnp.asarray(shifts[2]), jnp.asarray(shifts[3]),
        al_k, ls_k, theta=THETA, interpret=True, emit_beta=emit_beta)
    topo_k, lstot_k = np.asarray(topo_k), np.asarray(lstot_k)

    ti = _torch_inputs(G, plan, alpha0, beta_end)
    al_t, ls_t = tk.fwd(ti["D"], ti["alpha0"], ti["kmask"], ti["mism"],
                        ti["pfac"], ti["nxt"], theta=THETA)
    topo_t, lstot_t = tk.bwd(ti["D"], ti["beta_end"], ti["kmask"], ti["mism"],
                             ti["pfac"], ti["nxt"], al_t, ls_t, theta=THETA,
                             emit_beta=emit_beta)
    topo_t, lstot_t = topo_t.numpy(), lstot_t.numpy()
    np.testing.assert_allclose(topo_t, topo_k[:, :N, :N].transpose(0, 2, 1),
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(lstot_t, lstot_k[:, :N], rtol=0, atol=1e-4)
    for b in range(N):
        assert not topo_t[plan.D[b]:, b].any()
        assert not lstot_t[plan.D[b]:, b].any()
        assert topo_t[:plan.D[b], b].any()


def _bwd_case(seed, N, Dmax, d_max=None, pfac_scale=0.01, density=0.4):
    """Synthetic inputs of the full backward sweep in the port's layout, as
    numpy arrays, for B = 6 targets: (D, mism (Dmax,B,N), pfac, nxt
    (B,Dmax), beta_end, kmask (B,N), alphas (Dmax,B,N), lsf (Dmax,B)). D in
    [2, d_max] with D[0] = 2 and D[1] = d_max."""
    rng = np.random.default_rng(seed)
    B = 6
    d_max = Dmax if d_max is None else d_max
    D = rng.integers(2, d_max + 1, B).astype(np.int32)
    D[0], D[1] = 2, d_max
    mism = (rng.random((Dmax, B, N)) < density).astype(np.int8)
    pfac = ((rng.random((B, Dmax)) + 0.5) * pfac_scale).astype(np.float32)
    nxt = (-rng.random((B, Dmax))).astype(np.float32)
    beta_end = (rng.random((B, N)) + 0.5).astype(np.float32)
    kmask = np.ones((B, N), np.float32)
    kmask[np.arange(B), np.arange(B) % N] = 0.0
    alphas = (rng.random((Dmax, B, N)) + 0.1).astype(np.float32)
    lsf = (-rng.random((Dmax, B)) * 50.0).astype(np.float32)
    return D, mism, pfac, nxt, beta_end, kmask, alphas, lsf


def _rescaled_share(D, nxt, lsb):
    """Share of the stepped rows whose backward-only logscale moved by more
    than its step term, i.e. the rows the sweep rescaled."""
    Dmax = lsb.shape[0]
    j = np.arange(1, Dmax)[:, None]
    stepped = j < D[None, :]
    moved = np.abs(lsb[:-1] - lsb[1:] - nxt.T[1:]) > 1.0
    return (moved & stepped).sum() / max(stepped.sum(), 1)


@pytest.mark.parametrize("emit_beta", [False, True])
@pytest.mark.parametrize("case,theta,rescaled", [
    pytest.param(dict(seed=41, N=2, Dmax=16), THETA, 0.0, id="n2"),
    pytest.param(dict(seed=43, N=3, Dmax=16), THETA, 0.0, id="n3"),
    pytest.param(dict(seed=47, N=33, Dmax=24), THETA, 0.0, id="n33"),
    pytest.param(dict(seed=53, N=8, Dmax=8, d_max=2), THETA, 0.0,
                 id="d2-every-target"),
    pytest.param(dict(seed=59, N=16, Dmax=16, pfac_scale=1e11), THETA, 1.0,
                 id="rescale-every-step"),
    pytest.param(dict(seed=61, N=16, Dmax=16, density=0.95), 0.999999, 0.4,
                 id="rescale-every-other-step"),
])
def test_bwd_edges_match_pallas(case, theta, rescaled, emit_beta):
    """The full backward sweep (both modes) against bwd_pallas (interpret
    mode) on synthetic inputs at the edges of the CUDA kernel's blocks:
    fewer sources than a warp's lanes, N a multiple of neither 4 nor 16,
    every target at D = 2, and rows that rescale at every step (pfac 1e11)
    or at about every other one (theta 0.999999 and dense mismatches: a
    mismatch multiplies a source by 1e6). Both take the same alphas and
    lsf; rows at and past D are exactly zero."""
    D, mism, pfac, nxt, beta_end, kmask, alphas, lsf = _bwd_case(**case)
    Dmax, B, N = mism.shape
    Dp, mp, shifts, _, be, km = _jax_layout(D, mism, pfac, nxt, beta_end,
                                            beta_end, kmask)
    ap = np.zeros((Dmax,) + mp.shape[1:], np.float32)
    ap[:, :N, :B] = alphas.transpose(0, 2, 1)
    lp = np.zeros((Dmax, BP), np.float32); lp[:, :B] = lsf
    j = jnp.asarray
    topo_k, lstot_k = jk.bwd_pallas(
        j(Dp[None, :]), j(be), j(km), j(mp), j(shifts[2]), j(shifts[3]),
        j(ap), j(lp), theta=theta, interpret=True, emit_beta=emit_beta)
    topo_k = np.asarray(topo_k)[:, :N, :B].transpose(0, 2, 1)
    lstot_k = np.asarray(lstot_k)[:, :B]

    t = torch.from_numpy
    topo_t, lstot_t = tk.bwd(t(D), t(beta_end), t(kmask), t(mism), t(pfac),
                             t(nxt), t(alphas), t(lsf), theta=theta,
                             emit_beta=emit_beta)
    topo_t, lstot_t = topo_t.numpy(), lstot_t.numpy()
    np.testing.assert_allclose(topo_t, topo_k, rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(lstot_t, lstot_k, rtol=0, atol=1e-4)
    past = np.arange(Dmax)[:, None] >= D[None, :]
    assert not topo_t[past].any() and not lstot_t[past].any()
    assert all(topo_t[:D[b], b].any() for b in range(B))
    lsb = tk.bwd_plain(t(D), t(beta_end), t(kmask), t(mism), t(pfac), t(nxt),
                       t(alphas), t(lsf), theta=theta, emit_beta=True)[1]
    share = _rescaled_share(D, nxt, lsb.numpy())
    assert share >= rescaled and (rescaled > 0 or share < 0.5)


def _capture_case(kind, seed, N, L):
    """Inputs of the capture sweeps in the port's layout, as numpy arrays:
    (D, want, mism (Dmax,B,N), pfac, nxt (B,Dmax), alpha0, beta_end, kmask
    (B,N)). "plan" cases come from a panel's window plan; "synthetic" ones
    draw every input, with N sources (as few as one) and B = 6 targets."""
    if kind.startswith("synthetic"):
        rng = np.random.default_rng(seed)
        B, Dmax = 6, L
        D = rng.integers(2, Dmax + 1, B).astype(np.int32)
        D[0] = 2
        mism = (rng.random((Dmax, B, N)) < 0.4).astype(np.int8)
        pfac = ((rng.random((B, Dmax)) + 0.5) * 0.01).astype(np.float32)
        nxt = (-rng.random((B, Dmax))).astype(np.float32)
        alpha0 = (rng.random((B, N)) + 0.1).astype(np.float32)
        beta_end = (rng.random((B, N)) + 0.5).astype(np.float32)
        kmask = np.ones((B, N), np.float32)
        if N > 1:
            kmask[np.arange(B), np.arange(B) % N] = 0.0
        # -1, 0, D-1, D (held forward, none backward), Dmax and beyond
        want = np.array([-1, 0, D[2] - 1, D[3], Dmax, Dmax + 5], np.int32)
        return D, want, mism, pfac, nxt, alpha0, beta_end, kmask
    G, plan, alpha0, beta_end, rng = _fixture(seed, N, L)
    D = plan.D.astype(np.int32).copy()
    Dmax = plan.idx.shape[1]
    mism = _plan_mism(G, plan)
    want = rng.integers(0, plan.D).astype(np.int32)
    want[0] = 0
    want[1] = plan.D[1] - 1
    want[2] = Dmax - 1                  # at or past D for short targets
    if kind == "plan, want -1 and past Dmax":
        want[3], want[4], want[5] = -1, Dmax, Dmax + 7
    elif kind == "plan, D = 2":
        D[1:4] = 2
        want[1:4] = (0, 1, 5)           # row 0, row D - 1, and past D
    return (D, want, np.ascontiguousarray(mism), plan.pfac, plan.nxt,
            alpha0, beta_end, plan.kmask)


@pytest.mark.parametrize("kind,seed,N,L", [
    pytest.param("plan", 3, 8, 64, id="3-8-64"),
    pytest.param("plan", 7, 11, 80, id="7-11-80"),
    pytest.param("plan, want -1 and past Dmax", 13, 9, 70,
                 id="want-1-and-past-dmax"),
    pytest.param("plan, D = 2", 17, 10, 60, id="d2"),
    pytest.param("plan", 19, 3, 40, id="plan-n3"),
    pytest.param("synthetic", 23, 1, 12, id="synthetic-n1"),
    pytest.param("synthetic", 29, 2, 16, id="synthetic-n2"),
    pytest.param("synthetic", 31, 3, 9, id="synthetic-n3"),
])
def test_capture_plain_matches_pallas(kind, seed, N, L):
    """The capture sweeps' plain versions against fwd_capture_pallas and
    bwd_capture_pallas (interpret mode): panel plans, wanted rows -1, 0,
    D-1, D, Dmax and beyond, targets with D = 2, and one to three sources.
    Targets with no wanted row (forward: want < 0 or >= Dmax; backward:
    also want >= D) are zero in both."""
    D, want, mism, pfac, nxt, alpha0, beta_end, kmask = _capture_case(
        kind, seed, N, L)
    Dmax, B, _ = mism.shape
    Dp, mp, shifts, a0, be, km = _jax_layout(D, mism, pfac, nxt, alpha0,
                                             beta_end, kmask)
    wp = np.zeros(BP, np.int32); wp[:B] = want
    j = jnp.asarray
    acap_k, lsa_k = jk.fwd_capture_pallas(
        j(Dp[None, :]), j(wp[None, :]), j(a0), j(km), j(mp), j(shifts[0]),
        j(shifts[1]), theta=THETA, interpret=True)
    bcap_k, lsb_k = jk.bwd_capture_pallas(
        j(Dp[None, :]), j(wp[None, :]), j(be), j(km), j(mp), j(shifts[2]),
        j(shifts[3]), theta=THETA, interpret=True)

    t = torch.from_numpy
    args = (t(D), t(want))
    rest = (t(kmask), t(mism), t(np.ascontiguousarray(pfac)),
            t(np.ascontiguousarray(nxt)))
    acap_t, lsa_t = tk.fwd_capture(*args, t(alpha0), *rest, theta=THETA)
    bcap_t, lsb_t = tk.bwd_capture(*args, t(beta_end), *rest, theta=THETA)
    np.testing.assert_allclose(acap_t.numpy(), np.asarray(acap_k)[:N, :B].T,
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(lsa_t.numpy(), np.asarray(lsa_k)[:B],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(bcap_t.numpy(), np.asarray(bcap_k)[:N, :B].T,
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(lsb_t.numpy(), np.asarray(lsb_k)[:B],
                               rtol=0, atol=1e-4)
    fwd_none = (want < 0) | (want >= Dmax)
    bwd_none = fwd_none | (want >= D)
    assert not acap_t.numpy()[fwd_none].any()
    assert not bcap_t.numpy()[bwd_none].any()
    assert acap_t.numpy()[~fwd_none].any() and bcap_t.numpy()[~bwd_none].any()


def test_capture_equals_row_of_full_sweep():
    """The capture variants return exactly the wanted row of the full
    sweeps (same arithmetic, same order)."""
    G, plan, alpha0, beta_end, rng = _fixture(9, 10, 70)
    ti = _torch_inputs(G, plan, alpha0, beta_end)
    want = torch.from_numpy(rng.integers(0, plan.D).astype(np.int32))
    al, ls = tk.fwd_plain(ti["D"], ti["alpha0"], ti["kmask"], ti["mism"],
                          ti["pfac"], ti["nxt"], theta=THETA)
    be, lsb = tk.bwd_plain(ti["D"], ti["beta_end"], ti["kmask"], ti["mism"],
                           ti["pfac"], ti["nxt"], al, ls, theta=THETA,
                           emit_beta=True)
    acap, lsa = tk.fwd_capture_plain(ti["D"], want, ti["alpha0"], ti["kmask"],
                                     ti["mism"], ti["pfac"], ti["nxt"],
                                     theta=THETA)
    bcap, lsbc = tk.bwd_capture_plain(ti["D"], want, ti["beta_end"],
                                      ti["kmask"], ti["mism"], ti["pfac"],
                                      ti["nxt"], theta=THETA)
    bidx = torch.arange(len(want))
    w = want.long()
    assert torch.equal(acap, al[w, bidx])
    assert torch.equal(lsa, ls[w, bidx])
    assert torch.equal(bcap, be[w, bidx])
    assert torch.equal(lsbc, lsb[w, bidx])


def test_wrappers_refuse_wrong_inputs():
    G, plan, alpha0, beta_end, _ = _fixture(3, 8, 64)
    ti = _torch_inputs(G, plan, alpha0, beta_end)
    with pytest.raises(TypeError):
        tk.fwd(ti["D"].long(), ti["alpha0"], ti["kmask"], ti["mism"],
               ti["pfac"], ti["nxt"], theta=THETA)
    with pytest.raises(ValueError):
        tk.fwd(ti["D"], ti["alpha0"].t(), ti["kmask"], ti["mism"],
               ti["pfac"], ti["nxt"], theta=THETA)
    with pytest.raises(ValueError):
        tk.bwd_capture(ti["D"], ti["D"][:-1], ti["beta_end"], ti["kmask"],
                       ti["mism"], ti["pfac"], ti["nxt"], theta=THETA)
    assert all(v == 0 for v in tk.launches.values())


def test_wrappers_refuse_rows_past_shared_memory():
    """The sweeps take N <= 25,827 (nine bytes a source of the card's
    232,448 bytes of shared memory a block): N past that is refused with a
    clear error, N = 16384, the merge scan's limit, is inside."""
    assert 16384 <= tk.MAX_N == 25827
    N = tk.MAX_N + 1
    mism = torch.zeros((2, 1, N), dtype=torch.int8)
    row = torch.zeros((1, N))
    step = torch.zeros((1, 2))
    D = torch.full((1,), 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="support N <= 25827"):
        tk.fwd(D, row, row, mism, step, step, theta=THETA)
    with pytest.raises(ValueError, match="support N <= 25827"):
        tk.bwd_capture(D, D, row, row, mism, step, step, theta=THETA)
