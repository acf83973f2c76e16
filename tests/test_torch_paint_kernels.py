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


def _jax_inputs(G, plan, alpha0, beta_end):
    L, N = G.shape
    B, Dmax = plan.idx.shape
    idx = np.zeros((BP, Dmax), np.int32); idx[:B] = plan.idx
    seqk = np.zeros((BP, Dmax), np.uint8); seqk[:B] = plan.seqk
    D = np.zeros(BP, np.int32); D[:B] = plan.D
    Gp = np.zeros((L, NP), np.uint8); Gp[:, :N] = G
    grows = Gp[idx.T.reshape(-1)].reshape(Dmax, BP, NP)
    mism = (seqk.T[:, :, None] > grows).astype(np.int8).transpose(0, 2, 1)
    pfacT = np.zeros((Dmax, BP), np.float32); pfacT[:, :B] = plan.pfac.T
    nxtT = np.zeros((Dmax, BP), np.float32); nxtT[:, :B] = plan.nxt.T
    z = np.zeros((1, BP), np.float32)
    shifts = (np.concatenate([z, pfacT[:-1]]), np.concatenate([z, nxtT[:-1]]),
              np.concatenate([pfacT[1:], z]), np.concatenate([nxtT[1:], z]))
    a0 = np.zeros((NP, BP), np.float32); a0[:N, :B] = alpha0.T
    be = np.zeros((NP, BP), np.float32); be[:N, :B] = beta_end.T
    kmask = np.zeros((NP, BP), np.float32); kmask[:N, :B] = plan.kmask.T
    return D, mism, shifts, a0, be, kmask


def _torch_inputs(G, plan, alpha0, beta_end):
    mism = (plan.seqk.T[:, :, None] > G[plan.idx.T]).astype(np.int8)
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


@pytest.mark.parametrize("seed,N,L", [(3, 8, 64), (7, 11, 80)])
def test_capture_plain_matches_pallas(seed, N, L):
    G, plan, alpha0, beta_end, rng = _fixture(seed, N, L)
    jin = _jax_inputs(G, plan, alpha0, beta_end)
    D, mism, shifts, a0, be, kmask = jin
    want = rng.integers(0, plan.D).astype(np.int32)
    want[0] = 0
    want[1] = plan.D[1] - 1
    want[2] = plan.idx.shape[1] - 1     # at or past D for short targets
    want_p = np.zeros(BP, np.int32); want_p[:N] = want

    acap_k, lsa_k = jk.fwd_capture_pallas(
        jnp.asarray(D[None, :]), jnp.asarray(want_p[None, :]),
        jnp.asarray(a0), jnp.asarray(kmask), jnp.asarray(mism),
        jnp.asarray(shifts[0]), jnp.asarray(shifts[1]), theta=THETA,
        interpret=True)
    bcap_k, lsb_k = jk.bwd_capture_pallas(
        jnp.asarray(D[None, :]), jnp.asarray(want_p[None, :]),
        jnp.asarray(be), jnp.asarray(kmask), jnp.asarray(mism),
        jnp.asarray(shifts[2]), jnp.asarray(shifts[3]), theta=THETA,
        interpret=True)

    ti = _torch_inputs(G, plan, alpha0, beta_end)
    w = torch.from_numpy(want)
    acap_t, lsa_t = tk.fwd_capture(ti["D"], w, ti["alpha0"], ti["kmask"],
                                   ti["mism"], ti["pfac"], ti["nxt"],
                                   theta=THETA)
    bcap_t, lsb_t = tk.bwd_capture(ti["D"], w, ti["beta_end"], ti["kmask"],
                                   ti["mism"], ti["pfac"], ti["nxt"],
                                   theta=THETA)
    np.testing.assert_allclose(acap_t.numpy(), np.asarray(acap_k)[:N, :N].T,
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(lsa_t.numpy(), np.asarray(lsa_k)[:N],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(bcap_t.numpy(), np.asarray(bcap_k)[:N, :N].T,
                               rtol=1e-5, atol=1e-30)
    np.testing.assert_allclose(lsb_t.numpy(), np.asarray(lsb_k)[:N],
                               rtol=0, atol=1e-4)
    assert acap_t.numpy().any() and bcap_t.numpy().any()


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
    """A target's rows live in one block's shared memory (9 N bytes of the
    card's 232,448): N past that is refused with a clear error, N = 16384,
    the merge scan's limit, is inside."""
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
