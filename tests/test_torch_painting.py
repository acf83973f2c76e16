"""The port's painting layer (planner, stepping stones, repaint) against the
JAX package on the same panel.

The JAX ``Painter`` is sent through its Pallas kernels in interpret mode
(``RELATE_TPU_PALLAS_INTERPRET``), the port through the plain versions of
its kernels (``device="cpu"``). Tolerances: the planner's ``idx``/``seqk``/
``D``/``kmask`` exactly, ``pfac`` rtol 2e-5 and ``nxt`` rtol 1e-5 against the
float64 host plan; slabs and posterior rtol 1e-4 (the two planners round the
interval factors differently in the last float32 digit and the sums are
taken in another order), logscales atol 1e-3.
"""
import numpy as np
import pytest
import torch

from relate_tpu.core import painting as jpainting
from relate_tpu_torch import convert
from relate_tpu_torch.core import painting as tpainting

torch.set_num_threads(1)


def _panel(seed, N, L, p=0.3):
    rng = np.random.default_rng(seed)
    G = (rng.random((L, N)) < p).astype(np.uint8)
    r = rng.random(L) * 0.05
    return G, r


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")


@pytest.mark.parametrize("first,last", [(0, None), (17, 150)])
def test_device_plan_matches_host_plan(first, last):
    G, r = _panel(11, 8, 200)
    L, N = G.shape
    last = L - 1 if last is None else last
    targets = np.arange(N, dtype=np.int32)
    jmodel = jpainting.PaintingModel(N=N, theta=0.001)
    ref = jpainting.build_target_plan(G, r, jmodel, first, last, targets)

    painter = tpainting.Painter(G, r, tpainting.PaintingModel(N=N),
                                device="cpu")
    prep = painter._prep(targets, first, last)
    assert np.array_equal(prep["idx"].numpy(), ref.idx)
    assert np.array_equal(prep["seqk"].numpy(), ref.seqk)
    assert np.array_equal(prep["D"].numpy(), ref.D)
    assert np.array_equal(prep["kmask"].numpy(), ref.kmask)
    mism_ref = (ref.seqk.T[:, :, None] > G[ref.idx.T]).astype(np.int8)
    assert np.array_equal(prep["mism"].numpy(), mism_ref)
    np.testing.assert_allclose(prep["pfac"].numpy(), ref.pfac, rtol=2e-5,
                               atol=1e-12)
    np.testing.assert_allclose(prep["nxt"].numpy(), ref.nxt, rtol=1e-5,
                               atol=1e-6)
    # the port's own host plan is the same function
    own = tpainting.build_target_plan(G, r, painter.model, first, last,
                                      targets)
    for a, b in zip(own, ref):
        assert np.array_equal(a, b)


def test_device_plan_caps_long_intervals():
    """An interval with p > 0.99 takes the capped transition and the
    log(0.01) + log(1-theta) increment."""
    G, r = _panel(2, 6, 60, p=0.15)
    r = r * 400.0
    N = G.shape[1]
    targets = np.arange(N, dtype=np.int32)
    ref = jpainting.build_target_plan(
        G, r, jpainting.PaintingModel(N=N, theta=0.001), 0, len(r) - 1,
        targets)
    painter = tpainting.Painter(G, r, tpainting.PaintingModel(N=N),
                                device="cpu")
    prep = painter._prep(targets, 0, len(r) - 1)
    capped = np.isclose(ref.nxt, np.log(0.01) + np.log(0.999))
    assert capped.any() and not capped.all()
    np.testing.assert_allclose(prep["pfac"].numpy(), ref.pfac, rtol=2e-5,
                               atol=1e-12)
    np.testing.assert_allclose(prep["nxt"].numpy(), ref.nxt, rtol=1e-5,
                               atol=1e-6)


def _compare_checkpoints(cps_t, cps_j):
    assert len(cps_t) == len(cps_j)
    for ct, cj in zip(cps_t, cps_j):
        assert np.array_equal(ct.bsb, cj.bsb)
        assert np.array_equal(ct.bse, cj.bse)
        np.testing.assert_allclose(ct.alpha, cj.alpha, rtol=1e-4, atol=1e-30)
        np.testing.assert_allclose(ct.beta, cj.beta, rtol=1e-4, atol=1e-30)
        np.testing.assert_allclose(ct.ls_alpha, cj.ls_alpha, rtol=0,
                                   atol=1e-3)
        np.testing.assert_allclose(ct.ls_beta, cj.ls_beta, rtol=0, atol=1e-3)


def test_stepping_stones_and_repaint_match_jax(interpret):
    G, r = _panel(4, 12, 240)
    L, N = G.shape
    bounds = np.array([0, 80, 160, L])
    jp = jpainting.Painter(G, r, jpainting.PaintingModel(N=N, theta=0.001))
    tp = tpainting.Painter(G, r, tpainting.PaintingModel(N=N, theta=0.001),
                           device="cpu")
    cps_j = jp.paint_stepping_stones(bounds)
    cps_t = tp.paint_stepping_stones(bounds)
    _compare_checkpoints(cps_t, cps_j)
    assert np.abs(cps_t[1].ls_alpha).max() > 20.0     # rescales happened

    for w in (0, 1, 2):
        out_j = jp.repaint(cps_j[w])
        out_t = tp.repaint(cps_t[w])
        D = np.asarray(out_j.plan.D)
        assert np.array_equal(out_t.plan.D, D)
        Dmax = int(D.max())
        topo_j = np.asarray(out_j.topology)[:Dmax]
        ls_j = np.asarray(out_j.logscale)[:Dmax]
        topo_t = out_t.topology.numpy()
        ls_t = out_t.logscale.numpy()
        assert topo_t.shape == (Dmax, N, N)
        assert np.array_equal(np.asarray(out_j.plan.idx)[:, :Dmax],
                              out_t.plan.idx.numpy())
        np.testing.assert_allclose(out_t.ls_base, out_j.ls_base, atol=2e-3)
        for b in range(N):
            np.testing.assert_allclose(topo_t[:D[b], b], topo_j[:D[b], b],
                                       rtol=1e-4, atol=1e-30)
            np.testing.assert_allclose(ls_t[:D[b], b], ls_j[:D[b], b],
                                       rtol=0, atol=1e-3)
            assert not topo_t[D[b]:, b].any()


def test_repaint_from_carried_checkpoint_matches_jax(interpret):
    """State carried across with ``convert``: the JAX checkpoint, read out
    as NumPy, gives the same posterior in the port (subset of targets)."""
    G, r = _panel(6, 10, 160)
    L, N = G.shape
    bounds = np.array([0, 70, L])
    jp = jpainting.Painter(G, r, jpainting.PaintingModel(N=N, theta=0.001))
    tp = tpainting.Painter(G, r, tpainting.PaintingModel(N=N, theta=0.001),
                           device="cpu")
    cj = jp.paint_stepping_stones(bounds)[1]
    ct = convert.checkpoint_from_numpy(
        np.asarray(cj.alpha), np.asarray(cj.ls_alpha), np.asarray(cj.bsb),
        np.asarray(cj.beta), np.asarray(cj.ls_beta), np.asarray(cj.bse),
        device="cpu")
    targets = np.array([1, 4, 7], dtype=np.int32)
    out_j = jp.repaint(cj, targets)
    out_t = tp.repaint(ct, targets)
    D = np.asarray(out_j.plan.D)
    topo_j = np.asarray(out_j.topology)
    ls_j = np.asarray(out_j.logscale)
    for b in range(len(targets)):
        np.testing.assert_allclose(out_t.topology.numpy()[:D[b], b],
                                   topo_j[:D[b], b], rtol=1e-4, atol=1e-30)
        np.testing.assert_allclose(out_t.logscale.numpy()[:D[b], b],
                                   ls_j[:D[b], b], rtol=0, atol=1e-3)
    np.testing.assert_allclose(out_t.ls_base, out_j.ls_base, atol=1e-9)


def test_painting_hand_computed_case():
    """The reference's hand-computed case (include/test/test_painting.cpp):
    N=5, L=10, r=0. The posterior is constant across sites and encodes the
    mismatch-count matrix."""
    rows = ["0110000000", "0110010100", "0100000000", "0000100000",
            "0000100000"]
    G = np.array([[int(c) for c in r] for r in rows], dtype=np.uint8).T
    d = np.array([[0, 0, 1, 2, 2], [2, 0, 3, 4, 4], [0, 0, 0, 1, 1],
                  [1, 1, 1, 0, 0], [1, 1, 1, 0, 0]], dtype=np.float64)
    L, N = G.shape
    model = tpainting.PaintingModel(N=N, theta=0.025)
    painter = tpainting.Painter(G, np.zeros(L), model, device="cpu")
    cps = painter.paint_stepping_stones(np.array([0, L]))
    out = painter.repaint(cps[0])
    topo = out.topology.numpy()
    ls = out.logscale.numpy()
    rescale = np.log(model.theta / (1 - model.theta))
    for b in range(N):
        D = int(out.plan.D[b])
        norm = np.log(N - 1.0) - D * np.log(model.ntheta)
        for j in range(D):
            assert abs(ls[j, b] - ls[0, b]) < 1e-4
            np.testing.assert_allclose(topo[j, b], topo[0, b], atol=1e-5)
            for n in range(N):
                if n != b:
                    val = (np.log(topo[j, b, n]) + ls[j, b] + norm) / rescale
                    assert round(val) == d[b, n], (b, n, j, val)


@pytest.mark.golden
def test_stones_match_reference_paint_file(golden_dir, golden_chunk):
    """The port's checkpoints vs the reference binary's paint file on the
    example chunk (single window). The reference's RLE codec is lossy at
    1e-3 relative, which bounds achievable agreement."""
    from relate_tpu_torch.io import refpaint
    from relate_tpu_torch.io import chunking as tchunking
    ch = tchunking.read_reference_chunk(str(golden_dir / "chunk_0"))
    for f in ("G", "bp", "dist", "r", "rpos", "state"):
        assert np.array_equal(getattr(ch, f), getattr(golden_chunk, f)), f
    N = ch.N
    recs = refpaint.read_paint_file(str(golden_dir / "paint_relate_0.bin"), N)
    painter = tpainting.Painter(ch.G, ch.r,
                                tpainting.PaintingModel(N=N, theta=0.001),
                                device="cpu")
    cps = painter.paint_stepping_stones(np.array([0, ch.L]))
    assert len(cps) == 1
    cp = cps[0]
    for n, rec in enumerate(recs):
        assert rec.bsb == cp.bsb[n]
        assert rec.bse == cp.bse[n]
        np.testing.assert_allclose(cp.alpha[n], rec.alpha, rtol=5e-3,
                                   atol=1e-12)
        assert abs(cp.ls_alpha[n] - rec.ls_alpha) < 1e-3
        np.testing.assert_allclose(cp.beta[n], rec.beta, rtol=5e-3,
                                   atol=1e-12)
        assert abs(cp.ls_beta[n] - rec.ls_beta) < 2e-3 * max(
            1.0, abs(rec.ls_beta))
