"""One section built by both packages from the same posterior and the same
merge seeds: flush positions, merge lists, events and mutation records must
be equal.

The JAX package runs its section program with the Pallas merge scan in
interpret mode. Its ``PaintOutput`` is carried across with
``relate_tpu_torch.convert`` so that both packages start from identical
numbers, and the int32 merge seeds that the JAX package derives from its
threefry key are computed here with JAX and handed to the port.

``exp`` in the distance assembly may differ by one ulp between XLA and
PyTorch on the CPU, and a merge list is discrete: on the panels below no
such difference flips a merge (every seed listed here was checked; a seed
that did flip one would have to be replaced, not tolerated).
"""
import numpy as np
import jax
import pytest
import torch

from relate_tpu.core import painting as jpainting
from relate_tpu.core import topology_device as jtd
from relate_tpu.utils.synth import synth_coalescent_panel
from relate_tpu_torch import convert
from relate_tpu_torch.core import painting as tpainting
from relate_tpu_torch.core import topology_device as ttd

torch.set_num_threads(1)

THETA = 0.001


def jax_merge_seeds(seed: int, S: int) -> np.ndarray:
    """The seeds the JAX section builder feeds its Pallas merge scan:
    fold_in(key, 0) for the first tree, fold_in(key, i + 1) for SNP i."""
    key = jax.random.PRNGKey(seed)
    return np.asarray([
        int(jax.random.randint(jax.random.fold_in(key, i), (), 0,
                               np.int32(2**31 - 1)))
        for i in range(S + 1)], dtype=np.int32)


def _inputs(seed, N, L):
    G, bp = synth_coalescent_panel(N, L, seed=seed)[:2]
    rng = np.random.default_rng(seed)
    # break the panel's block structure so that SNPs stop mapping and the
    # section code has to rebuild (and sometimes revert)
    flip = rng.random(G.shape) < 0.04
    G = np.where(flip, 1 - G, G).astype(np.uint8)
    L = G.shape[0]
    r = np.full(L, 2e-4)
    rpos = np.concatenate([[0.0], np.cumsum(r)])
    state = (rng.random(L) < 0.7).astype(np.int32)
    return G, bp[:L], r, rpos, state


def _sections(monkeypatch, seed, N, L, start, end, mode, fb):
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")
    G, bp, r, rpos, state = _inputs(seed, N, L)
    L = G.shape[0]
    end = min(end, L - 1)
    bounds = np.array([0, L]) if start == 0 else np.array([0, start, L])
    w = len(bounds) - 2
    jp = jpainting.Painter(G, r, jpainting.PaintingModel(N=N, theta=THETA))
    cp_j = jp.paint_stepping_stones(bounds)[w]
    kernel = jtd.make_section_kernel(THETA, N, L, mode, use_pallas=True)
    res_j = jtd.build_topology_section_device(
        jp, cp_j, G, rpos, state, bp, start, end, seed=seed, mode=mode,
        fb=fb, kernel=kernel)

    out_j = jp.repaint(cp_j)
    paint_t = convert.paint_output_from_numpy(
        np.asarray(out_j.topology), np.asarray(out_j.logscale),
        out_j.ls_base, out_j.plan.targets, np.asarray(out_j.plan.idx),
        np.asarray(out_j.plan.seqk), out_j.plan.D, device="cpu")
    tp = tpainting.Painter(G, r, tpainting.PaintingModel(N=N, theta=THETA),
                           device="cpu")
    S = end - start + 1
    res_t = ttd.build_topology_section_device(
        tp, None, G, rpos, state, bp, start, end, seed=seed, mode=mode,
        fb=fb, merge_seeds=jax_merge_seeds(seed, S), paint=paint_t)
    return res_j, res_t


def _assert_equal(res_j, res_t):
    assert len(res_t.anc.seq) == len(res_j.anc.seq)
    for mt, mj in zip(res_t.anc.seq, res_j.anc.seq):
        assert mt.pos == mj.pos                                # flush sites
        assert np.array_equal(mt.tree.parent, mj.tree.parent)  # merge lists
        assert np.array_equal(mt.tree.child_left, mj.tree.child_left)
        assert np.array_equal(mt.tree.child_right, mj.tree.child_right)
        assert np.array_equal(mt.tree.num_events, mj.tree.num_events)
        assert np.array_equal(mt.tree.SNP_begin, mj.tree.SNP_begin)
        assert np.array_equal(mt.tree.SNP_end, mj.tree.SNP_end)
    assert len(res_t.muts) == len(res_j.muts)
    for a, b in zip(res_t.muts, res_j.muts):
        assert (a.tree, a.branch, a.flipped) == (b.tree, b.branch, b.flipped)


@pytest.mark.parametrize("seed,N,L,start,end,mode,fb", [
    (3, 12, 70, 0, 63, 1, 0),          # whole first window, clade prior on
    (5, 16, 120, 60, 119, 1, 0),       # second window of two
    (7, 10, 70, 0, 60, 0, 3000),       # no clade prior, forced rebuilds
])
def test_section_matches_jax(monkeypatch, seed, N, L, start, end, mode, fb):
    res_j, res_t = _sections(monkeypatch, seed, N, L, start, end, mode, fb)
    _assert_equal(res_j, res_t)
    assert len(res_t.anc.seq) >= 3          # the section did rebuild


def test_section_matches_jax_on_the_incremental_route(monkeypatch):
    """One section with the incremental merge scan forced on both sides
    (the route of every N > 2048): the JAX package by its environment
    switch, the port by lowering the limit of its dense kernels. Equal
    section records. The size is used by no other test, and the section
    program the JAX package compiled under the switch is dropped from its
    cache, whose key does not hold the environment."""
    from relate_tpu_torch.ops import merge_scan as tms
    from relate_tpu_torch.ops import merge_scan_inc as tmi
    monkeypatch.setenv("RELATE_TPU_MERGE_INC", "1")
    monkeypatch.setattr(tms, "MAX_N_SMALL", 2)
    monkeypatch.setattr(tms, "MAX_N_LARGE", 2)
    import relate_tpu.ops.merge_scan_inc as jmi
    calls, jcalls = [], []
    real_plain, real_jax = tmi.merge_scan_inc_plain, jmi.merge_scan_incremental
    monkeypatch.setattr(tmi, "merge_scan_inc_plain",
                        lambda *a: calls.append(1) or real_plain(*a))
    monkeypatch.setattr(
        jmi, "merge_scan_incremental",
        lambda *a, **k: jcalls.append(1) or real_jax(*a, **k))
    cached = set(jtd._KERNEL_CACHE)
    try:
        res_j, res_t = _sections(monkeypatch, 3, 14, 66, 0, 59, 1, 0)
    finally:
        for k in set(jtd._KERNEL_CACHE) - cached:
            del jtd._KERNEL_CACHE[k]
    _assert_equal(res_j, res_t)
    assert len(res_t.anc.seq) >= 3          # the section did rebuild
    assert len(calls) >= len(res_t.anc.seq)  # every tree took the route
    assert jcalls                            # traced into the JAX program


def test_map_on_tree_block_equals_single():
    """Mapping a block of SNPs at once gives what one SNP at a time gives."""
    rng = np.random.default_rng(0)
    N = 12
    M = 2 * N - 1
    d = torch.from_numpy(rng.random((N, N)).astype(np.float32))
    from relate_tpu_torch.ops.merge_scan import merge_scan
    _, _, clades = merge_scan(d.contiguous(), torch.zeros_like(d), False,
                              1.0, 0.1, 5)
    leafmat = torch.cat([torch.eye(N), clades])
    csize = leafmat.sum(dim=1)
    car = torch.from_numpy((rng.random((40, N)) < 0.4).astype(np.float32))
    car[0] = 0
    car[1] = 1
    car[2] = leafmat[N + 3]                 # maps exactly
    car[3] = 1 - leafmat[N + 5]             # maps flipped
    tc = car.sum(dim=1)
    blk = ttd._map_on_tree(leafmat, csize, car, tc, N, M, 0.03 * N)
    for k in range(car.shape[0]):
        one = ttd._map_on_tree(leafmat, csize, car[k:k + 1], tc[k:k + 1], N,
                               M, 0.03 * N)
        for a, b in zip(blk, one):
            assert a[k] == b[0]
    assert blk.im[0] == 1 and blk.branch[0] == -1
    assert blk.im[1] == 1 and blk.branch[1] == M - 1
    assert blk.im[2] == 1 and blk.branch[2] == N + 3 and not blk.flipped[2]
    assert blk.im[3] == 2 and blk.branch[3] == N + 5 and blk.flipped[3]
    assert (blk.im == 3).any()


def test_default_merge_seeds_are_reproducible():
    a = ttd.default_merge_seeds(11, 50)
    b = ttd.default_merge_seeds(11, 50)
    assert a.dtype == np.int32 and a.shape == (51,)
    assert np.array_equal(a, b) and (a >= 0).all()
    assert not np.array_equal(a, ttd.default_merge_seeds(12, 50))
