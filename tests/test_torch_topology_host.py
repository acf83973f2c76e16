"""The host topology builder (``relate_tpu_torch/core/topology.py``) against
the JAX package's, one section at a time, for an unknown ancestral allele
and for sample ages: the same trees (flush positions, merge lists, events,
SNP spans) and the same mutation records (tree, branch, flipped), exactly.

Both builders start from the same posterior: the JAX package's repaint
(Pallas in interpret mode) carried across with ``relate_tpu_torch.convert``.
Both draw the merge seeds, and with an unknown ancestral allele the flip
coins too, from one ``numpy.random.default_rng(seed)`` in the same order.
The JAX module's tie draw is threefry, so it is replaced inside the test:
without ages by the JAX package's Pallas merge scan in interpret mode
(``pallas_scan``), with ages by the port's hash inside the JAX module's own
age-aware scan (``port_ties``); ``test_torch_treebuilder.py`` holds both
stand-ins to the port's tree builder. As in ``test_torch_topology.py``,
``exp`` in the distance assembly may differ by one ulp between XLA and
PyTorch, and a merge list is discrete: on these panels no such difference
flips a merge (every case listed was checked; one that did would have to be
replaced, not tolerated).
"""
import numpy as np
import pytest
import torch

from relate_tpu.core import painting as jpainting
from relate_tpu.core import topology as jtopology
from relate_tpu_torch import convert
from relate_tpu_torch.core import painting as tpainting
from relate_tpu_torch.core import topology as ttopology
from relate_tpu_torch.utils import trace
from test_torch_topology import THETA, _assert_equal, _inputs
from test_torch_treebuilder import pallas_scan, port_ties

torch.set_num_threads(1)


def _ages(N, seed):
    """The last quarter of the haplotypes ancient, two a sample sharing an
    age (as diploid individuals do)."""
    ages = np.zeros(N)
    k = N // 4 // 2
    old = np.repeat(np.random.default_rng(seed).choice(
        [400.0, 1500.0, 3000.0, 6000.0], k), 2)
    ages[N - 2 * k:] = np.sort(old)
    return ages


def _sections(monkeypatch, seed, N, L, start, end, mode, fb,
              ancestral_state, with_ages):
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")
    G, bp, r, rpos, state = _inputs(seed, N, L)
    L = G.shape[0]
    end = min(end, L - 1)
    ages = _ages(N, seed) if with_ages else None
    bounds = np.array([0, L]) if start == 0 else np.array([0, start, L])
    w = len(bounds) - 2
    jp = jpainting.Painter(G, r, jpainting.PaintingModel(N=N, theta=THETA))
    cp_j = jp.paint_stepping_stones(bounds)[w]
    with (port_ties() if with_ages else pallas_scan()):
        res_j = jtopology.build_topology_section(
            jp, cp_j, G, rpos, state, bp, start, end, seed=seed, mode=mode,
            ancestral_state=ancestral_state, fb=fb, sample_ages=ages)

    out_j = jp.repaint(cp_j)
    paint_t = convert.paint_output_from_numpy(
        np.asarray(out_j.topology), np.asarray(out_j.logscale),
        out_j.ls_base, out_j.plan.targets, np.asarray(out_j.plan.idx),
        np.asarray(out_j.plan.seqk), out_j.plan.D, device="cpu")
    tp = tpainting.Painter(G, r, tpainting.PaintingModel(N=N, theta=THETA),
                           device="cpu")
    with trace.stage("section", verbose=False):
        res_t = ttopology.build_topology_section(
            tp, None, G, rpos, state, bp, start, end, seed=seed, mode=mode,
            ancestral_state=ancestral_state, fb=fb, sample_ages=ages,
            paint=paint_t)
    (rec,) = trace.STAGES[-1]["topology"]
    return res_j, res_t, rec


@pytest.mark.parametrize("seed,N,L,start,end,mode,fb,first_piece", [
    (3, 12, 70, 0, 63, 1, 0, 64),      # whole first window, clade prior on
    (5, 16, 120, 60, 119, 1, 0, 64),   # second window of two
    (7, 10, 70, 0, 60, 0, 3000, 64),   # no clade prior, forced rebuilds
    (11, 24, 100, 0, 99, 1, 0, 1),     # pieces of 1, 2, 4, ... SNPs
])
def test_unknown_ancestral_allele_matches_jax(monkeypatch, seed, N, L, start,
                                              end, mode, fb, first_piece):
    """``ancestral_state=False``: symmetrised matrices and the flip coins,
    drawn from the generator that also gives the merge seeds. The port maps
    a block in pieces, the JAX module whole; the coins are the block's."""
    monkeypatch.setattr(ttopology, "FIRST_PIECE", first_piece)
    res_j, res_t, rec = _sections(monkeypatch, seed, N, L, start, end, mode,
                                  fb, False, False)
    _assert_equal(res_j, res_t)
    assert len(res_t.anc.seq) >= 3          # the section did rebuild
    assert rec["trees"] == len(res_t.anc.seq) <= rec["tree_builds"]
    assert any(m.flipped for m in res_t.muts)


@pytest.mark.parametrize("ancestral_state", [True, False],
                         ids=["ancestral", "unknown"])
@pytest.mark.parametrize("seed,N,L,start,end,mode,fb", [
    (3, 12, 70, 0, 63, 1, 0),
    (5, 16, 120, 60, 119, 1, 0),
    (11, 24, 100, 0, 99, 1, 0),
    (7, 10, 70, 0, 60, 0, 3000),
])
def test_sample_ages_match_jax(monkeypatch, seed, N, L, start, end, mode, fb,
                               ancestral_state):
    """Sample ages: every tree is built by the age-aware scan."""
    res_j, res_t, rec = _sections(monkeypatch, seed, N, L, start, end, mode,
                                  fb, ancestral_state, True)
    _assert_equal(res_j, res_t)
    assert len(res_t.anc.seq) >= 2
    assert rec["trees"] == len(res_t.anc.seq) <= rec["tree_builds"]
