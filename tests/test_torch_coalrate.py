"""The port's coalescence-rate statistics (``evaluate/coalrate.py``) against
the JAX package's and the reference binary's, on the reference's final
``golden.anc/.mut`` (N = 8, 9,412 trees).

Counts are integer pair counts times each tree's span (whole and half base
pairs), so every partial sum is exact in float64: the port's device path
(on CPU tensors), its host twin and the JAX package (float32 per tree,
exact below 2^24) must give equal counts. The opportunity carries node ages:
the JAX package rounds each tree's block to float32, so it agrees to rtol
1e-5 (measured 1.7e-7), the host twin to rounding.
"""
import filecmp

import numpy as np
import pytest
import torch

from relate_tpu.evaluate import coalrate as jc
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.evaluate import coalrate as tc
from relate_tpu_torch.pipeline import scripts as tscripts

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pairs(golden_dir):
    """The golden .anc/.mut read by each package."""
    prefix = str(golden_dir / "golden")
    return tscripts._load_pair(prefix), jscripts._load_pair(prefix)


def _trees(anc):
    return [mt.tree for mt in anc.seq]


@pytest.mark.golden
def test_coalescence_rates_match_reference(golden_dir, pairs):
    """Whole-sample per-epoch rates against RelateCoalescentRate --mode
    EstimatePopulationSize on the same input (bins 3,7,0.2): the twin of
    tests/test_evaluate.py::test_coalescence_rates_match_reference."""
    anc, recs, bp, dist = pairs[0][:4]
    epochs = tc.epochs_from_bins(3, 7, 0.2, 28.0)
    spans = tc.tree_spans(anc, recs, dist)
    c, o = tc.coalescence_stats(_trees(anc), spans, epochs, device="cpu")
    mine = tc.finalize_rates(c.sum(axis=(1, 2)), o.sum(axis=(1, 2)))
    names, eref, rref = tc.read_coal(str(golden_dir / "checkrate.coal"))
    E = min(len(mine), rref.shape[0])
    rr, mm = rref[:E, 0, 0], mine[:E]
    sel = np.isfinite(rr) & np.isfinite(mm) & (rr > 0)
    assert sel.sum() >= 15
    np.testing.assert_allclose(mm[sel], rr[sel], rtol=1e-4)


def test_device_path_matches_host_twin_and_jax(pairs):
    """512 golden trees, 3 groups: the device path on CPU tensors against
    the host twin and the JAX package's ``coalescence_stats`` (the twin of
    tests/test_evaluate.py::test_coalescence_stats_device_matches_host)."""
    (anc, recs, bp, dist), (janc, jrecs) = pairs[0][:4], pairs[1][:2]
    epochs = tc.default_epochs()
    spans = tc.tree_spans(anc, recs, dist)[:512]
    assert np.array_equal(spans, jc.tree_spans(janc, jrecs, dist)[:512])
    grp = np.arange(anc.N) % 3
    trees = _trees(anc)[:512]
    c_d, o_d = tc.coalescence_stats(trees, spans, epochs, grp, device="cpu")
    c_h, o_h = tc.coalescence_stats(trees, spans, epochs, grp,
                                    use_device=False)
    c_j, o_j = jc.coalescence_stats(_trees(janc)[:512], spans, epochs, grp)
    assert c_d.shape == o_d.shape == (len(epochs), 3, 3)
    assert c_d.sum() > 0 and (o_d > 0).sum() > 20
    assert np.array_equal(c_d, c_h) and np.array_equal(c_d, c_j)
    np.testing.assert_allclose(o_d, o_h, rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(o_d, o_j, rtol=1e-5, atol=1e-3)
    # symmetric in the group axes, opportunity where the host twin has it
    assert np.array_equal(c_d, c_d.transpose(0, 2, 1))
    assert np.array_equal(o_d > 0, o_h > 0)


def test_batches_give_the_result_of_one_batch(pairs):
    """Batches smaller than the tree count, a tree with factor 0 (skipped)
    and sample ages: the same statistics as one batch and as the host
    twin."""
    anc, recs, bp, dist = pairs[0][:4]
    trees = _trees(anc)[:300]
    spans = tc.tree_spans(anc, recs, dist)[:300].copy()
    spans[7] = 0.0
    epochs = tc.default_epochs()
    ages = np.array([0.0, 0, 0, 0, 0, 0, 150.0, 900.0])
    grp = np.array([0, 1, 0, 1, 1, 0, 2, 2])
    one = tc.coalescence_stats(trees, spans, epochs, grp, ages, device="cpu")
    host = tc.coalescence_stats(trees, spans, epochs, grp, ages,
                                use_device=False)
    from relate_tpu_torch.utils import trace
    with trace.stage("stats", verbose=False):
        parts = tc.coalescence_stats(trees, spans, epochs, grp, ages,
                                     batch=64, device="cpu")
    (note,) = trace.STAGES[-1]["coal_stats"]
    assert note["trees"] == 299 and note["batches"] == 5
    assert note["groups"] == 3 and note["levels"] >= 3
    for got in (parts, host):
        assert np.array_equal(got[0], one[0])
        np.testing.assert_allclose(got[1], one[1], rtol=1e-12, atol=1e-9)


def test_host_functions_equal_jax(pairs, tmp_path):
    """Epoch grids, spans, rates and the .coal files: equal values and
    bytes."""
    (anc, recs, bp, dist), (janc, jrecs) = pairs[0][:4], pairs[1][:2]
    for ypg in (28.0, 25.0):
        assert np.array_equal(tc.default_epochs(ypg), jc.default_epochs(ypg))
    for bins in ((3, 7, 0.2), (2.5, 6, 0.25), (4, 4.1, 0.5)):
        assert np.array_equal(tc.epochs_from_bins(*bins, 28.0),
                              jc.epochs_from_bins(*bins, 28.0))
    assert np.array_equal(tc.tree_spans(anc, recs, dist),
                          jc.tree_spans(janc, jrecs, dist))
    rng = np.random.default_rng(0)
    E, G = 31, 3
    counts = rng.integers(0, 50, (E, G, G)).astype(float)
    opp = rng.random((E, G, G)) * 1e4
    opp[[3, 4, 9, 30]] = 0.0                   # epochs without opportunity
    assert np.array_equal(tc.filled_rates(counts, opp),
                          jc.filled_rates(counts, opp), equal_nan=True)
    rates = tc.finalize_rates(counts, opp)
    assert np.array_equal(rates, jc.finalize_rates(counts, opp),
                          equal_nan=True)
    epochs = tc.default_epochs()
    for name, r, names in (("whole", rates.sum(axis=(1, 2)), ["0"]),
                           ("pairs", rates, ["A", "B", "C"])):
        tc.write_coal(str(tmp_path / f"t_{name}.coal"), epochs, r, names)
        jc.write_coal(str(tmp_path / f"j_{name}.coal"), epochs, r, names)
        assert filecmp.cmp(tmp_path / f"t_{name}.coal",
                           tmp_path / f"j_{name}.coal", shallow=False)
        got, want = (tc.read_coal(str(tmp_path / f"t_{name}.coal")),
                     jc.read_coal(str(tmp_path / f"t_{name}.coal")))
        assert got[0] == want[0] and np.array_equal(got[1], want[1])
        assert np.array_equal(got[2], want[2], equal_nan=True)
    tc.generate_const_coal(str(tmp_path / "t.coal"), 2e4, epochs)
    jc.generate_const_coal(str(tmp_path / "j.coal"), 2e4, epochs)
    assert filecmp.cmp(tmp_path / "t.coal", tmp_path / "j.coal",
                       shallow=False)
    c2 = tc.summarize_for_genome([(counts, opp), (2 * counts, opp)])
    assert np.array_equal(c2[0], 3 * counts)
    assert tc.finalize_coalescence_count(counts) is counts


def test_per_tree_stats_and_bootstrap_equal_jax(pairs, monkeypatch):
    """Per-tree statistics (CoalRateForTree): counts equal the JAX
    package's, the opportunity agrees to rtol 1e-4 (the JAX package keeps a
    tree's opportunity in float32: measured 2e-5), batches give the result
    of one batch. The block bootstrap draws the same blocks from numpy's
    generator: fed the same per-tree statistics, equal replicates."""
    (anc, recs, bp, dist), janc = pairs[0][:4], pairs[1][0]
    trees, jtrees = _trees(anc)[:400], _trees(janc)[:400]
    epochs = tc.default_epochs()
    c, o = tc.per_tree_epoch_stats(trees, epochs, device="cpu")
    jcnt, jopp = jc.per_tree_epoch_stats(jtrees, epochs)
    assert c.shape == (400, len(epochs)) and np.array_equal(c, jcnt)
    np.testing.assert_allclose(o, jopp, rtol=1e-4, atol=1e-6)
    c2, o2 = tc.per_tree_epoch_stats(trees, epochs, batch=37, device="cpu")
    assert np.array_equal(c2, c) and np.allclose(o2, o, rtol=1e-12)
    # every tree's pairs coalesce once: N(N-1)/2 = 28 a tree
    assert (c.sum(axis=1) == 28).all()
    cc, oo, rr = tc.coal_rate_for_tree(trees, epochs, device="cpu")
    assert np.array_equal(cc, c) and np.array_equal(oo, o)
    assert np.array_equal(np.isnan(rr), o == 0)

    factors = tc.tree_spans(anc, recs, dist)[:400]
    monkeypatch.setattr(tc, "per_tree_epoch_stats",
                        lambda *a, **k: (jcnt.copy(), jopp.copy()))
    got = tc.bootstrap_rates(trees, factors, epochs, num_bootstrap=20,
                             block_size=30, seed=4, device="cpu")
    want = jc.bootstrap_rates(jtrees, factors, epochs, num_bootstrap=20,
                              block_size=30, seed=4)
    assert got.shape == (len(epochs), 20)
    assert np.array_equal(got, want, equal_nan=True)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(pairs):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    anc, recs, bp, dist = pairs[0][:4]
    trees = _trees(anc)[:4]
    epochs = tc.default_epochs()
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.coalescence_stats(trees, np.ones(4), epochs)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.per_tree_epoch_stats(trees, epochs)
    with pytest.raises(RuntimeError, match="CUDA"):
        tc.estimate_popsize_em(anc, recs, dist)
    # the plain host twin needs no device
    c, o = tc.coalescence_stats(trees, np.ones(4), epochs, use_device=False)
    assert c.sum() == 4 * 28


def test_jax_batch_cannot_hold_haplotype_pairs_at_n2048(monkeypatch):
    """``--poplabels hap`` (G = N) at N = 2048: the JAX package's fixed
    batch of 1,024 trees makes ``_stats_kernel`` return two (1024, 31, 2048,
    2048) float32 arrays, 532 GB each, far beyond one card's 80 GB
    (ROADMAP section C). The port sizes its batches from the memory a tree
    needs, 168 MB at this width: 6 trees a batch in the 1 GiB it allows on
    the CPU; on a card with 80 GB free, half of it less the call's six
    (31, 2048, 2048) float64 blocks (6.24 GB): 201 trees."""
    import jax
    import jax.numpy as jnp
    n, E, B = 2048, 31, 1024
    m = 2 * n - 1
    S = jax.ShapeDtypeStruct
    cnt, opp = jax.eval_shape(
        jc._stats_kernel(m, n, n, E), S((B, m), jnp.int32),
        S((B, m), jnp.int32), S((B, m - n), jnp.int32),
        S((B, m), jnp.float32), S((n, n), jnp.float32), S((E,), jnp.float32))
    assert cnt.shape == opp.shape == (B, E, n, n)
    assert cnt.size * 4 > 500e9
    per_tree = m * n * 4 + (m // 2) * (32 * n + 64)
    assert 167e6 < per_tree < 168e6
    assert tc._batch_size(m, n, E, torch.device("cpu"), 61) == 6
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device: (80e9, 80e9))
    assert tc._batch_size(m, n, E, torch.device("cuda"), 1000) == 201
    assert tc._batch_size(m, n, E, torch.device("cuda"), 61) == 61
