"""The mutation-rate estimator of the port (``relate_tpu_torch/evaluate/
mutrate.py``) against the JAX package's, on the same inputs: the
reference's final ``golden.anc/.mut`` (N = 8) and a ``run_all`` output of
the port on a synthetic panel. Category indices are equal; mutation,
opportunity and rates agree at rtol 1e-12 (sums of float64 terms in
another order)."""
import numpy as np
import pytest
import torch

from relate_tpu.evaluate import coalrate as jcoalrate
from relate_tpu.evaluate import mutrate as jmr
from relate_tpu.io import extract as jextract
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.evaluate import mutrate as tmr
from relate_tpu_torch.io import extract as textract
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.pipeline import scripts as tscripts
from relate_tpu_torch.utils import synth

torch.set_num_threads(1)

EPOCHS = jcoalrate.default_epochs(28.0)
RTOL = 1e-12


def _close(got, want):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def golden(golden_dir):
    """The golden pair read by both packages, and its first 3,000 SNPs
    (181 trees) cut out by each package's AncMutForSubregion."""
    prefix = str(golden_dir / "golden")
    out = {}
    for name, scripts, ext in (("jax", jscripts, jextract),
                               ("port", tscripts, textract)):
        anc, recs, bp, dist, rsid, alleles = scripts._load_pair(prefix)
        sub, subm, (lo, hi) = ext.anc_mut_for_subregion(
            anc, recs, bp, bp[0], bp[2999])
        out[name] = dict(all=(anc, recs, dist),
                         sub=(sub, subm, bp[lo:hi + 1], dist[lo:hi + 1]))
    return out


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """``run_all`` of the port on the CPU on a synthetic panel (N = 16),
    read back by both packages."""
    d = tmp_path_factory.mktemp("mutrate")
    G, bp = synth.synth_coalescent_panel(16, 400, seed=3)[:2]
    p = str(d / "panel")
    synth.write_haps_sample(G, bp, p)
    synth.write_flat_map(p + ".map", int(bp[-1]))
    trelate.run_all(p + ".haps", p + ".sample", p + ".map", str(d / "out"),
                    memory_gb=1.0, verbose=False, device="cpu")
    return {name: scripts._load_pair(str(d / "out"))
            for name, scripts in (("jax", jscripts), ("port", tscripts))}


def _fasta(n, seed):
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list("ACGT"), n))


def _random_alleles(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.choice(list("ACGT"), n)
    d = rng.choice(list("ACGT"), n)
    return list(a), list(d)


def test_host_copies_match_jax():
    assert tmr.mutation_categories() == jmr.mutation_categories()
    for s in ("ACG", "TTA", "GCA"):
        assert tmr.reverse_complement(s) == jmr.reverse_complement(s)
    rng = np.random.default_rng(1)
    for _ in range(200):
        args = rng.choice(list("ACGTN"), 4)
        assert tmr.collapse_category(*args) == jmr.collapse_category(*args)
    dist = rng.integers(1, 1000, 50).astype(np.float64)
    assert np.array_equal(tmr.snp_bases(dist), jmr.snp_bases(dist))


def test_categorize_snps_on_a_random_fasta():
    n = 5000
    seq = _fasta(n, 11)
    rng = np.random.default_rng(12)
    bp = np.sort(rng.choice(np.arange(-2, n + 3), 800, replace=False))
    anc, der = _random_alleles(len(bp), 13)
    anc[:3] = ["AC", "a", "G"]
    der[:3] = ["T", "t", "G"]
    got, names = tmr.categorize_snps(bp, anc, der, seq)
    want, jnames = jmr.categorize_snps(bp, anc, der, seq)
    assert names == jnames and np.array_equal(got, want)
    assert (got == -1).sum() > 100 and len(np.unique(got[got >= 0])) > 80


def test_branch_length_in_epochs_with_sample_ages(golden):
    anc = golden["port"]["sub"][0]
    trees = [mt.tree for mt in anc.seq]
    ages = np.asarray([0, 0, 0, 0, 0, 150.0, 900.0, 4000.0])
    got = tmr.branch_length_in_epochs(trees, EPOCHS, ages, device="cpu")
    want = np.stack([jmr.branch_length_in_epochs(mt.tree, EPOCHS, ages)
                     for mt in golden["jax"]["sub"][0].seq])
    _close(got, want)
    plain = tmr.branch_length_in_epochs(trees, EPOCHS, None, device="cpu")
    assert not np.allclose(plain, got)


def test_spread_mutations_with_point_mutations():
    rng = np.random.default_rng(4)
    ab = rng.exponential(2000.0, 600)
    ae = ab + rng.exponential(3000.0, 600)
    ae[:150] = ab[:150]                          # point mutations
    ab[150:160] = ae[150:160] = EPOCHS[3]        # on an epoch boundary
    ae[160:170] = ab[160:170] - 1.0              # age_end below age_begin
    ab[170:175] = 0.0
    ages = np.stack([ab, ae], axis=1)
    got = tmr.spread_mutations(ages, EPOCHS, device="cpu")
    want = jmr.spread_mutations(ages, EPOCHS)
    _close(got, want)
    assert got.sum() == pytest.approx(600, rel=1e-12)


def _avg_both(j, t, categories=None, C=1):
    (ja, jr, jd), (ta, tr, td) = j, t
    got = tmr.avg_mutation_rate(ta, tr, td, EPOCHS, categories, C,
                                device="cpu")
    want = jmr.avg_mutation_rate(ja, jr, jd, EPOCHS, categories, C)
    for g, w in zip(got[:2], want[:2]):
        _close(g, w)
    assert np.array_equal(np.isnan(got[2]), np.isnan(want[2]))
    ok = ~np.isnan(want[2])
    np.testing.assert_allclose(got[2][ok], want[2][ok], rtol=RTOL, atol=0)
    return got


def test_avg_mutation_rate_on_the_golden_pair(golden):
    m, o, r = _avg_both(golden["jax"]["all"], golden["port"]["all"])
    assert m.shape == (len(EPOCHS), 1) and m.sum() > 100_000
    assert (o > 0).sum() > 10


def test_avg_mutation_rate_by_category_on_the_golden_pair(golden):
    sub, subm, bp, dist = golden["port"]["sub"]
    seq = _fasta(int(bp[-1]) + 2, 21)
    anc, der = _random_alleles(len(bp), 22)
    cats, names = tmr.categorize_snps(bp, anc, der, seq)
    jsub, jsubm = golden["jax"]["sub"][:2]
    m, o, r = _avg_both((jsub, jsubm, dist), (sub, subm, dist), cats,
                        len(names))
    assert m.shape == (len(EPOCHS), 96) and (m.sum(axis=0) > 0).sum() > 80


@pytest.mark.parametrize("by_category", [False, True])
def test_avg_mutation_rate_on_a_run_all_output(panel, by_category):
    (ja, jr, bp, jd, _, alleles), (ta, tr, _, td, _, _) = \
        panel["jax"], panel["port"]
    cats, C = None, 1
    if by_category:
        seq = _fasta(int(bp[-1]) + 2, 31)
        cats, names = tmr.categorize_snps(
            bp, [a.split("/")[0] for a in alleles],
            [a.split("/")[1] for a in alleles], seq)
        C = len(names)
        assert (cats >= 0).sum() > 300
    m, o, r = _avg_both((ja, jr, jd), (ta, tr, td), cats, C)
    assert m.sum() > 300


def test_mutation_density(panel, golden):
    for j, t in ((panel["jax"][:4], panel["port"][:4]),
                 (golden["jax"]["sub"], golden["port"]["sub"])):
        (ja, jr, _, jd), (ta, tr, _, td) = j, t
        for sample in (0, 5):
            got = tmr.mutation_density(ta, tr, td, EPOCHS, sample)
            want = jmr.mutation_density(ja, jr, jd, EPOCHS, sample)
            for g, w in zip(got, want):
                assert np.array_equal(g, w)
            assert got[0].sum() > 0


def test_write_rate_writes_the_jax_bytes(golden, tmp_path):
    _, _, r = tmr.avg_mutation_rate(*golden["port"]["all"], EPOCHS,
                                    device="cpu")
    tmr.write_rate(str(tmp_path / "port.rate"), EPOCHS, r)
    jmr.write_rate(str(tmp_path / "jax.rate"), EPOCHS, r)
    assert (tmp_path / "port.rate").read_bytes() == \
        (tmp_path / "jax.rate").read_bytes()
