"""The extraction utilities of the port (``relate_tpu_torch/io/extract.py``)
against the JAX package's, function by function, on the same input: the
first 3,000 SNPs of the reference's final ``golden.anc/.mut`` (N = 8), read
by each package's own reader. Host code on both sides: the trees, records
and every count must be equal."""
import copy

import numpy as np
import pytest

from relate_tpu.io import extract as jext
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.io import extract as text
from relate_tpu_torch.pipeline import scripts as tscripts

SNPS = 3000
AGES = np.asarray([0, 0, 0, 0, 0, 150.0, 900.0, 4000.0])


@pytest.fixture(scope="module")
def pairs(golden_dir):
    """{"jax": (anc, recs, bp, alleles), "port": ...} of the first SNPS
    SNPs."""
    out = {}
    for name, scripts, ext in (("jax", jscripts, jext),
                               ("port", tscripts, text)):
        anc, recs, bp, dist, rsid, alleles = scripts._load_pair(
            str(golden_dir / "golden"))
        sub, subm, (lo, hi) = ext.anc_mut_for_subregion(
            anc, recs, bp, bp[0], bp[SNPS - 1])
        out[name] = (sub, subm, bp[lo:hi + 1], alleles[lo:hi + 1])
    return out


def fresh(pairs, name, ages=False):
    anc, recs, bp, alleles = copy.deepcopy(pairs[name])
    if ages:
        anc.sample_ages = AGES.copy()
    return anc, recs, bp, alleles


FIELDS = ("parent", "child_left", "child_right", "branch_length",
          "num_events", "SNP_begin", "SNP_end")


def same_anc(a, b):
    assert a.N == b.N and len(a.seq) == len(b.seq)
    assert (a.sample_ages is None) == (b.sample_ages is None)
    if a.sample_ages is not None:
        assert np.array_equal(a.sample_ages, b.sample_ages)
    for x, y in zip(a.seq, b.seq):
        assert x.pos == y.pos
        for f in FIELDS:
            u, v = getattr(x.tree, f), getattr(y.tree, f)
            assert u.dtype == v.dtype and np.array_equal(u, v), f


def same_muts(a, b):
    assert [(m.tree, list(m.branch), bool(m.flipped), m.age_begin,
             m.age_end) for m in a] == \
        [(m.tree, list(m.branch), bool(m.flipped), m.age_begin, m.age_end)
         for m in b]


def test_anc_to_newick(pairs):
    (ja, jr, jbp, _), (ta, tr, tbp, _) = pairs["jax"], pairs["port"]
    for lo, hi in ((0, 10 ** 9), (int(tbp[100]), int(tbp[400])),
                   (int(tbp[-1]) + 1, int(tbp[-1]) + 5)):
        got = text.anc_to_newick(ta, tr, tbp, lo, hi)
        assert got == jext.anc_to_newick(ja, jr, jbp, lo, hi)
    assert len(text.anc_to_newick(ta, tr, tbp, 0, 10 ** 9)) == len(ta.seq)


@pytest.mark.parametrize("keep", [[0, 3, 5], [1, 2, 4, 6, 7], [6]])
def test_subtree_for_leaves_and_subpopulation(pairs, keep):
    (ja, jr, _, _), (ta, tr, _, _) = pairs["jax"], pairs["port"]
    for jt, tt in list(zip(ja.seq, ta.seq))[:50]:
        got, gmap = text.subtree_for_leaves(tt.tree, np.asarray(keep))
        want, wmap = jext.subtree_for_leaves(jt.tree, np.asarray(keep))
        assert np.array_equal(gmap, wmap)
        for f in FIELDS:
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
    for ages in (False, True):
        (ja, jr, _, _), (ta, tr, _, _) = (fresh(pairs, "jax", ages),
                                          fresh(pairs, "port", ages))
        ga, gm = text.subtrees_for_subpopulation(ta, tr, keep)
        wa, wm = jext.subtrees_for_subpopulation(ja, jr, keep)
        same_anc(ga, wa)
        same_muts(gm, wm)
        assert ga.N == len(keep)


def test_divide_and_combine(pairs):
    (ja, jr, _, _), (ta, tr, _, _) = pairs["jax"], pairs["port"]
    for k in (1, 3, 7):
        got = text.divide_anc_mut(ta, tr, k)
        want = jext.divide_anc_mut(ja, jr, k)
        assert len(got) == len(want) == k
        for (ga, gm), (wa, wm) in zip(got, want):
            same_anc(ga, wa)
            same_muts(gm, wm)
        ca, cm = text.combine_anc_mut(got)
        wa, wm = jext.combine_anc_mut(want)
        same_anc(ca, wa)
        same_muts(cm, wm)
        same_anc(ca, ta)
        same_muts(cm, tr)


def test_unlink_tips_and_ancient_to_modern(pairs):
    (ja, _, _, _), (ta, _, _, _) = fresh(pairs, "jax"), fresh(pairs, "port")
    same_anc(text.unlink_tips(ta, [0, 5]), jext.unlink_tips(ja, [0, 5]))
    assert (ta.seq[3].tree.branch_length[[0, 5]] == 0).all()
    for ages in (False, True):
        (ja, _, _, _), (ta, _, _, _) = (fresh(pairs, "jax", ages),
                                        fresh(pairs, "port", ages))
        got, want = text.ancient_to_modern(ta), jext.ancient_to_modern(ja)
        same_anc(got, want)
        assert got.sample_ages is None


def test_get_mut_count_and_branches(pairs):
    for ages in (False, True):
        (ja, jr, _, _), (ta, tr, _, _) = (fresh(pairs, "jax", ages),
                                          fresh(pairs, "port", ages))
        same_muts(text.get_mut(ta, tr), jext.get_mut(ja, jr))
    (ja, jr, jbp, _), (ta, tr, tbp, _) = pairs["jax"], pairs["port"]
    got = text.count_mut_on_branches(ta, tr)
    assert got == jext.count_mut_on_branches(ja, jr)
    assert sum(c for _, _, c in got) > 0.9 * SNPS
    assert text.all_branches_of_mut(tr) == jext.all_branches_of_mut(jr)
    per = text.check_branch_persistence(ta, tr, tbp)
    assert np.array_equal(per, jext.check_branch_persistence(ja, jr, jbp))
    assert (per > 0).sum() > SNPS // 2


def test_snp_annotations_and_leaves_below(pairs):
    (ja, jr, jbp, jal), (ta, tr, tbp, tal) = pairs["jax"], pairs["port"]
    rng = np.random.default_rng(3)
    alleles = [f"{a}/{d}" for a, d in zip(rng.choice(list("ACGT"), SNPS),
                                          rng.choice(list("ACGT"), SNPS))]
    alleles[7] = "N"
    for al in (tal, alleles):
        got = text.generate_snp_annotations_using_tree(ta, tr, tbp, al)
        assert got == jext.generate_snp_annotations_using_tree(ja, jr, jbp,
                                                               al)
    tree, jtree = ta.seq[10].tree, ja.seq[10].tree
    for v in range(tree.num_nodes):
        assert text.num_leaves_below(tree, v) == \
            jext.num_leaves_below(jtree, v) == tree.leaf_matrix()[v].sum()


def test_map_extra_mutations(pairs):
    (ja, jr, jbp, _), (ta, tr, tbp, _) = (fresh(pairs, "jax"),
                                          fresh(pairs, "port"))
    rng = np.random.default_rng(9)
    n = 200
    extra_bp = np.sort(rng.choice(tbp[:-1], n, replace=False)) + 1
    carriers = (rng.random((n, 8)) < 0.35).astype(np.uint8)
    carriers[:3] = 0
    carriers[3:6] = 1
    # carriers of existing branches: these map exactly
    for i in range(6, 60):
        m = tr[int(np.searchsorted(tbp, extra_bp[i], side="right")) - 1]
        if len(m.branch) == 1:
            carriers[i] = ta.seq[m.tree].tree.leaf_matrix()[m.branch[0]]
    got = text.map_extra_mutations(ta, tr, tbp, extra_bp, carriers)
    want = jext.map_extra_mutations(ja, jr, jbp, extra_bp, carriers)
    same_muts(got, want)
    assert sum(len(m.branch) == 1 for m in got) > 60
    assert sum(len(m.branch) > 1 for m in got) > 10
