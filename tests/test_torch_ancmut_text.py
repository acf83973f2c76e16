"""The text ``.anc`` and the final ``.mut`` of the port against the JAX
package's writers and readers: byte-equal files, and round trips."""
import filecmp

import numpy as np
import pytest

from relate_tpu.core.trees import AncesTree as JAncesTree
from relate_tpu.core.trees import MarginalTree as JMarginalTree
from relate_tpu.core.trees import Tree as JTree
from relate_tpu.io import ancmut as jam
from relate_tpu_torch import convert
from relate_tpu_torch.core.trees import AncesTree, MarginalTree
from relate_tpu_torch.io import ancmut as tam


def _ancestree(N, T, seed, ages):
    rng = np.random.default_rng(seed)
    M = 2 * N - 1
    jseq, tseq = [], []
    pos = 0
    for _ in range(T):
        parent = np.full(M, -1, np.int32)
        cl = np.full(M, -1, np.int32)
        cr = np.full(M, -1, np.int32)
        act = list(range(N))
        for t in range(N - 1):
            i = act.pop(rng.integers(len(act)))
            j = act.pop(rng.integers(len(act)))
            parent[i] = parent[j] = N + t
            cl[N + t], cr[N + t] = min(i, j), max(i, j)
            act.append(N + t)
        # lengths that meet the rounding of %.5f and %.3f: tiny, huge,
        # halves of the last printed digit
        bl = rng.random(M) * 10.0 ** rng.integers(-7, 6, M)
        bl[rng.integers(M)] = 0.000005
        bl[rng.integers(M)] = 12345.678915
        bl[M - 1] = 0.0
        ne = np.round(rng.random(M) * 7, rng.integers(0, 5)).astype(np.float32)
        ne[rng.integers(M)] = 0.0005
        sb = rng.integers(0, 500, M).astype(np.int32)
        se = (sb + rng.integers(0, 500, M)).astype(np.int32)
        jt = JTree(parent, cl, cr, bl, ne, sb, se)
        jseq.append(JMarginalTree(pos=pos, tree=jt))
        tseq.append(MarginalTree(pos=pos, tree=convert.tree_from_numpy(
            parent, cl, cr, bl, ne, sb, se)))
        pos += int(rng.integers(1, 90))
    sa = None if not ages else rng.integers(0, 300, N).astype(np.float64)
    return (JAncesTree(N=N, seq=jseq, sample_ages=sa),
            AncesTree(N=N, seq=tseq, sample_ages=sa))


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native_writer", "python_writer"])
@pytest.mark.parametrize("N,T,ages", [(4, 1, False), (9, 5, False),
                                      (16, 3, True)])
def test_anc_text_is_byte_equal_and_round_trips(tmp_path, N, T, ages,
                                                use_native):
    janc, tanc = _ancestree(N, T, seed=N + T, ages=ages)
    pj, pt = str(tmp_path / "j.anc"), str(tmp_path / "t.anc")
    jam.write_anc_text(pj, janc, use_native=use_native)
    tam.write_anc_text(pt, tanc)
    assert filecmp.cmp(pj, pt, shallow=False)
    got = tam.read_anc_text(pt)
    want = jam.read_anc_text(pj)
    assert got.N == want.N == N and len(got.seq) == len(want.seq) == T
    if ages:
        np.testing.assert_array_equal(got.sample_ages, want.sample_ages)
    else:
        assert got.sample_ages is None
    for g, w, src in zip(got.seq, want.seq, tanc.seq):
        assert g.pos == w.pos == src.pos
        for f in ("parent", "child_left", "child_right", "branch_length",
                  "num_events", "SNP_begin", "SNP_end"):
            a, b = getattr(g.tree, f), getattr(w.tree, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        np.testing.assert_array_equal(g.tree.parent, src.tree.parent)
        np.testing.assert_allclose(g.tree.branch_length,
                                   src.tree.branch_length, rtol=0,
                                   atol=0.5e-5)       # %.5f
    # what was read writes the same bytes again, and num_trees overrides
    tam.write_anc_text(pt + "2", got)
    assert filecmp.cmp(pt, pt + "2", shallow=False)
    tam.write_anc_text(pt + "3", tanc, num_trees=77)
    with open(pt + "3") as f:
        assert f.readlines()[1] == "NUM_TREES 77\n"
    assert tam._fmt_g5(1.0) == jam._fmt_g5(1.0) == "1.00000"


def test_anc_tree_line_and_reader_errors(tmp_path):
    janc, tanc = _ancestree(6, 2, seed=1, ages=False)
    pj, pt = tmp_path / "j.txt", tmp_path / "t.txt"
    with open(pj, "w") as f:
        jam.write_anc_tree_line(f, janc.seq[1])
    with open(pt, "w") as f:
        tam.write_anc_tree_line(f, tanc.seq[1])
    assert pj.read_text() == pt.read_text()
    bad = tmp_path / "bad.anc"
    bad.write_text("NUM_HAPLOTYPES 6\nNUM_TREES 1\n" + pt.read_text()[:-40]
                   + "\n")
    with pytest.raises(ValueError, match="fields"):
        tam.read_anc_text(str(bad))
    bad.write_text("NUM_HAPLOTYPES 6\nNUM_TREES 3\n" + pt.read_text())
    with pytest.raises(ValueError, match="header says"):
        tam.read_anc_text(str(bad))


@pytest.mark.parametrize("extra", ["", "upstream_allele;downstream_allele;"])
def test_mut_final_is_byte_equal_and_round_trips(tmp_path, extra):
    rng = np.random.default_rng(3)
    rows = []
    for snp in range(40):
        br = " ".join(str(b) for b in rng.integers(0, 30, rng.integers(0, 3)))
        a = float(rng.random() * 10.0 ** rng.integers(-3, 7))
        rows.append(
            f"{snp};{1000 + 7 * snp};{int(rng.integers(1, 900))};rs{snp};"
            f"{snp // 9};{br};{int(' ' in br)};{int(rng.random() < 0.1)};"
            f"{tam._fmt_g(a)};{tam._fmt_g(a * 1.5)};A/G;"
            + ("C;T;" if extra else ""))
    pj, pt = str(tmp_path / "j.mut"), str(tmp_path / "t.mut")
    jam.write_mut_final(pj, rows, extra_header=extra)
    tam.write_mut_final(pt, rows, extra_header=extra)
    assert filecmp.cmp(pj, pt, shallow=False)
    assert tam.FINAL_MUT_HEADER == jam.FINAL_MUT_HEADER
    got, want = tam.read_mut_final(pt), jam.read_mut_final(pj)
    assert got == want and len(got) == 40
    assert got[5]["snp"] == 5 and got[5]["pos"] == 1035
    assert got[5]["alleles"] == "A/G"
    assert all(g["age_begin"] <= g["age_end"] for g in got)
