"""Tree importers of the port (``relate_tpu_torch/io/importers.py``) and
Extract's ConvertNewickToTimeb: the twins of tests/test_importers.py, and
every importer against the JAX package's on the same text (the golden
trees, N = 8, as Newick; a RENT+ file, an ARGweaver ``.smc`` and an msprime
text export), which must give equal trees. A caterpillar of 2,048 leaves
(Newick nested 2,047 deep) reads without recursion."""
import numpy as np
import pytest

from relate_tpu.io import extract as jext
from relate_tpu.io import importers as jimp
from relate_tpu_torch.core.trees import Tree
from relate_tpu_torch.io import extract as text
from relate_tpu_torch.io import importers as timp
from relate_tpu_torch.pipeline import scripts as tscripts

FIELDS = ("parent", "child_left", "child_right", "branch_length")


def _tree():
    return Tree(parent=np.asarray([3, 3, 4, 4, -1], np.int32),
                child_left=np.asarray([-1, -1, -1, 0, 3], np.int32),
                child_right=np.asarray([-1, -1, -1, 1, 2], np.int32),
                branch_length=np.asarray([1.5, 1.5, 3.25, 1.75, 0.]))


def _same_topology(a: Tree, b: Tree):
    def clades(t):
        cl = []
        for v in range(t.N, t.num_nodes):
            stack, leaves = [v], []
            while stack:
                u = stack.pop()
                if u < t.N:
                    leaves.append(u)
                else:
                    stack += [int(t.child_left[u]), int(t.child_right[u])]
            cl.append(frozenset(leaves))
        return set(cl)
    return clades(a) == clades(b)


def _same_trees(a, b):
    assert a.N == b.N and len(a.seq) == len(b.seq)
    for x, y in zip(a.seq, b.seq):
        assert x.pos == y.pos
        for f in FIELDS:
            u, v = getattr(x.tree, f), getattr(y.tree, f)
            assert u.dtype == v.dtype and np.array_equal(u, v), f


def test_newick_roundtrip(tmp_path):
    t = _tree()
    p = tmp_path / "t.newick"
    p.write_text(f"0 {t.to_newick()}\n10 {t.to_newick()}\n")
    anc = timp.read_newick(str(p), Ne=2.0)
    assert anc.N == 3 and len(anc.seq) == 2
    got = anc.seq[0].tree
    assert _same_topology(t, got)
    np.testing.assert_allclose(sorted(got.branch_length[:2]), [3.0, 3.0])
    assert anc.seq[1].pos == 10
    _same_trees(anc, jimp.read_newick(str(p), Ne=2.0))


def test_rent_one_based(tmp_path):
    p = tmp_path / "t.trees"
    p.write_text("55 ((1:1.50000,2:1.50000):1.75000,3:3.25000);\n")
    anc = timp.read_rent(str(p), Ne=1.0)
    assert anc.N == 3
    assert anc.seq[0].pos == 55
    assert _same_topology(_tree(), anc.seq[0].tree)
    _same_trees(anc, jimp.read_rent(str(p), Ne=1.0))


def test_argweaver_smc(tmp_path):
    smc = ("NAMES\t1\t2\t3\n"
           "REGION\tchr\t1\t1000\n"
           "TREE\t1\t400\t((0:1.5[&&NHX:age=0],1:1.5[&&NHX:age=0])"
           "3:1.75[&&NHX:age=0],2:3.25[&&NHX:age=0])4[&&NHX:age=0];\n"
           "TREE\t401\t1000\t((2:1.5[&&NHX:age=0],1:1.5[&&NHX:age=0])"
           "3:1.75[&&NHX:age=0],0:3.25[&&NHX:age=0])4[&&NHX:age=0];\n")
    p = tmp_path / "t.smc"
    p.write_text(smc)
    anc = timp.read_argweaver_smc(str(p))
    assert anc.N == 3 and len(anc.seq) == 2
    assert _same_topology(_tree(), anc.seq[0].tree)
    assert anc.seq[1].pos == 401
    _same_trees(anc, jimp.read_argweaver_smc(str(p)))


def test_msprime_text(tmp_path):
    # node lines: "v cl cr bl_l bl_r"; arbitrary internal numbering
    txt = ("#msprime\n3 2\n123\n0\n1\n2\n4 1 2 1.5 3.25\n3 0 4 3.0 1.75\n"
           "200\n0\n1\n2\n3 0 1 1.0 1.0\n4 3 2 2.0 3.0\n")
    p = tmp_path / "t.txt"
    p.write_text(txt)
    anc = timp.read_msprime(str(p))
    t = anc.seq[0].tree
    assert anc.seq[0].pos == 123 and anc.seq[1].pos == 200
    assert t.root == t.num_nodes - 1
    assert t.parent[t.root] == -1
    for v in range(t.num_nodes - 1):
        assert t.parent[v] >= 0
    _same_trees(anc, jimp.read_msprime(str(p)))


def test_convert_newick_to_timeb(tmp_path):
    t = _tree()
    p = tmp_path / "s.newick"
    p.write_text((t.to_newick() + "\n") * 3)
    for name, ext in (("port", text), ("jax", jext)):
        ext.convert_newick_to_timeb(str(p), str(tmp_path / f"{name}.timeb"))
    out = str(tmp_path / "port.timeb")
    hdr = np.fromfile(out, dtype=np.int32, count=3)
    assert list(hdr) == [3, 1, 5]
    ages = np.fromfile(out, dtype=np.float32, offset=12).reshape(3, 5)
    assert (ages[:, 3:] > 0).all()
    assert open(out, "rb").read() == \
        open(tmp_path / "jax.timeb", "rb").read()


@pytest.fixture(scope="module")
def golden_newick(golden_dir, tmp_path_factory):
    """``pos newick`` lines of the first 400 golden trees, and the trees."""
    anc = tscripts._load_pair(str(golden_dir / "golden"))[0]
    seq = anc.seq[:400]
    p = tmp_path_factory.mktemp("nw") / "golden.newick"
    p.write_text("".join(f"{mt.pos} {mt.tree.to_newick()}\n" for mt in seq))
    return p, seq


def test_golden_newick_both_packages(golden_newick):
    p, seq = golden_newick
    got = timp.read_newick(str(p))
    _same_trees(got, jimp.read_newick(str(p)))
    for mt, back in zip(seq, got.seq):
        assert back.pos == mt.pos
        assert _same_topology(mt.tree, back.tree)
        c0, c1 = mt.tree.coordinates(), back.tree.coordinates()
        assert abs(np.sort(c0[8:]) - np.sort(c1[8:])).max() < 5e-5


def _caterpillar(n):
    """(((0:1,1:1):1,2:2):1, ...) nested n - 1 deep."""
    s = "0:1.0"
    for i in range(1, n):
        s = f"({s},{i}:{float(i)}):1.0"
    return s[: -len(":1.0")] + ";"


def test_deep_caterpillar(tmp_path):
    n = 2048
    nw = _caterpillar(n)
    assert nw.count("(") == n - 1
    t = timp.newick_to_tree(nw)
    assert t.N == n and t.root == 2 * n - 2
    assert t.parent[0] == t.parent[1] == n
    assert (t.parent[n: -1] == np.arange(n + 1, 2 * n - 1)).all()
    assert t.coordinates()[-1] == n - 1.0
    want = jimp.newick_to_tree(nw)
    for f in FIELDS:
        assert np.array_equal(getattr(t, f), getattr(want, f)), f
    (tmp_path / "c.newick").write_text(f"7 {nw}\n")
    anc = timp.read_newick(str(tmp_path / "c.newick"))
    assert anc.seq[0].pos == 7 and anc.N == n


@pytest.mark.parametrize("bad", ["((0:1,1:1):1,2:1", "(0:1,1:1):", "(0:1;1)"])
def test_malformed_newick_raises(bad):
    with pytest.raises(ValueError):
        timp.newick_to_tree(bad)


def test_non_binary_newick_raises():
    with pytest.raises(ValueError, match="binary"):
        timp.newick_to_tree("(0:1,1:1,2:1);")
