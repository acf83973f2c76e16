"""TreeView's functions in the port (``relate_tpu_torch/io/treeview.py``)
against the JAX package's on the golden trees (N = 8, with and without
sample ages): layouts, the tree at a position, mutations on branches,
branches below a mutation and the ``.coords`` file must be equal; and the
layout of a caterpillar of 2,048 leaves, which the port walks without
recursion."""
import numpy as np
import pytest

from relate_tpu.io import treeview as jtv
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.io import importers as timp
from relate_tpu_torch.io import treeview as ttv
from relate_tpu_torch.pipeline import scripts as tscripts

AGES = np.asarray([0, 0, 0, 0, 0, 150.0, 900.0, 4000.0])
TREES = (0, 1, 17, 400, 2500)


@pytest.fixture(scope="module")
def pairs(golden_dir):
    return {name: scripts._load_pair(str(golden_dir / "golden"))
            for name, scripts in (("jax", jscripts), ("port", tscripts))}


@pytest.mark.parametrize("ages", [None, AGES])
def test_layouts(pairs, ages):
    for t in TREES:
        got = ttv.tree_layout(pairs["port"][0].seq[t].tree, ages)
        want = jtv.tree_layout(pairs["jax"][0].seq[t].tree, ages)
        for k in ("x", "y", "parent"):
            assert np.array_equal(got[k], want[k]), (t, k)
        assert sorted(got["x"][:8]) == list(range(8))


def test_tree_at_bp_and_mutations(pairs):
    anc, recs, bp = pairs["port"][:3]
    janc, jrecs = pairs["jax"][:2]
    for pos in (0, bp[0], bp[1234], bp[5000] + 1, bp[-1], bp[-1] + 10):
        t = ttv.tree_at_bp(anc, recs, bp, pos)
        assert t == jtv.tree_at_bp(janc, jrecs, bp, pos)
        got = ttv.mutations_on_branches(anc, recs, t)
        assert got == jtv.mutations_on_branches(janc, jrecs, t)
    assert ttv.mutations_on_branches(anc, recs, 400)


def test_branches_below_mutation(pairs):
    anc, recs = pairs["port"][:2]
    janc, jrecs = pairs["jax"][:2]
    seen = 0
    for snp in range(0, 3000, 7):
        got = ttv.branches_below_mutation(anc, recs, snp)
        assert got == list(jtv.branches_below_mutation(janc, jrecs, snp))
        seen += len(got) > 1
    assert seen > 10


@pytest.mark.parametrize("ages", [False, True])
def test_plot_coords_file(pairs, tmp_path, ages):
    for name, tv in (("port", ttv), ("jax", jtv)):
        anc, recs = pairs[name][:2]
        anc.sample_ages = AGES if ages else None
        for t in (3, 900):
            tv.write_plot_coords(str(tmp_path / f"{name}_{t}.coords"), anc,
                                 recs, t)
        anc.sample_ages = None
    for t in (3, 900):
        got = (tmp_path / f"port_{t}.coords").read_text()
        assert got == (tmp_path / f"jax_{t}.coords").read_text()
        assert len(got.splitlines()) == 1 + 15


def test_render_needs_matplotlib(pairs, tmp_path):
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError, match="matplotlib"):
            ttv.render_tree(pairs["port"][0].seq[0].tree,
                            str(tmp_path / "t.png"))
        return
    ttv.render_tree(pairs["port"][0].seq[0].tree, str(tmp_path / "t.png"))
    assert (tmp_path / "t.png").stat().st_size > 0


def test_caterpillar_layout():
    n = 2048
    s = "0:1.0"
    for i in range(1, n):
        s = f"({s},{i}:{float(i)}):1.0"
    tree = timp.newick_to_tree(s[: -len(":1.0")] + ";")
    lay = ttv.tree_layout(tree)
    assert np.array_equal(lay["x"][:n], np.arange(n))
    assert lay["y"][-1] == n - 1
    # node n + k joins leaf k + 1 to the chain below it
    x = lay["x"]
    assert x[n] == 0.5 and x[n + 1] == 0.5 * (0.5 + 2.0)
