"""The port against the C++ reference's own stage outputs in
``tests/golden`` (the bundled example, N = 8), with the port's readers of
the reference's files (``io/ancmut.py``, ``io/chunking.py:
read_reference_chunk`` / ``read_reference_parameters``, ``io/refpaint.py``)
and ``device="cpu"``:

- FindEquivalentBranches on the reference's BuildTopology output
  ``postbt_0.anc`` writes its ``postfeb_0.anc`` byte for byte;
- BuildTopology over SNPs 0-12,000 of the golden chunk, the twin of
  ``test_e2e_golden.py::test_buildtopology_matches_reference`` with its
  bounds (tree ratio 0.92-1.08, clade agreement >= 0.78);
- multi-window Paint over ``tests/golden/mw`` against the reference's four
  paint files, the twin of
  ``test_chunking.py::test_stepping_stones_match_reference_interior`` with
  its bounds."""
import gzip
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from relate_tpu_torch.core import painting, topology_device
from relate_tpu_torch.core.branch_association import associate_trees
from relate_tpu_torch.core.branch_association_device import \
    branch_association_many_device
from relate_tpu_torch.io import ancmut, chunking, refpaint

torch.set_num_threads(1)

E_SUB = 12000          # subrange of section 0 (as the JAX test)
MARGIN = 500           # trees straddling the cut are not compared


@pytest.mark.golden
def test_find_equivalent_branches_writes_the_reference_bytes(golden_dir,
                                                             tmp_path):
    anc = ancmut.read_anc_bin(str(golden_dir / "postbt_0.anc"))
    assert anc.N == 8 and len(anc.seq) > 9000
    trees = [mt.tree for mt in anc.seq]
    associate_trees(trees, branch_association_many_device(trees,
                                                          device="cpu"))
    out = tmp_path / "feb.anc"
    ancmut.write_anc_bin(str(out), anc)
    assert out.read_bytes() == (golden_dir / "postfeb_0.anc").read_bytes()


def _clade_sets(anc, muts, lo, hi):
    """snp -> frozenset of the carriers of its mapped branch."""
    out = {}
    leafmats = {}
    for snp in range(lo, hi):
        m = muts[snp]
        if len(m.branch) != 1:
            continue
        t = m.tree
        if t not in leafmats:
            leafmats[t] = anc.seq[t].tree.leaf_matrix().astype(bool)
        out[snp] = frozenset(np.nonzero(leafmats[t][int(m.branch[0])])[0])
    return out


@pytest.mark.golden
def test_build_topology_matches_reference(golden_dir):
    ch = chunking.read_reference_chunk(str(golden_dir / "chunk_0"))
    ref_anc = ancmut.read_anc_bin(str(golden_dir / "postbt_0.anc"))
    ref_muts = ancmut.read_mut_short(str(golden_dir / "postbt_0.mut"))
    N = ch.G.shape[1]
    painter = painting.Painter(ch.G, ch.r,
                               painting.PaintingModel(N=N, theta=0.001),
                               device="cpu")
    cps = painter.paint_stepping_stones(np.asarray([0, ch.G.shape[0]]))
    res = topology_device.build_topology_section_device(
        painter, cps[0], ch.G, ch.rpos, ch.state, ch.bp, 0, E_SUB, seed=1)
    hi = E_SUB - MARGIN
    ours_trees = sum(1 for mt in res.anc.seq if mt.pos < hi)
    ref_trees = sum(1 for mt in ref_anc.seq if mt.pos < hi)
    assert ref_trees > 10
    assert 0.92 <= ours_trees / ref_trees <= 1.08, (ours_trees, ref_trees)
    ours = _clade_sets(res.anc, res.muts, 0, hi)
    ref = _clade_sets(ref_anc, ref_muts, 0, hi)
    common = set(ours) & set(ref)
    assert len(common) > 0.8 * hi
    agree = sum(1 for s in common if ours[s] == ref[s]) / len(common)
    assert agree >= 0.78, f"clade agreement {agree:.3f}"


@pytest.fixture(scope="module")
def mw_dir(tmp_path_factory):
    src = Path(__file__).parent / "golden" / "mw"
    if not src.exists():
        pytest.skip("mw golden fixtures absent")
    out = tmp_path_factory.mktemp("mw")
    for p in src.iterdir():
        if p.suffix == ".gz":
            with gzip.open(p, "rb") as a, open(out / p.stem, "wb") as b:
                shutil.copyfileobj(a, b)
        else:
            shutil.copy(p, out / p.name)
    return out


@pytest.mark.golden
def test_reference_parameters(mw_dir):
    """The reference's plan files, read by the port as by the JAX
    package."""
    from relate_tpu.io import chunking as jchunking
    whole = chunking.read_reference_parameters(str(mw_dir / "parameters.bin"))
    assert whole == jchunking.read_reference_parameters(
        str(mw_dir / "parameters.bin"))
    assert whole["N"] == 8 and whole["L"] == 130862
    assert whole["num_chunks"] == 5 == len(whole["start"]) == \
        len(whole["end"])
    assert whole["end"][-1] == whole["L"]
    for c, windows in ((0, 4), (1, 7)):
        path = str(mw_dir / f"parameters_c{c}.bin")
        p = chunking.read_reference_parameters(path)
        assert p == jchunking.read_reference_parameters(path)
        b = p["boundaries"]
        assert p["num_windows"] == windows == len(b) - 1
        assert b[0] == 0 and b[-1] == p["L_chunk"] and b == sorted(b)
        assert p["L_chunk"] == whole["end"][c] - whole["start"][c]


@pytest.mark.golden
def test_stepping_stones_match_reference_interior(mw_dir):
    """Interior stepping-stone checkpoints vs the reference's paint files,
    within its lossy RLE codec (1e-3 relative runs) and the float32 against
    double logscale paths."""
    ch = chunking.read_reference_chunk(str(mw_dir / "chunk_0"))
    refc0 = chunking.read_reference_parameters(
        str(mw_dir / "parameters_c0.bin"))
    bounds = np.array(refc0["boundaries"])
    painter = painting.Painter(ch.G, ch.r,
                               painting.PaintingModel(N=ch.N, theta=0.001),
                               device="cpu")
    cps = painter.paint_stepping_stones(bounds)
    assert len(cps) == refc0["num_windows"] == 4
    for w in range(len(cps)):
        recs = refpaint.read_paint_file(str(mw_dir / f"relate_{w}.bin"), ch.N)
        for n, rec in enumerate(recs):
            assert rec.bsb == cps[w].bsb[n]
            assert rec.bse == cps[w].bse[n]
            am = max(rec.alpha.max(), 1e-30)
            bm = max(rec.beta.max(), 1e-30)
            assert np.abs(cps[w].alpha[n] - rec.alpha).max() / am < 2e-3
            assert np.abs(cps[w].beta[n] - rec.beta).max() / bm < 2e-3
            assert abs(cps[w].ls_alpha[n] - rec.ls_alpha) < 1.0
            assert abs(cps[w].ls_beta[n] - rec.ls_beta) < 1.0
