"""PostProcess and OptimizeParameters of the port
(``relate_tpu_torch/pipeline/postprocess.py``, ``pipeline/relate.py``)
against the JAX package's, on ``device="cpu"``.

Tolerance: equality everywhere. The clade scores are integers and the
distances float64 in both packages (the port sums carrier counts from one
product per tree, the JAX package sums a boolean block per clade); trees,
records and the fractions of OptimizeParameters are discrete. The JAX
``quick_build`` breaks ties with threefry; inside the OptimizeParameters
test it is replaced by the JAX Pallas merge scan in interpret mode, which
has the port's tie hash (``pallas_scan`` of ``test_torch_treebuilder.py``).

Against the reference binary: ``tests/golden/pp_golden.{anc,mut}`` is
``Relate --mode PostProcess`` on ``golden.{anc,mut}``; the port must
rearrange nodes, keep the tree count and map the SNPs onto the clades the
reference maps them onto (agreement >= 0.90, the JAX package's gate).
"""
import filecmp
import shutil

import numpy as np
import pytest
import torch

from relate_tpu.io import ancmut as jancmut
from relate_tpu.io.chunking import ArtifactStore as JaxStore
from relate_tpu.pipeline import postprocess as jpp
from relate_tpu.pipeline import relate as jrelate
from relate_tpu_torch.core.topology import MutationRecord
from relate_tpu_torch.io import ancmut as tancmut
from relate_tpu_torch.io import chunking as tchunking
from relate_tpu_torch.io.chunking import ArtifactStore
from relate_tpu_torch.pipeline import postprocess as tpp
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.utils import synth as tsynth
from relate_tpu_torch.utils import trace as ttrace
from test_torch_treebuilder import pallas_scan

torch.set_num_threads(1)

THETA = 0.001


# ---------------------------------------------------------------------------
# the clade scores
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("N", [8, 33, 64])
@pytest.mark.parametrize("thr", ["one", "rule", "five"])
def test_map_scores_from_column_sums_match_jax(N, thr):
    """The port's scores from carrier counts equal the JAX module's from
    the boolean block, for clades of 1 to N - 1 leaves and SNPs whose
    carriers are those clades with a few haplotypes moved in or out (so
    that exact, approximate and missing support all occur), DAF < 4 and
    >= 4, at thr = 1, the module's rule 0.03 N + 1, and 5."""
    thr = {"one": 1, "rule": int(0.03 * N) + 1, "five": 5}[thr]
    rng = np.random.default_rng(N * 7 + thr)
    sizes = np.unique(np.r_[1, 2, 3, 4, 5, N // 2, N - 2, N - 1])
    clades = np.zeros((len(sizes), N), dtype=bool)
    for k, s in enumerate(sizes):
        clades[k, rng.choice(N, s, replace=False)] = True
    rows = []
    for c in clades:
        for moved in (0, 1, 2, 3):
            r = c.copy()
            r[rng.choice(N, moved, replace=False)] ^= True
            rows.append(r)
    rows += list(rng.random((40, N)) < rng.random((40, 1)))
    block = np.array(rows)
    block = block[(block.sum(axis=1) > 0)]
    daf = block.sum(axis=1).astype(np.int64)
    assert (daf < 4).any() and (daf >= 4).any()
    matching = torch.from_numpy(
        block.astype(np.int64) @ clades.T.astype(np.int64))
    got = tpp._map_scores(matching, torch.from_numpy(clades.sum(axis=1)),
                          torch.from_numpy(daf), thr, N).numpy()
    want = np.stack([jpp._map_scores(block, daf, c, thr, N) for c in clades],
                    axis=1)
    assert np.array_equal(got, want)
    assert (want == 0).any() and (want == thr).any()
    if thr > 1:
        assert ((want > 0) & (want < thr)).any()


# ---------------------------------------------------------------------------
# post_process on tree sequences the port's pipeline built
# ---------------------------------------------------------------------------

def _built_store(tmp, N, L, seed, memory_gb, noise=0.02):
    """MakeChunks -> Paint -> BuildTopology -> FindEquivalentBranches of the
    port on a synthetic panel with a few genotypes flipped."""
    G, bp = tsynth.synth_coalescent_panel(N, L, seed=seed)[:2]
    rng = np.random.default_rng(seed)
    G = np.where(rng.random(G.shape) < noise, 1 - G, G).astype(np.uint8)
    prefix = str(tmp / "panel")
    tsynth.write_haps_sample(G, bp, prefix)
    tsynth.write_flat_map(str(tmp / "map.txt"), int(bp[-1]))
    out = str(tmp / "store")
    trelate.make_chunks(prefix + ".haps", prefix + ".sample",
                        str(tmp / "map.txt"), out, memory_gb=memory_gb,
                        device="cpu")
    store = ArtifactStore(out)
    trelate.paint(store, 0, theta=THETA, device="cpu")
    trelate.build_topology(store, 0, seed=1, theta=THETA, device="cpu")
    trelate.find_equivalent_branches(store, 0, device="cpu")
    return store


def _same_sequences(aj, mj, at, mt):
    assert len(aj.seq) == len(at.seq)
    for a, b in zip(aj.seq, at.seq):
        assert a.pos == b.pos
        for f in ("parent", "child_left", "child_right", "branch_length",
                  "num_events", "SNP_begin", "SNP_end"):
            assert np.array_equal(getattr(a.tree, f), getattr(b.tree, f)), f
    assert len(mj) == len(mt)
    for a, b in zip(mj, mt):
        assert (a.tree, list(a.branch), a.flipped, a.age_begin, a.age_end) \
            == (b.tree, list(b.branch), b.flipped, b.age_begin, b.age_end)


@pytest.fixture(scope="module")
def one_window(tmp_path_factory):
    return {(N, L): _built_store(tmp_path_factory.mktemp(f"pp{N}"), N, L, 3,
                                 1.0)
            for N, L in ((16, 300), (48, 400))}


@pytest.mark.parametrize("N,L,spacing", [(16, 300, 1), (48, 400, 1),
                                         (48, 400, 400)],
                         ids=["n16", "n48", "n48-wide"])
@pytest.mark.parametrize("randomise", [False, True],
                         ids=["nni", "randomise"])
def test_post_process_matches_jax(one_window, N, L, spacing, randomise):
    """One window's trees and records after FindEquivalentBranches, post-
    processed by both packages: equal rearranged counts, parents, children,
    branch lengths, events, spans and records. ``wide`` spreads the SNPs
    200 kb apart, so that the 10 Mb support window holds about 50 of them
    and the nodes without exact support take the approximate fallback
    (N = 48: thr = 2)."""
    store = one_window[(N, L)]
    ch = store.load_chunk(0)
    assert ch.windows.num_windows == 1 and ch.N == N
    bp = ch.bp * spacing
    files = (store.path("chunk_0", "trees_0.anc"),
             store.path("chunk_0", "muts_0.mut"))
    aj, mj = jancmut.read_anc_bin(files[0]), jancmut.read_mut_short(files[1])
    at, mt = tancmut.read_anc_bin(files[0]), tancmut.read_mut_short(files[1])
    nj = jpp.post_process(aj, mj, ch.G, bp, seed=4, randomise=randomise)
    with ttrace.stage("post_process", verbose=False):
        nt = tpp.post_process(at, mt, ch.G, bp, seed=4, randomise=randomise,
                              device="cpu")
    (stats,) = ttrace.STAGES[-1]["postprocess"]
    assert nj == nt > 0
    assert stats["nodes_rearranged"] == nt and stats["trees"] == len(at.seq)
    assert stats["batches"] >= stats["sweeps"] >= len(at.seq)
    # with unscaled positions every node finds exact support within 10 Mb
    assert (stats["fallback_nodes"] > 0) == (spacing > 1)
    _same_sequences(aj, mj, at, mt)


def test_fallback_is_taken_where_no_exact_support_is_near(one_window,
                                                         monkeypatch):
    """The ``wide`` case above reaches the approximate fallback (the only
    caller of ``_nearest`` with an infinite default)."""
    store = one_window[(48, 400)]
    ch = store.load_chunk(0)
    anc = tancmut.read_anc_bin(store.path("chunk_0", "trees_0.anc"))
    muts = tancmut.read_mut_short(store.path("chunk_0", "muts_0.mut"))
    seen = []
    real = tpp._nearest

    def spy(dist, mask, default):
        seen.append(default)
        return real(dist, mask, default)
    monkeypatch.setattr(tpp, "_nearest", spy)
    tpp.post_process(anc, muts, ch.G, ch.bp * 400, device="cpu")
    assert float("inf") in seen


# ---------------------------------------------------------------------------
# the reference binary's own PostProcess output
# ---------------------------------------------------------------------------

@pytest.mark.golden
def test_post_process_matches_reference(golden_dir):
    """PostProcess of the port on the reference's final ``golden.anc/.mut``
    (8 haplotypes, 130,862 SNPs, 9,412 trees), with the genotypes of the
    reference's chunk file, against the reference binary's
    ``pp_golden.anc/.mut``: the same tree count, nodes rearranged, and the
    SNPs that both map to one branch on the same clade (>= 0.90)."""
    ch = tchunking.read_reference_chunk(str(golden_dir / "chunk_0"))
    anc = tancmut.read_anc_text(str(golden_dir / "golden.anc"))
    rows = tancmut.read_mut_final(str(golden_dir / "golden.mut"))
    recs = [MutationRecord(tree=m["tree"], branch=m["branch"],
                           flipped=bool(m["flipped"]),
                           age_begin=m["age_begin"], age_end=m["age_end"])
            for m in rows]
    bp = np.asarray([m["pos"] for m in rows])
    assert ch.G.shape == (len(recs), anc.N) and np.array_equal(bp, ch.bp)
    n_up = tpp.post_process(anc, recs, ch.G, bp, seed=1, device="cpu")
    assert n_up > 0

    ref_anc = tancmut.read_anc_text(str(golden_dir / "pp_golden.anc"))
    ref_rows = tancmut.read_mut_final(str(golden_dir / "pp_golden.mut"))
    assert len(ref_anc.seq) == len(anc.seq) == 9412

    def clades(anc, placed):
        out, mats = {}, {}
        for snp, tree, branch in placed:
            if len(branch) != 1:
                continue
            if tree not in mats:
                mats[tree] = anc.seq[tree].tree.leaf_matrix().astype(bool)
            out[snp] = frozenset(np.nonzero(mats[tree][branch[0]])[0])
        return out
    ours = clades(anc, [(s, m.tree, m.branch) for s, m in enumerate(recs)])
    ref = clades(ref_anc, [(m["snp"], m["tree"], m["branch"])
                           for m in ref_rows])
    common = set(ours) & set(ref)
    assert len(common) > 0.9 * len(recs)
    agree = sum(1 for s in common if ours[s] == ref[s]) / len(common)
    assert agree >= 0.90, f"post-process clade agreement {agree:.3f}"


# ---------------------------------------------------------------------------
# post_process_chunk: every window with its own SNPs
# ---------------------------------------------------------------------------

def _leaf_sets(anc, muts):
    """(record index, leaf set of its branch, flipped) of every record
    mapped to one branch."""
    mats = {}
    for i, m in enumerate(muts):
        if len(m.branch) == 1:
            if m.tree not in mats:
                mats[m.tree] = anc.seq[m.tree].tree.leaf_matrix().astype(bool)
            yield i, mats[m.tree][m.branch[0]], m.flipped


def _misplaced(store, w, start):
    """Records of window ``w`` whose one branch is not exactly the carriers
    of their own SNP (or, flipped, the non-carriers)."""
    ch = store.load_chunk(0)
    anc = tancmut.read_anc_bin(store.path("chunk_0", f"trees_{w}.anc"))
    muts = tancmut.read_mut_short(store.path("chunk_0", f"muts_{w}.mut"))
    bad = 0
    for i, leaves, flipped in _leaf_sets(anc, muts):
        carriers = ch.G[start + i] == 1
        bad += not np.array_equal(leaves, ~carriers if flipped else carriers)
    return bad, len(muts)


@pytest.fixture(scope="module")
def two_windows(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_windows")
    return tmp, _built_store(tmp, 16, 300, 5, 6e-5, noise=0.01)


def test_post_process_chunk_maps_each_window_with_its_own_snps(two_windows):
    """Two windows at N = 16 (where the mapper's 0.03 N mismatches allow
    none, so a record on one branch is an exact mapping). The port's
    ``post_process_chunk`` maps record i of window w with SNP start_w + i:
    every one-branch record of window 1 holds its own SNP's carriers
    exactly. The JAX package's ``post_process_chunk``
    (``relate_tpu/pipeline/relate.py``) passes a window's records with the
    whole chunk's genotypes and no offset, so from window 1 on it maps record i with SNP
    i, ``start`` rows too early, and ends the window's last tree at the
    chunk's last SNP: on its output window 1 has records that do not hold
    their SNP. Window 0 (offset 0) is the same in both, but for that last
    tree's end."""
    tmp, built = two_windows
    ch = built.load_chunk(0)
    bounds = ch.windows.boundaries
    assert ch.windows.num_windows == 2
    port = ArtifactStore(str(tmp / "port"))
    shutil.copytree(built.outdir, port.outdir)
    jax = JaxStore(str(tmp / "jax"))
    shutil.copytree(built.outdir, jax.outdir)
    assert trelate.post_process_chunk(port, 0, seed=2, device="cpu") == \
        jrelate.post_process_chunk(jax, 0, seed=2) > 0

    bad, n = _misplaced(port, 1, bounds[1])
    assert n == bounds[2] - bounds[1] and bad == 0
    assert _misplaced(port, 0, 0) == (0, bounds[1])
    jbad, _ = _misplaced(jax, 1, bounds[1])
    assert jbad > 0

    for w, last in ((0, bounds[1] - 1), (1, ch.L - 1)):
        at = tancmut.read_anc_bin(port.path("chunk_0", f"trees_{w}.anc"))
        assert (at.seq[-1].tree.SNP_end == last).all()
    aj = jancmut.read_anc_bin(jax.path("chunk_0", "trees_0.anc"))
    at = tancmut.read_anc_bin(port.path("chunk_0", "trees_0.anc"))
    assert (aj.seq[-1].tree.SNP_end == ch.L - 1).all()
    aj.seq[-1].tree.SNP_end[:] = bounds[1] - 1
    _same_sequences(aj, jancmut.read_mut_short(jax.path("chunk_0",
                                                        "muts_0.mut")),
                    at, tancmut.read_mut_short(port.path("chunk_0",
                                                         "muts_0.mut")))


@pytest.mark.parametrize("buf", [16, 60], ids=["buf16", "buf60"])
def test_upload_holds_only_the_rows_the_trees_reach(two_windows, monkeypatch,
                                                    buf):
    """Window 1 of the two-window store with a support window of ``buf``
    eligible SNPs: the port uploads only the rows from BUF/2 before its
    first tree's position to BUF/2 after its last one's, which starts past
    the chunk's first eligible row, and every tree's slice is offset by it.
    The topologies, branch lengths and tree starts equal the JAX module's
    with the same BUF on the same records (equality). Events and records
    are not compared: the JAX module maps them with the SNPs ``start`` rows
    too early (see the test above)."""
    _, store = two_windows
    ch = store.load_chunk(0)
    start = int(ch.windows.boundaries[1])
    files = (store.path("chunk_0", "trees_1.anc"),
             store.path("chunk_0", "muts_1.mut"))
    aj, mj = jancmut.read_anc_bin(files[0]), jancmut.read_mut_short(files[1])
    at, mt = tancmut.read_anc_bin(files[0]), tancmut.read_mut_short(files[1])
    monkeypatch.setattr(jpp, "BUF", buf)
    monkeypatch.setattr(tpp, "BUF", buf)
    elig = np.nonzero(ch.G.sum(axis=1) > 1)[0]
    rank = np.searchsorted(elig, [t.pos for t in at.seq])
    lo = max(rank[0] - buf // 2, 0)
    hi = min(rank[-1] + buf // 2, len(elig))
    assert 0 < lo and hi - lo < len(elig)
    nj = jpp.post_process(aj, mj, ch.G, ch.bp, seed=4)
    with ttrace.stage("post_process", verbose=False):
        nt = tpp.post_process(at, mt, ch.G, ch.bp, seed=4, first_snp=start,
                              device="cpu")
    (stats,) = ttrace.STAGES[-1]["postprocess"]
    assert stats["uploaded_rows"] == hi - lo
    assert nj == nt > 0
    assert len(aj.seq) == len(at.seq)
    for a, b in zip(aj.seq, at.seq):
        assert a.pos == b.pos
        for f in ("parent", "child_left", "child_right", "branch_length",
                  "SNP_begin"):
            assert np.array_equal(getattr(a.tree, f), getattr(b.tree, f)), f


# ---------------------------------------------------------------------------
# OptimizeParameters
# ---------------------------------------------------------------------------

def test_optimize_parameters_matches_jax(tmp_path, monkeypatch):
    """A 2 x 2 grid over a section of 100 SNPs at N = 16, both packages on
    the same store (the JAX painter in interpret mode, its tie draw the
    Pallas merge scan's hash): the same (theta, rho, fraction) tuples, and
    ``read_opt_grid``/``write_opt`` give the same bytes."""
    N, L = 16, 300
    G, bp = tsynth.synth_coalescent_panel(N, L, seed=9)[:2]
    rng = np.random.default_rng(9)
    G = np.where(rng.random(G.shape) < 0.03, 1 - G, G).astype(np.uint8)
    prefix = str(tmp_path / "panel")
    tsynth.write_haps_sample(G, bp, prefix)
    tsynth.write_flat_map(str(tmp_path / "map.txt"), int(bp[-1]))
    out = str(tmp_path / "store")
    trelate.make_chunks(prefix + ".haps", prefix + ".sample",
                        str(tmp_path / "map.txt"), out, memory_gb=1.0,
                        device="cpu")
    grid = tmp_path / "grid.txt"
    grid.write_text("0.001 0.01\n1 10\n")
    thetas, rhos = trelate.read_opt_grid(str(grid))
    assert (thetas, rhos) == jrelate.read_opt_grid(str(grid))
    kw = dict(thetas=thetas, rho_scales=rhos, max_snps=99, seed=3)
    got = trelate.optimize_parameters(ArtifactStore(out), 0, device="cpu",
                                      **kw)
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")
    with pallas_scan():
        want = jrelate.optimize_parameters(JaxStore(out), 0, **kw)
    assert got == want
    assert len(got) == 4 and len({r[2] for r in got}) > 1
    trelate.write_opt(str(tmp_path / "port.opt"), got)
    jrelate.write_opt(str(tmp_path / "jax.opt"), want)
    assert filecmp.cmp(str(tmp_path / "port.opt"), str(tmp_path / "jax.opt"),
                       shallow=False)
    with pytest.raises(ValueError, match="theta"):
        grid.write_text("0.001 1.5\n1\n")
        trelate.read_opt_grid(str(grid))
