"""The pipeline as a whole, MakeChunks -> Paint -> BuildTopology ->
FindEquivalentBranches -> InferBranchLengths -> CombineSections -> Finalize
and ``run_all``, in both packages on one synthetic panel, through their
normal entry points.

The JAX package runs its Pallas kernels in interpret mode (the environment
switches for the painter; ``_pallas_available`` is patched for the section
code, which otherwise takes the merge scan with ``jax.random`` ties on a
CPU). The port runs on ``device="cpu"``. The merge seeds that the JAX
package derives from its threefry keys are computed with JAX and injected
into the port, so merge lists can be compared exactly. Checkpoint
tolerances are those of ``test_torch_painting.py``. The later stages are
deterministic given a store (the matcher, the splice, the text formats) and
must write equal bytes; branch lengths come from chains that draw other
random numbers in the two packages and are compared in distribution.
"""
import filecmp
import os
import shutil
from dataclasses import asdict

import numpy as np
import jax
import pytest
import torch

from relate_tpu.core import topology_device as jtd
from relate_tpu.io import ancmut as jancmut
from relate_tpu.io.chunking import ArtifactStore as JaxStore
from relate_tpu.pipeline import relate as jrelate
from relate_tpu.utils import synth as jsynth
from relate_tpu_torch.core import topology_device as ttd
from relate_tpu_torch.io import ancmut as tancmut
from relate_tpu_torch.io import chunking as tchunking
from relate_tpu_torch.io.chunking import ArtifactStore
from relate_tpu_torch.pipeline import cli as tcli
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.utils import synth as tsynth
from relate_tpu_torch.utils import trace as ttrace
from test_torch_treebuilder import pallas_scan, port_ties

torch.set_num_threads(1)

N, L, SEED = 8, 200, 5
MEMORY_GB = 1.1e-5           # two to three windows at this size
THETA = 0.001


def jax_merge_seeds(seed: int, S: int) -> np.ndarray:
    key = jax.random.PRNGKey(seed)
    return np.asarray([
        int(jax.random.randint(jax.random.fold_in(key, i), (), 0,
                               np.int32(2**31 - 1)))
        for i in range(S + 1)], dtype=np.int32)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    G, bp = tsynth.synth_coalescent_panel(N, L, seed=SEED)[:2]
    Gj, bpj = jsynth.synth_coalescent_panel(N, L, seed=SEED)[:2]
    assert np.array_equal(G, Gj) and np.array_equal(bp, bpj)
    rng = np.random.default_rng(SEED)
    G = np.where(rng.random(G.shape) < 0.03, 1 - G, G).astype(np.uint8)
    prefix = str(tmp / "panel")
    tsynth.write_haps_sample(G, bp, prefix)
    tsynth.write_flat_map(str(tmp / "map.txt"), int(bp[-1]), cm_per_mb=40.0)

    mp = pytest.MonkeyPatch()
    mp.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    mp.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    mp.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")
    mp.setattr(jtd, "_pallas_available", lambda n: True)
    cached = set(jtd._KERNEL_CACHE)
    try:
        jdir = str(tmp / "store_jax")
        jrelate.make_chunks(prefix + ".haps", prefix + ".sample",
                            str(tmp / "map.txt"), jdir, memory_gb=MEMORY_GB)
        jstore = JaxStore(jdir)
        jrelate.paint(jstore, 0, theta=THETA)
        jrelate.build_topology(jstore, 0, seed=1, theta=THETA)
    finally:
        # the section program built here (interpret-mode merge scan) must
        # not be handed to other tests of this process
        for k in set(jtd._KERNEL_CACHE) - cached:
            del jtd._KERNEL_CACHE[k]
        mp.undo()

    tdir = str(tmp / "store_torch")
    trelate.make_chunks(prefix + ".haps", prefix + ".sample",
                        str(tmp / "map.txt"), tdir, memory_gb=MEMORY_GB,
                        device="cpu")
    tstore = ArtifactStore(tdir)
    trelate.paint(tstore, 0, theta=THETA, device="cpu")
    ch = tstore.load_chunk(0)
    bounds = ch.windows.boundaries
    W = len(bounds) - 1
    sec = trelate.section_seeds(1, 0, W)
    seeds = {}
    for w in range(W):
        end = (bounds[w + 1] - 1) if w < W - 1 else ch.L - 1
        seeds[w] = jax_merge_seeds(int(sec[w]), end - bounds[w] + 1)
    trelate.build_topology(tstore, 0, seed=1, theta=THETA, device="cpu",
                           merge_seeds=seeds)
    return dict(tmp=tmp, prefix=prefix, jstore=jstore, tstore=tstore, W=W,
                seeds=seeds)


def test_plans_and_chunk_arrays_are_identical(stores):
    js, ts = stores["jstore"], stores["tstore"]
    assert stores["W"] >= 2
    pj, wj = js.load_plan()
    pt, wt = ts.load_plan()
    assert asdict(pj) == asdict(pt)
    assert [asdict(w) for w in wj] == [asdict(w) for w in wt]
    cj, ct = js.load_chunk(0), ts.load_chunk(0)
    assert cj.windows.boundaries == ct.windows.boundaries
    for f in ("G", "bp", "dist", "r", "rpos", "state"):
        assert np.array_equal(getattr(cj, f), getattr(ct, f)), f


def test_paint_artifacts_agree(stores):
    js, ts = stores["jstore"], stores["tstore"]
    for w in range(stores["W"]):
        a = np.load(ts.path("chunk_0", f"paint_{w}.npz"))
        b = np.load(js.path("chunk_0", f"paint_{w}.npz"))
        assert sorted(a.files) == sorted(b.files)
        assert np.array_equal(a["bsb"], b["bsb"])
        assert np.array_equal(a["bse"], b["bse"])
        for k in ("alpha", "beta"):
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-30)
        for k in ("ls_alpha", "ls_beta"):
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-3)


def test_trees_and_mutations_are_equal(stores):
    js, ts = stores["jstore"], stores["tstore"]
    total = 0
    for w in range(stores["W"]):
        at = tancmut.read_anc_bin(ts.path("chunk_0", f"trees_{w}.anc"))
        aj = jancmut.read_anc_bin(js.path("chunk_0", f"trees_{w}.anc"))
        assert len(at.seq) == len(aj.seq)
        total += len(at.seq)
        for mt, mj in zip(at.seq, aj.seq):
            assert mt.pos == mj.pos
            assert np.array_equal(mt.tree.parent, mj.tree.parent)
            assert np.array_equal(mt.tree.num_events, mj.tree.num_events)
            assert np.array_equal(mt.tree.SNP_begin, mj.tree.SNP_begin)
            assert np.array_equal(mt.tree.SNP_end, mj.tree.SNP_end)
        # same records, hence the same bytes
        assert filecmp.cmp(ts.path("chunk_0", f"trees_{w}.anc"),
                           js.path("chunk_0", f"trees_{w}.anc"),
                           shallow=False)
        assert filecmp.cmp(ts.path("chunk_0", f"muts_{w}.mut"),
                           js.path("chunk_0", f"muts_{w}.mut"),
                           shallow=False)
    assert total > stores["W"]              # some section did rebuild


def test_port_reads_a_store_written_by_the_jax_package(stores, tmp_path):
    """BuildTopology of the port on the JAX package's chunk and paint
    artifacts gives the JAX package's trees."""
    import shutil
    js = stores["jstore"]
    mixed = tmp_path / "mixed"
    shutil.copytree(js.outdir, mixed)
    for w in range(stores["W"]):
        (mixed / "chunk_0" / f"trees_{w}.anc").unlink()
        (mixed / "chunk_0" / f"muts_{w}.mut").unlink()
    ms = ArtifactStore(str(mixed))
    cp = trelate.load_checkpoint(ms, 0, 0)
    assert cp.alpha.shape == (N, N) and cp.a0_dev is None
    trelate.build_topology(ms, 0, seed=1, theta=THETA, device="cpu",
                           merge_seeds=stores["seeds"])
    for w in range(stores["W"]):
        at = tancmut.read_anc_bin(ms.path("chunk_0", f"trees_{w}.anc"))
        aj = jancmut.read_anc_bin(js.path("chunk_0", f"trees_{w}.anc"))
        assert [m.pos for m in at.seq] == [m.pos for m in aj.seq]
        for mt, mj in zip(at.seq, aj.seq):
            assert np.array_equal(mt.tree.parent, mj.tree.parent)
        mt_ = tancmut.read_mut_short(ms.path("chunk_0", f"muts_{w}.mut"))
        mj_ = jancmut.read_mut_short(js.path("chunk_0", f"muts_{w}.mut"))
        assert [(m.tree, m.branch, m.flipped) for m in mt_] == \
            [(m.tree, m.branch, m.flipped) for m in mj_]


def test_cli_stages_and_cache_handoff(stores, tmp_path):
    """The CLI modes write the same artifacts as the function calls, and the
    in-memory checkpoint handoff equals the reload from disk."""
    prefix, tmp = stores["prefix"], stores["tmp"]
    out = str(tmp_path / "cli")
    common = ["-o", out, "--device", "cpu"]
    assert tcli.main(["--mode", "MakeChunks", "--haps", prefix + ".haps",
                      "--sample", prefix + ".sample", "--map",
                      str(tmp / "map.txt"), "--memory", str(MEMORY_GB)]
                     + common) == 0
    assert tcli.main(["--mode", "Paint"] + common) == 0
    assert tcli.main(["--mode", "BuildTopology", "--seed", "3",
                      "--last_section", "0"] + common) == 0
    assert [r["stage"] for r in ttrace.summary(verbose=False)][-3:] == \
        ["MakeChunks", "Paint", "BuildTopology"]
    cstore = ArtifactStore(out)
    ts = stores["tstore"]
    for w in range(stores["W"]):
        a = np.load(cstore.path("chunk_0", f"paint_{w}.npz"))
        b = np.load(ts.path("chunk_0", f"paint_{w}.npz"))
        assert all(np.array_equal(a[k], b[k]) for k in a.files)

    cache = {}
    trelate.paint(cstore, 0, theta=THETA, device="cpu", cache=cache)
    assert cache[("cps", 0)][0].a0_dev is not None
    trelate.build_topology(cstore, 0, seed=3, theta=THETA, device="cpu",
                           cache=cache, first_section=0, last_section=0)
    assert ("cps", 0) not in cache and ("anc", 0, 0) in cache
    got = tancmut.read_anc_bin(cstore.path("chunk_0", "trees_0.anc"))
    assert len(got.seq) == len(cache[("anc", 0, 0)].seq)
    for a, b in zip(got.seq, cache[("anc", 0, 0)].seq):
        assert np.array_equal(a.tree.parent, b.tree.parent)


def test_unported_options_raise(stores, tmp_path, monkeypatch):
    """``run_all(postprocess=True)`` of both packages on the panel in one
    window (PostProcess, then FindEquivalentBranches again): the same
    ``.anc``/``.mut`` bytes. Both packages' chains are replaced by one
    deterministic function of the tree, the JAX package's merge scan is its
    Pallas scan in interpret mode and its merge seeds are handed to the
    port. (The JAX ``post_process_chunk`` maps a window's records with the
    wrong genotypes from window 1 on, so only one window can be held byte for byte;
    ``test_torch_postprocess.py`` holds the windows.)"""
    prefix, tmp = stores["prefix"], stores["tmp"]
    args = (prefix + ".haps", prefix + ".sample", str(tmp / "map.txt"))
    _jax_env(monkeypatch)
    monkeypatch.setattr(jtd, "_pallas_available", lambda n: True)
    monkeypatch.setattr(jrelate.mcmc, "run_mcmc", _fixed_lengths)
    monkeypatch.setattr(trelate.mcmc, "run_mcmc", _fixed_lengths)
    one = dict(seed=1, memory_gb=1.0, theta=THETA, verbose=False,
               postprocess=True)
    cached = set(jtd._KERNEL_CACHE)
    try:
        jrelate.run_all(*args, str(tmp_path / "jax"), **one)
    finally:
        for k in set(jtd._KERNEL_CACHE) - cached:
            del jtd._KERNEL_CACHE[k]
    monkeypatch.setattr(ttd, "default_merge_seeds", jax_merge_seeds)
    del ttrace.STAGES[:]
    out = trelate.run_all(*args, str(tmp_path / "port"), device="cpu", **one)
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(str(tmp_path / "jax") + ext, out + ext,
                           shallow=False), ext
    names = [r["stage"] for r in ttrace.STAGES]
    assert names.index("chunk0.find_equivalent_branches") < \
        names.index("chunk0.post_process") < \
        names.index("chunk0.find_equivalent_branches.post") < \
        names.index("chunk0.infer_branch_lengths")
    (pp,) = [r for r in ttrace.STAGES if r["stage"] == "chunk0.post_process"]
    assert pp["postprocess"][0]["nodes_rearranged"] > 0
    assert len(tancmut.read_mut_final(out + ".mut")) == L


def _fixed_lengths(trees, *args, **kwargs):
    out = []
    for tr in trees:
        M = len(tr.parent)
        bl = 10.0 * np.asarray(tr.num_events, dtype=np.float64) \
            + (np.arange(M) % 5) + 1.0
        bl[M - 1] = 0.0
        out.append(bl)
    return out


def _jax_env(monkeypatch):
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")


def test_build_topology_unknown_ancestral_allele_matches_jax(
        stores, tmp_path, monkeypatch):
    """BuildTopology with an unknown ancestral allele (the host builder),
    the port's through the CLI's ``--anc_allele_unknown``, on copies of the
    JAX package's store: the same ``.anc``/``.mut`` bytes. The JAX package's
    merge scan is its Pallas scan in interpret mode (the port's tie hash)."""
    W = stores["W"]
    _jax_env(monkeypatch)
    js = JaxStore(_copy_store(stores["jstore"], tmp_path / "jax"))
    with pallas_scan():
        jrelate.build_topology(js, 0, seed=4, theta=THETA,
                               ancestral_state=False)
    ts = ArtifactStore(_copy_store(stores["jstore"], tmp_path / "port"))
    assert tcli.main(["--mode", "BuildTopology", "-o", ts.outdir, "--seed",
                      "4", "--anc_allele_unknown", "--device", "cpu"]) == 0
    flipped = 0
    for w in range(W):
        for f in (f"trees_{w}.anc", f"muts_{w}.mut"):
            assert filecmp.cmp(js.path("chunk_0", f), ts.path("chunk_0", f),
                               shallow=False), f
        flipped += sum(m.flipped for m in tancmut.read_mut_short(
            ts.path("chunk_0", f"muts_{w}.mut")))
    assert flipped > 0


def test_run_all_with_sample_ages_matches_jax(stores, tmp_path, monkeypatch):
    """``run_all(sample_ages_path=...)`` of both packages: the ages reach
    MakeChunks, the age-aware tree builder (the JAX package's with the
    port's tie hash in place of threefry), the MCMC and the ``.anc``. Both
    packages' chains are replaced by one deterministic function of the tree
    (which records the ages it was given), so that the final ``.anc`` and
    ``.mut`` can be held byte for byte; the chains with ages are held
    against each other in ``test_torch_mcmc*.py``."""
    prefix, tmp = stores["prefix"], stores["tmp"]
    args = (prefix + ".haps", prefix + ".sample", str(tmp / "map.txt"))
    ages = np.array([0, 0, 0, 0, 0, 0, 800.0, 800.0])
    ages_path = tmp_path / "ages.txt"
    ages_path.write_text(" ".join(str(a) for a in ages) + "\n")
    seen = []

    def fixed_lengths(trees, *a, sample_ages=None, **k):
        seen.append(sample_ages)
        out = []
        for tr in trees:
            Mt = len(tr.parent)
            bl = 900.0 + 10.0 * np.asarray(tr.num_events, dtype=np.float64) \
                + (np.arange(Mt) % 5)
            bl[Mt - 1] = 0.0
            out.append(bl)
        return out

    _jax_env(monkeypatch)
    monkeypatch.setattr(jrelate.mcmc, "run_mcmc", fixed_lengths)
    monkeypatch.setattr(trelate.mcmc, "run_mcmc", fixed_lengths)
    with port_ties():
        jrelate.run_all(*args, str(tmp_path / "jax"), seed=1,
                        memory_gb=MEMORY_GB, theta=THETA, verbose=False,
                        sample_ages_path=str(ages_path))
    out = trelate.run_all(*args, str(tmp_path / "port"), seed=1,
                          memory_gb=MEMORY_GB, theta=THETA, verbose=False,
                          sample_ages_path=str(ages_path), device="cpu")
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(str(tmp_path / "jax") + ext, out + ext,
                           shallow=False), ext
    assert len(seen) == 2 * stores["W"]
    assert all(np.array_equal(a, ages) for a in seen)
    anc = tancmut.read_anc_text(out + ".anc")
    assert np.array_equal(anc.sample_ages, ages)
    assert len(anc.seq) > stores["W"]
    muts = tancmut.read_mut_final(out + ".mut")
    assert len(muts) == L


def _copy_store(src, dst):
    shutil.copytree(src.outdir, dst)
    return str(dst)


def _section_files(store, W):
    return [store.path("chunk_0", f"trees_{w}.anc") for w in range(W)]


def test_find_equivalent_branches_writes_the_same_bytes(stores, tmp_path):
    """On the JAX package's BuildTopology output the port's
    FindEquivalentBranches (device matcher) writes what the JAX package's
    (host matcher) writes, and the streamed variant what the in-memory one
    writes."""
    W = stores["W"]
    js = JaxStore(_copy_store(stores["jstore"], tmp_path / "jax"))
    jrelate.find_equivalent_branches(js, 0)
    ts = ArtifactStore(_copy_store(stores["jstore"], tmp_path / "port"))
    before = [open(f, "rb").read() for f in _section_files(ts, W)]
    cache = {}
    trelate.find_equivalent_branches(ts, 0, cache=cache, device="cpu")
    ss = ArtifactStore(_copy_store(stores["jstore"], tmp_path / "streamed"))
    trelate.find_equivalent_branches(ss, 0, stream_windows=1, device="cpu")
    for a, b, c in zip(*(_section_files(x, W) for x in (js, ts, ss))):
        assert filecmp.cmp(a, b, shallow=False)
        assert filecmp.cmp(b, c, shallow=False)
    # the stage did something: spans now reach across trees and windows
    assert before != [open(f, "rb").read() for f in _section_files(ts, W)]
    assert sorted(k[2] for k in cache) == list(range(W))
    bounds = stores["tstore"].load_chunk(0).windows.boundaries
    first = tancmut.read_anc_bin(_section_files(ts, W)[1]).seq[0]
    assert first.pos == bounds[1]
    assert (first.tree.SNP_begin < bounds[1]).any()     # across the windows


@pytest.fixture(scope="module")
def inferred(stores, tmp_path_factory):
    """The JAX package's store run through InferBranchLengths."""
    tmp = tmp_path_factory.mktemp("inferred")
    js = JaxStore(_copy_store(stores["jstore"], tmp / "store"))
    jrelate.find_equivalent_branches(js, 0)
    jrelate.infer_branch_lengths(js, 0, seed=1)
    annot = tmp / "panel.annot"
    annot.write_text("upstream_allele;downstream_allele;\n" + "".join(
        f"{'ACGT'[i % 4]};{'TGCA'[i % 3]};\n" for i in range(L)))
    return dict(store=js, annot=str(annot), tmp=tmp)


@pytest.mark.parametrize("with_annot", [False, True],
                         ids=["plain", "annot"])
def test_combine_and_finalize_write_the_same_bytes(inferred, tmp_path,
                                                   with_annot):
    annot = inferred["annot"] if with_annot else None
    js = JaxStore(_copy_store(inferred["store"], tmp_path / "jax"))
    jrelate.combine_sections(js, 0)
    jrelate.finalize(js, str(tmp_path / "jout"), annot_path=annot)
    ts = ArtifactStore(_copy_store(inferred["store"], tmp_path / "port"))
    cache = {}
    trelate.combine_sections(ts, 0, cache=cache)
    for f in ("combined.anc", "combined.mut", "DONE"):
        assert filecmp.cmp(js.path("chunk_0", f), ts.path("chunk_0", f),
                           shallow=False), f
    nnm, nfl = trelate.finalize(ts, str(tmp_path / "tout"), annot_path=annot,
                                cache=cache)
    assert (nnm, nfl) == (sum(m.is_not_mapping for m in
                              cache[("combined", 0)][1]), nfl)
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(str(tmp_path / "jout") + ext,
                           str(tmp_path / "tout") + ext, shallow=False), ext
    # from the files alone (no cache) the same bytes again
    trelate.finalize(ArtifactStore(_copy_store(ts, tmp_path / "again")),
                     str(tmp_path / "tout2"), annot_path=annot, cleanup=True)
    assert not os.path.exists(str(tmp_path / "again"))
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(str(tmp_path / "tout") + ext,
                           str(tmp_path / "tout2") + ext, shallow=False)
    anc = tancmut.read_anc_text(str(tmp_path / "tout.anc"))
    muts = tancmut.read_mut_final(str(tmp_path / "tout.mut"))
    assert len(muts) == L and anc.N == N
    assert any(m["age_end"] > 0 for m in muts)
    with open(str(tmp_path / "tout.mut")) as f:
        assert f.readline().endswith("downstream_allele;\n") == with_annot


def _topology_lines(path):
    """The text .anc with the branch lengths taken out."""
    anc = tancmut.read_anc_text(path)
    return [(mt.pos, mt.tree.parent.tolist(), mt.tree.num_events.tolist(),
             mt.tree.SNP_begin.tolist(), mt.tree.SNP_end.tolist())
            for mt in anc.seq], [mt.tree.branch_length for mt in anc.seq]


def test_run_all_matches_the_jax_package(stores, tmp_path, monkeypatch):
    """``run_all`` of both packages end to end: the same trees, the same
    .mut columns up to the ages; branch lengths and ages in distribution.
    They are posterior means over chains of a few hundred iterations that
    draw other random numbers. Measured on these trees (N = 8), the JAX
    package against itself under three seeds, and the port likewise: the
    total length of a tree differs by 13-19 % for the median tree, by up to
    180 % for the worst (heavy-tailed: not bounded here), and the mean over
    the trees by up to 8 %. The bounds are about twice that: median below
    30 %, mean total length and mean mutation age within 20 %."""
    prefix, tmp = stores["prefix"], stores["tmp"]
    args = (prefix + ".haps", prefix + ".sample", str(tmp / "map.txt"))
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")
    monkeypatch.setattr(jtd, "_pallas_available", lambda n: True)
    cached = set(jtd._KERNEL_CACHE)
    try:
        jrelate.run_all(*args, str(tmp_path / "jax"), seed=1,
                        memory_gb=MEMORY_GB, theta=THETA, verbose=False)
    finally:
        for k in set(jtd._KERNEL_CACHE) - cached:
            del jtd._KERNEL_CACHE[k]
    # the port cannot draw the JAX package's tie-break seeds itself
    monkeypatch.setattr(ttd, "default_merge_seeds", jax_merge_seeds)
    del ttrace.STAGES[:]
    out = trelate.run_all(*args, str(tmp_path / "port"), seed=1,
                          memory_gb=MEMORY_GB, theta=THETA, verbose=False,
                          device="cpu")
    assert out == str(tmp_path / "port")
    assert not os.path.exists(out + ".tmpdir")          # cleanup=True
    # the stage record carries one MCMC record per section
    (rec,) = [r for r in ttrace.STAGES
              if r["stage"] == "chunk0.infer_branch_lengths"]
    assert len(rec["mcmc"]) == stores["W"] and all(
        r["converged"] == r["chains"] for r in rec["mcmc"])
    assert not any("mcmc" in r for r in ttrace.STAGES if r is not rec)
    topo_j, bl_j = _topology_lines(str(tmp_path / "jax.anc"))
    topo_t, bl_t = _topology_lines(out + ".anc")
    assert topo_j == topo_t and len(topo_t) > stores["W"]
    mj = tancmut.read_mut_final(str(tmp_path / "jax.mut"))
    mt = tancmut.read_mut_final(out + ".mut")
    ages = ("age_begin", "age_end")
    assert [{k: v for k, v in m.items() if k not in ages} for m in mj] == \
        [{k: v for k, v in m.items() if k not in ages} for m in mt]
    tot_j = np.array([b.sum() for b in bl_j])
    tot_t = np.array([b.sum() for b in bl_t])
    assert (np.concatenate(bl_t) >= 0).all() and (tot_t > 0).all()
    rel = np.abs(tot_t - tot_j) / tot_j
    assert np.median(rel) < 0.3, rel
    assert abs(tot_t.mean() - tot_j.mean()) / tot_j.mean() < 0.2
    age_j = np.mean([m["age_end"] for m in mj])
    age_t = np.mean([m["age_end"] for m in mt])
    assert abs(age_t - age_j) / age_j < 0.2, (age_j, age_t)
    assert all(m["age_begin"] <= m["age_end"] for m in mt)


def test_run_all_on_the_incremental_route_writes_the_same_bytes(
        stores, tmp_path, monkeypatch):
    """``run_all`` of both packages with the incremental merge scan forced
    on both sides (the route of every N > 2048): the JAX package by its
    environment switch, the port by lowering the limit of its dense kernels.
    Both packages' chains are replaced by one deterministic function of the
    tree, so that the whole of the final ``.anc`` and ``.mut`` can be held
    byte for byte: everything but the branch-length sampler is
    deterministic given the merge seeds."""
    import relate_tpu.ops.merge_scan_inc as jmi
    from relate_tpu_torch.ops import merge_scan as tms
    from relate_tpu_torch.ops import merge_scan_inc as tmi

    def fixed_lengths(trees, *args, **kwargs):
        out = []
        for tr in trees:
            M = len(tr.parent)
            bl = 10.0 * np.asarray(tr.num_events, dtype=np.float64) \
                + (np.arange(M) % 5) + 1.0
            bl[M - 1] = 0.0
            out.append(bl)
        return out

    prefix, tmp = stores["prefix"], stores["tmp"]
    args = (prefix + ".haps", prefix + ".sample", str(tmp / "map.txt"))
    monkeypatch.setenv("RELATE_TPU_MERGE_INC", "1")
    monkeypatch.setenv("RELATE_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("RELATE_TPU_PAINT_DMAX_BUCKET", "8")
    monkeypatch.setenv("RELATE_TPU_PAINT_L_BUCKET", "64")
    monkeypatch.setattr(jtd, "_pallas_available", lambda n: True)
    monkeypatch.setattr(jrelate.mcmc, "run_mcmc", fixed_lengths)
    monkeypatch.setattr(trelate.mcmc, "run_mcmc", fixed_lengths)
    jcalls, calls = [], []
    real_jax, real_plain = jmi.merge_scan_incremental, tmi.merge_scan_inc_plain
    monkeypatch.setattr(
        jmi, "merge_scan_incremental",
        lambda *a, **k: jcalls.append(1) or real_jax(*a, **k))
    monkeypatch.setattr(tmi, "merge_scan_inc_plain",
                        lambda *a: calls.append(1) or real_plain(*a))
    cached = set(jtd._KERNEL_CACHE)
    try:
        jrelate.run_all(*args, str(tmp_path / "jax"), seed=1,
                        memory_gb=MEMORY_GB, theta=THETA, verbose=False)
    finally:
        # the cache's key does not hold the environment switch
        for k in set(jtd._KERNEL_CACHE) - cached:
            del jtd._KERNEL_CACHE[k]
    assert jcalls
    monkeypatch.setattr(ttd, "default_merge_seeds", jax_merge_seeds)
    monkeypatch.setattr(tms, "MAX_N_SMALL", 2)
    monkeypatch.setattr(tms, "MAX_N_LARGE", 2)
    out = trelate.run_all(*args, str(tmp_path / "port"), seed=1,
                          memory_gb=MEMORY_GB, theta=THETA, verbose=False,
                          device="cpu")
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(str(tmp_path / "jax") + ext, out + ext,
                           shallow=False), ext
    anc = tancmut.read_anc_text(out + ".anc")
    assert len(anc.seq) > stores["W"] and len(calls) >= len(anc.seq)
    assert tms.launches["merge_scan_inc"] == 0


def test_run_all_threads_identical(tmp_path, monkeypatch):
    """``threads=3`` must equal ``threads=1`` byte for byte. The chunk
    overlap constants are shrunk so that a 600-SNP panel splits into several
    chunks, which also runs ``finalize``'s chunk-overlap merge. It holds
    only if every ``run_mcmc`` call makes its generators from its own seed
    and shares none."""
    monkeypatch.setattr(tchunking, "OVERLAP", 60)
    monkeypatch.setattr(tchunking, "MERGE_DISCARD", 30)
    monkeypatch.setattr(trelate, "MERGE_DISCARD", 30)
    monkeypatch.setattr(tchunking, "MAX_WINDOWS_PER_CHUNK", 4)
    G, bp = tsynth.synth_panel(8, 600, seed=11)
    prefix = str(tmp_path / "p")
    tsynth.write_haps_sample(G, bp, prefix)
    tsynth.write_flat_map(prefix + ".map", int(bp[-1]))
    mem = 1e-5
    plan, _ = tchunking.plan_chunks_and_windows(G, mem)
    assert plan.num_chunks > 2      # the pool engages, finalize re-reads
    outs = []
    for name, threads in (("seq", 1), ("par", 3)):
        outs.append(str(tmp_path / name))
        trelate.run_all(prefix + ".haps", prefix + ".sample",
                        prefix + ".map", outs[-1], seed=1, verbose=False,
                        threads=threads, memory_gb=mem, device="cpu",
                        cleanup=False)
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(outs[0] + ext, outs[1] + ext, shallow=False), ext
    store = ArtifactStore(outs[1] + ".tmpdir")
    assert all(os.path.exists(store.path(f"chunk_{c}", "DONE"))
               for c in range(plan.num_chunks))
    muts = tancmut.read_mut_final(outs[1] + ".mut")
    assert [m["snp"] for m in muts] == list(range(600))
    anc = tancmut.read_anc_text(outs[1] + ".anc")
    pos = [mt.pos for mt in anc.seq]
    assert pos == sorted(set(pos)) and max(m["tree"] for m in muts) == \
        len(pos) - 1


def test_cli_all_and_stage_modes(stores, tmp_path, monkeypatch):
    """``--mode All`` and the four later stage modes on ``--device cpu``;
    the stage-by-stage flow ends in the files that ``--mode All`` writes
    (same seeds, so the same chains)."""
    prefix, tmp = stores["prefix"], stores["tmp"]
    inputs = ["--haps", prefix + ".haps", "--sample", prefix + ".sample",
              "--map", str(tmp / "map.txt"), "--memory", str(MEMORY_GB)]
    coal = tmp_path / "p.coal"
    coal.write_text("group\n0 1000 10000\n0 0 4e-5 2e-5 3e-5\n")
    epochs, rates = tcli.read_coal_file(str(coal))
    assert epochs.tolist() == [0, 1000, 10000] and rates.tolist() == \
        [4e-5, 2e-5, 3e-5]
    common = ["--device", "cpu", "--seed", "2", "--coal", str(coal)]
    out_all = str(tmp_path / "all")
    assert tcli.main(["--mode", "All", "-o", out_all, "--threads", "2"]
                     + inputs + common) == 0
    store = str(tmp_path / "staged")
    assert tcli.main(["--mode", "MakeChunks", "-o", store] + inputs
                     + common) == 0
    for mode in ("Paint", "BuildTopology", "FindEquivalentBranches",
                 "InferBranchLengths", "CombineSections"):
        assert tcli.main(["--mode", mode, "-o", store] + common) == 0
    out_st = str(tmp_path / "final")
    assert tcli.main(["--mode", "Finalize", "-o", out_st, "--store", store]
                     + common) == 0
    assert [r["stage"] for r in ttrace.summary(verbose=False)][-4:] == \
        ["FindEquivalentBranches", "InferBranchLengths", "CombineSections",
         "Finalize"]
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(out_all + ext, out_st + ext, shallow=False), ext
    assert not os.path.exists(out_all + ".tmpdir") and os.path.isdir(store)


def test_cli_devices_on_a_cpu_mesh(stores, tmp_path, monkeypatch):
    """``--devices N`` for All, Paint, BuildTopology and InferBranchLengths,
    with the first N cards stood in for by N host shards: the files of
    ``--device cpu``. ``--devices`` does not go with ``--device`` nor with
    another mode, and without the stand-in it raises on a host with fewer
    cards (one, mocked)."""
    from relate_tpu_torch.parallel import mesh as tmesh
    prefix, tmp = stores["prefix"], stores["tmp"]
    inputs = ["--haps", prefix + ".haps", "--sample", prefix + ".sample",
              "--map", str(tmp / "map.txt"), "--memory", str(MEMORY_GB)]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(RuntimeError, match="2-card mesh"):
            tcli.main(["--mode", "All", "-o", str(tmp_path / "x"),
                       "--devices", "2"] + inputs)
    with pytest.raises(SystemExit, match="--device"):
        tcli.main(["--mode", "All", "-o", str(tmp_path / "x"), "--devices",
                   "2", "--device", "cpu"] + inputs)
    with pytest.raises(SystemExit, match="not FindEquivalentBranches"):
        tcli.main(["--mode", "FindEquivalentBranches", "-o",
                   str(tmp_path / "x"), "--devices", "2"])
    assert not os.path.exists(str(tmp_path / "x.tmpdir"))
    made = []
    monkeypatch.setattr(tcli, "default_mesh", lambda n: made.append(n) or
                        tmesh.Mesh(["cpu"] * n))
    out_one = str(tmp_path / "one")
    assert tcli.main(["--mode", "All", "-o", out_one, "--device", "cpu"]
                     + inputs) == 0
    out_mesh = str(tmp_path / "mesh")
    assert tcli.main(["--mode", "All", "-o", out_mesh, "--devices", "2"]
                     + inputs) == 0
    store = str(tmp_path / "staged")
    assert tcli.main(["--mode", "MakeChunks", "-o", store, "--device", "cpu"]
                     + inputs) == 0
    for mode, dev in (("Paint", ["--devices", "3"]),
                      ("BuildTopology", ["--devices", "2"]),
                      ("FindEquivalentBranches", ["--device", "cpu"]),
                      ("InferBranchLengths", ["--devices", "3"]),
                      ("CombineSections", [])):
        assert tcli.main(["--mode", mode, "-o", store] + dev) == 0
    out_st = str(tmp_path / "final")
    assert tcli.main(["--mode", "Finalize", "-o", out_st, "--store",
                      store]) == 0
    assert made == [2, 3, 2, 3]
    for ext in (".anc", ".mut"):
        assert filecmp.cmp(out_one + ext, out_mesh + ext, shallow=False), ext
        assert filecmp.cmp(out_one + ext, out_st + ext, shallow=False), ext
