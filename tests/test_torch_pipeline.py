"""The slice as a whole, MakeChunks -> Paint -> BuildTopology, in both
packages on one synthetic panel, through their normal entry points.

The JAX package runs its Pallas kernels in interpret mode (the environment
switches for the painter; ``_pallas_available`` is patched for the section
code, which otherwise takes the merge scan with ``jax.random`` ties on a
CPU). The port runs on ``device="cpu"``. The merge seeds that the JAX
package derives from its threefry keys are computed with JAX and injected
into the port, so merge lists can be compared exactly. Checkpoint
tolerances are those of ``test_torch_painting.py``.
"""
import filecmp
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
from relate_tpu_torch.io import ancmut as tancmut
from relate_tpu_torch.io.chunking import ArtifactStore
from relate_tpu_torch.pipeline import cli as tcli
from relate_tpu_torch.pipeline import relate as trelate
from relate_tpu_torch.utils import synth as tsynth
from relate_tpu_torch.utils import trace as ttrace

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


def test_unported_options_raise(stores):
    with pytest.raises(NotImplementedError, match="host"):
        trelate.build_topology(stores["tstore"], 0, device="cpu",
                               ancestral_state=False)
