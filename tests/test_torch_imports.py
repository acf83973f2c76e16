"""The port stands alone: it imports neither jax nor the JAX package, it
imports on a machine without nvcc and triton, its wrappers take the plain
version for CPU tensors, and its entry points do not fall back to the CPU."""
import ast
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import relate_tpu_torch
from relate_tpu_torch.core import branch_association_device, mcmc, painting
from relate_tpu_torch.io.chunking import ArtifactStore
from relate_tpu_torch.ops import _build
from relate_tpu_torch.ops import merge_scan as ms
from relate_tpu_torch.ops import paint_kernels as pk
from relate_tpu_torch.pipeline import cli, postprocess, relate
from relate_tpu_torch.utils import synth
from relate_tpu_torch.utils import devmem

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "relate_tpu_torch"


def _module_names():
    names = ["relate_tpu_torch"]
    for m in pkgutil.walk_packages([str(PKG)], prefix="relate_tpu_torch."):
        names.append(m.name)
    return names


def test_every_module_imports_without_jax():
    names = _module_names()
    assert len(names) >= 24
    for new in ("core.branch_association", "core.branch_association_device",
                "core.mcmc", "ops.merge_scan_inc", "pipeline.postprocess",
                "evaluate.coalrate", "evaluate.sampling", "pipeline.scripts",
                "pipeline.tools_cli", "io.extract", "evaluate.selection",
                "evaluate.mutrate", "io.kastore", "io.fileformats",
                "io.importers", "io.treeview", "io.native", "io.refpaint",
                "core.tree_comparer", "parallel.mesh", "parallel.pool"):
        assert "relate_tpu_torch." + new in names
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'jaxlib' or m == 'relate_tpu'"
        " or m.startswith('relate_tpu.') or m == 'triton']\n"
        "assert not bad, bad\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        "from relate_tpu_torch.ops import _build\n"
        "assert not _build._LIBS\n"
        "from relate_tpu_torch.io import native\n"
        "assert native._LIB is None\n"
        "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout


def test_pool_workers_import_no_jax():
    """A ``CardPool`` worker (spawned: a fresh interpreter) imports the
    port and torch and no JAX, though this test process has imported the
    JAX package, also once it has taken in each task the port gives a pool
    (its module imported as the task is unpickled); on a ``"cpu"`` entry
    it runs one thread."""
    import pickle

    import relate_tpu  # noqa: F401 - in this process, not in the workers
    from relate_tpu_torch.core.mcmc import chain_part
    from relate_tpu_torch.evaluate.sampling import sample_part
    from relate_tpu_torch.parallel.pool import CardPool
    from relate_tpu_torch.pipeline.relate import section_branch_lengths
    tasks = (chain_part, sample_part, section_branch_lengths)
    probe = ("sorted(m for m in __import__('sys').modules if m.split('.')[0]"
             " in ('jax', 'jaxlib', 'relate_tpu', 'triton',"
             " 'relate_tpu_torch', 'torch'))")
    with CardPool(["cpu"] * 2, timeout_s=300) as pool:
        seen = pool.map(eval, [(probe,), (probe,)], order=[1, 0])
        threads = pool.map(eval, [("__import__('torch').get_num_threads()",)])
        got = pool.map(pickle.loads, [(pickle.dumps(t),) for t in tasks])
        seen += pool.map(eval, [(probe,), (probe,)])
    assert tuple(got) == tasks
    for mods in seen:
        tops = {m.split(".")[0] for m in mods}
        assert tops == {"relate_tpu_torch", "torch"}, tops
    assert {"relate_tpu_torch.core.mcmc", "relate_tpu_torch.evaluate.sampling",
            "relate_tpu_torch.pipeline.relate"} <= set(seen[-1] + seen[-2])
    assert threads == [1]


def _imports_of(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_file_names_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) >= 25
    for f in files:
        for name in _imports_of(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "relate_tpu", "triton"), \
                f"{f}: imports {name}"
    # the CUDA sources include no PyTorch header (plain C interface)
    for cu in sorted((PKG / "csrc").glob("*.cu")) + \
            sorted((PKG / "csrc").glob("*.cpp")):
        text = cu.read_text()
        assert "torch/" not in text and "ATen" not in text, cu
        assert 'extern "C"' in text, cu


def test_build_names_every_source_and_hashes_its_text():
    for name in _build.SOURCES:
        assert (PKG / "csrc" / f"{name}.cu").exists()
        target = _build._target(name)
        assert target.startswith(str(PKG / "build"))
        assert "sm_90a" in " ".join(_build._flags(name))
    assert "-fmad=false" in _build._flags("merge_scan")
    assert "-fmad=false" in _build._flags("merge_scan_inc")
    assert "merge_scan_inc" in _build.SOURCES
    assert "-fmad=false" not in _build._flags("paint_fwd")
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "relate_tpu_torch/build/" in ignored


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    L, N = 40, 6
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    model = painting.PaintingModel(N=N)
    plan = painting.build_target_plan(G, rng.random(L) * 0.05, model, 0,
                                      L - 1)
    t = torch.from_numpy
    mism = t(np.ascontiguousarray(
        (plan.seqk.T[:, :, None] > G[plan.idx.T]).astype(np.int8)))
    args = (t(plan.D), t(painting.initial_alpha(
        G, model, 0, np.arange(N, dtype=np.int32))), t(plan.kmask), mism,
        t(plan.pfac), t(plan.nxt))
    before = dict(pk.launches), dict(ms.launches)
    a, ls = pk.fwd(*args, theta=0.001)
    a2, ls2 = pk.fwd_plain(*args, theta=0.001)
    assert torch.equal(a, a2) and torch.equal(ls, ls2)
    d = t(rng.random((N, N)).astype(np.float32))
    got = ms.merge_scan(d, torch.zeros_like(d), False, 1.0, 0.1, 7)
    ref = ms.merge_scan_plain(d, torch.zeros_like(d), False, 1.0, 0.1, 7)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    from relate_tpu_torch.ops import merge_scan_inc as mi
    got = mi.merge_scan_inc_lists(d, torch.zeros_like(d), False, 1.0, 0.1, 7)
    ref = mi.merge_scan_inc_plain(d, torch.zeros_like(d), False, 1.0, 0.1, 7)
    assert all(torch.equal(x, y) for x, y in zip(got, ref))
    assert (dict(pk.launches), dict(ms.launches)) == before


def test_entry_points_do_not_fall_back_to_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    G = np.zeros((10, 4), dtype=np.uint8)
    model = painting.PaintingModel(N=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        devmem.resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        painting.Painter(G, np.zeros(10), model)
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.make_chunks("x.haps", "x.sample", "m.txt", str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.paint(None, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.build_topology(None, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", "Paint", "-o", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.find_equivalent_branches(None, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.infer_branch_lengths(None, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.run_all("x.haps", "x.sample", "m.txt", str(tmp_path / "r"))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", "All", "-o", str(tmp_path / "r")])
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.post_process_chunk(None, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        postprocess.post_process(None, [], G, np.arange(10))
    with pytest.raises(RuntimeError, match="CUDA"):
        relate.optimize_parameters(None, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--mode", "PostProcess", "-o", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="CUDA"):
        mcmc.run_mcmc([None], np.zeros(1), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        branch_association_device.branch_association_many_device([None])
    assert not (tmp_path / "r.tmpdir").exists()
    with pytest.raises(RuntimeError, match="CUDA"):
        devmem.resolve_device("cuda")
    with pytest.raises(ValueError, match="memory_gb"):
        devmem.auto_memory_gb("cpu")
    assert devmem.resolve_device("cpu").type == "cpu"


def test_tool_entry_points_do_not_fall_back_to_the_cpu(tmp_path):
    """The selection and mutation-rate functions with a device part."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs on it")
    from relate_tpu_torch.evaluate import mutrate, selection
    from relate_tpu_torch.pipeline import scripts
    e = np.zeros(3)
    for call in (lambda: selection.compute_freq_lin(None, [], e),
                 lambda: selection.selection_scan(None, [], e),
                 lambda: selection.log_pvalue_batch([5], [2], 8, [3], e),
                 lambda: selection.sds(None, []),
                 lambda: mutrate.avg_mutation_rate(None, [], e, e),
                 lambda: mutrate.branch_length_in_epochs([], e),
                 lambda: mutrate.spread_mutations(np.zeros((1, 2)), e),
                 lambda: scripts.detect_selection("x", str(tmp_path / "o"))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not list(tmp_path.iterdir())


def test_cli_names_the_modes_that_are_not_ported(tmp_path):
    """Every mode of the reference binary is a mode of the port's CLI:
    PostProcess, OptimizeParameters and Clean run on a store of a small
    panel (MakeChunks -> Paint -> BuildTopology -> FindEquivalentBranches
    through the CLI), and write what the functions they call write."""
    assert cli.MODES == ("All", "MakeChunks", "Paint", "BuildTopology",
                         "FindEquivalentBranches", "InferBranchLengths",
                         "CombineSections", "Finalize", "PostProcess",
                         "OptimizeParameters", "Clean")
    G, bp = synth.synth_coalescent_panel(8, 160, seed=2)[:2]
    prefix = str(tmp_path / "p")
    synth.write_haps_sample(G, bp, prefix)
    synth.write_flat_map(prefix + ".map", int(bp[-1]))
    out = str(tmp_path / "o")
    common = ["-o", out + ".tmpdir", "--device", "cpu", "--seed", "3"]
    assert cli.main(["--mode", "MakeChunks", "--haps", prefix + ".haps",
                     "--sample", prefix + ".sample", "--map",
                     prefix + ".map", "--memory", "1"] + common) == 0
    for mode in ("Paint", "BuildTopology", "FindEquivalentBranches"):
        assert cli.main(["--mode", mode] + common) == 0
    store = ArtifactStore(out + ".tmpdir")
    copy = ArtifactStore(str(tmp_path / "copy"))
    shutil.copytree(store.outdir, copy.outdir)
    files = ("trees_0.anc", "muts_0.mut")
    before = [open(store.path("chunk_0", f), "rb").read() for f in files]
    assert cli.main(["--mode", "PostProcess", "--randomise"] + common) == 0
    relate.post_process_chunk(copy, 0, seed=3, randomise=True, device="cpu")
    relate.find_equivalent_branches(copy, 0, device="cpu")
    after = [open(store.path("chunk_0", f), "rb").read() for f in files]
    assert after != before
    assert after == [open(copy.path("chunk_0", f), "rb").read()
                     for f in files]

    grid = tmp_path / "grid.txt"
    grid.write_text("0.001 0.1\n1\n")
    assert cli.main(["--mode", "OptimizeParameters", "--input", str(grid),
                     "-o", out, "--store", store.outdir, "--device", "cpu",
                     "--seed", "3"]) == 0
    rows = relate.optimize_parameters(store, 0, thetas=[0.001, 0.1],
                                      rho_scales=[1.0], seed=3, device="cpu")
    relate.write_opt(str(tmp_path / "want.opt"), rows)
    assert open(out + ".opt").read() == open(tmp_path / "want.opt").read()
    assert len(rows) == 2

    assert cli.main(["--mode", "Clean", "-o", out, "--device", "cpu"]) == 0
    assert not (tmp_path / "o.tmpdir").exists()
    assert relate_tpu_torch.__version__


def test_no_environment_variable_picks_a_code_path():
    """What the JAX package reads from the environment is an argument in
    the port: no module of it reads ``os.environ`` beyond the compiler's
    location."""
    for f in sorted(PKG.rglob("*.py")):
        text = f.read_text()
        if f.name == "_build.py":
            assert text.count("os.environ") == 1 and "CUDA_HOME" in text
        else:
            assert "os.environ" not in text and "getenv" not in text, f
