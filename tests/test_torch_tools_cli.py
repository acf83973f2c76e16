"""The slice as a whole: the CoalescentRate tool of the port's
``pipeline/tools_cli.py`` against the JAX package's, mode by mode, on the
same files cut from the reference's final ``golden.anc/.mut`` (two
"chromosomes" of 1,200 SNPs each, N = 8).

The chains of both packages (``sampling.sample_branch_lengths`` and
``mcmc.run_mcmc``) are replaced by one deterministic function of the tree,
as tests/test_torch_pipeline.py does; what they were handed is recorded and
compared. Everything else is each package's own code, and the files must
hold the same bytes, with one exception. The JAX package's device path
rounds each tree's coalescence opportunity to float32 (its counts are exact
integers), which moves the sixth digit of some rates in a ``.coal`` (from
0.000615024 to 0.000615025, for one); the port sums in float64. So each
mode that writes a ``.coal`` also runs the JAX package with its own float64
host twin (``coalescence_stats(use_device=False)``), whose bytes the port's
must equal, and the JAX device path's rates must agree at rtol 1e-5.
CoalRateForTree's arrays: equal counts, the opportunity at rtol 1e-4 (per
tree in float32 on the JAX side).
"""
import filecmp
import os

import numpy as np
import pytest
import torch

from relate_tpu.core import mcmc as jmcmc
from relate_tpu.evaluate import coalrate as jcoalrate
from relate_tpu.evaluate import sampling as jsampling
from relate_tpu.pipeline import tools_cli as jcli
from relate_tpu_torch.core import mcmc as tmcmc
from relate_tpu_torch.evaluate import sampling as tsampling
from relate_tpu_torch.io import extract
from relate_tpu_torch.pipeline import scripts as tscripts
from relate_tpu_torch.pipeline import tools_cli as tcli

torch.set_num_threads(1)

SNPS = 1200


@pytest.fixture(scope="module")
def inputs(golden_dir, tmp_path_factory):
    """in_chr1 / in_chr2 (and ``in``, a copy of chr1), a .poplabels of two
    groups of two individuals, and a chromosome list."""
    d = tmp_path_factory.mktemp("coal_in")
    anc, recs, bp, dist, rsid, alleles = tscripts._load_pair(
        str(golden_dir / "golden"))
    for k, name in ((0, "in_chr1"), (1, "in_chr2"), (0, "in")):
        lo_bp, hi_bp = bp[k * SNPS], bp[(k + 1) * SNPS - 1]
        a, r, (lo, hi) = extract.anc_mut_for_subregion(anc, recs, bp, lo_bp,
                                                       hi_bp)
        sl = slice(lo, hi + 1)
        tscripts._dump_pair(str(d / name), a, r, bp[sl], dist[sl], rsid[sl],
                            alleles[sl])
    (d / "p.poplabels").write_text(
        "sample population group sex\n"
        "i0 P0 EUR 1\ni1 P1 AFR 2\ni2 P0 EUR NA\ni3 P1 AFR 1\n")
    (d / "chrs.txt").write_text("1\n2\n")
    return d


def _lengths(tree, k):
    """Branch lengths from the tree's event counts and ``k``."""
    M = tree.num_nodes
    bl = (10.0 * np.asarray(tree.num_events, np.float64)
          + (np.arange(M) % 5) + 1.0 + k)
    bl[M - 1] = 0.0
    return bl


def _fixed_samples(anc, muts, dist, mu, epochs, rates, num_samples=100,
                   seed=1, **kw):
    """(S, T, M): sample s of every tree."""
    return np.asarray([[_lengths(mt.tree, s + seed % 3) for mt in anc.seq]
                       for s in range(num_samples)])


def _fixed_lengths(trees, *a, **kw):
    return [_lengths(t, 0) for t in trees]


@pytest.fixture
def fixed_chains(monkeypatch):
    """Both packages' chains replaced; the arguments they were handed,
    by package."""
    seen = {"jax": [], "port": [], "monkeypatch": monkeypatch}

    def record(name, fn):
        def wrapped(*a, **kw):
            seen[name].append((a, kw))
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(jsampling, "sample_branch_lengths",
                        record("jax", _fixed_samples))
    monkeypatch.setattr(tsampling, "sample_branch_lengths",
                        record("port", _fixed_samples))
    monkeypatch.setattr(jmcmc, "run_mcmc", record("jax", _fixed_lengths))
    monkeypatch.setattr(tmcmc, "run_mcmc", record("port", _fixed_lengths))
    return seen


def _run_both(tmp_path, mode, args, files, monkeypatch=None):
    """The mode through both CLIs with the same arguments; the files each
    wrote, by suffix. With ``monkeypatch`` the JAX package runs again with
    its host twin of ``coalescence_stats`` ("jax" then names that run,
    "jax_device" the first)."""
    out = {}
    runs = [("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])]
    for name, main, extra in runs:
        o = str(tmp_path / name)
        assert main(["CoalescentRate", "--mode", mode, "-o", o] + args
                    + extra) == 0
        out[name] = {f: o + f for f in files}
    if monkeypatch is not None:
        plain = jcoalrate.coalescence_stats
        monkeypatch.setattr(
            jcoalrate, "coalescence_stats",
            lambda *a, mesh=None, **k: plain(*a, use_device=False, **k))
        out["jax_device"] = out["jax"]
        o = str(tmp_path / "jax_host")
        assert jcli.main(["CoalescentRate", "--mode", mode, "-o", o]
                         + args) == 0
        out["jax"] = {f: o + f for f in files}
        monkeypatch.setattr(jcoalrate, "coalescence_stats", plain)
    return out


def _same_bytes(out):
    for f, path in out["port"].items():
        assert os.path.exists(path), f
        assert filecmp.cmp(path, out["jax"][f], shallow=False), f
    for f in out["port"]:
        if f.endswith(".coal") and "jax_device" in out:
            got, want = (jcoalrate.read_coal(out[k][f])
                         for k in ("port", "jax_device"))
            assert got[0] == want[0] and np.array_equal(got[1], want[1])
            np.testing.assert_allclose(got[2], want[2], rtol=1e-5,
                                       equal_nan=True)


def _args_close(a, b):
    """Recorded positional and keyword arguments: arrays at rtol 1e-6 (rates
    from float64 statistics of float32 or float64 opportunity), trees and
    records by their numbers."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float),
                                   rtol=1e-6, equal_nan=True)
    elif isinstance(a, float):
        assert a == pytest.approx(b, rel=1e-6)
    elif isinstance(a, (list, tuple)) and a and hasattr(a[0], "parent"):
        assert all(np.array_equal(x.parent, y.parent) for x, y in zip(a, b))
    elif hasattr(a, "seq"):
        assert len(a.seq) == len(b.seq)
    elif isinstance(a, (list, tuple)) and a and hasattr(a[0], "branch"):
        assert [(m.tree, m.branch) for m in a] == [(m.tree, m.branch)
                                                   for m in b]
    else:
        assert a == b


def _same_calls(seen):
    assert len(seen["jax"]) == len(seen["port"]) > 0
    for (ja, jk), (ta, tk) in zip(seen["jax"], seen["port"]):
        assert str(tk.pop("device")) == "cpu"
        assert jk.pop("mesh", None) is None
        assert len(ja) == len(ta) and jk.keys() == tk.keys()
        for x, y in zip(ja, ta):
            _args_close(y, x)
        for k in jk:
            _args_close(tk[k], jk[k])


@pytest.mark.parametrize("pop", ["groups", "hap", "chromosomes"])
def test_estimate_population_size(inputs, tmp_path, monkeypatch, pop):
    args = ["-i", str(inputs / "in"), "--poplabels",
            str(inputs / "p.poplabels")]
    if pop == "hap":
        args = args[:3] + ["hap", "--bins", "3,7,0.25"]
    elif pop == "chromosomes":
        args += ["--chr", str(inputs / "chrs.txt")]
    out = _run_both(tmp_path, "EstimatePopulationSize", args,
                    [".coal", ".pairwise.coal"], monkeypatch)
    _same_bytes(out)
    with open(out["port"][".pairwise.coal"]) as f:
        names = f.readline().split()
    assert names == (["EUR", "AFR"] if pop != "hap" else
                     [str(h) for h in range(8)])


def test_coal_rate_for_tree_and_const_coal(inputs, tmp_path):
    out = _run_both(tmp_path, "CoalRateForTree", ["-i", str(inputs / "in")],
                    [".rates.npz"])
    got, want = (np.load(out[k][".rates.npz"]) for k in ("port", "jax"))
    assert got.files == want.files
    assert np.array_equal(got["epochs"], want["epochs"])
    assert np.array_equal(got["counts"], want["counts"])
    np.testing.assert_allclose(got["opportunity"], want["opportunity"],
                               rtol=1e-4, atol=1e-6)
    assert np.array_equal(np.isnan(got["rates"]), np.isnan(want["rates"]))
    np.testing.assert_allclose(got["rates"], want["rates"], rtol=1e-4)
    out = _run_both(tmp_path, "GenerateConstCoalFile",
                    ["-i", "x", "-N", "25000"], [".coal"])
    _same_bytes(out)


def test_estimate_population_size_em(inputs, tmp_path, fixed_chains):
    """Two EM iterations: each draws under the rates of the last, then the
    final re-estimate of the unfiltered trees."""
    out = _run_both(tmp_path, "EstimatePopulationSizeEM",
                    ["-i", str(inputs / "in"), "--poplabels",
                     str(inputs / "p.poplabels"), "--num_iter", "2",
                     "--seed", "4"],
                    [".coal", ".pairwise.coal", ".anc", ".mut"],
                    fixed_chains["monkeypatch"])
    _same_bytes(out)
    assert [kw["seed"] for _, kw in fixed_chains["port"]] == [4, 5, 6]
    # the host twin's run handed its chains what the device path's did
    jax_host = fixed_chains["jax"][3:]
    del fixed_chains["jax"][3:]
    _same_calls(dict(jax=jax_host, port=[(a, dict(k)) for a, k in
                                         fixed_chains["port"]]))
    _same_calls(fixed_chains)


@pytest.mark.parametrize("fmt", ["timeb", "anc", "newick"])
def test_sample_branch_lengths(inputs, tmp_path, fixed_chains, fmt):
    coal = str(tmp_path / "const")
    tcli.main(["CoalescentRate", "--mode", "GenerateConstCoalFile", "-i", "x",
               "-o", coal, "--device", "cpu"])
    files = {"timeb": [".timeb"], "anc": [".anc", ".mut", "_samples.npy"],
             "newick": [".newick", ".dist"]}[fmt]
    region = (["--first_bp", "20000", "--last_bp", "90000"]
              if fmt == "newick" else [])
    out = _run_both(tmp_path, "SampleBranchLengths",
                    ["-i", str(inputs / "in"), "--coal", coal + ".coal",
                     "--format", fmt, "--num_samples", "3"] + region, files)
    _same_bytes(out)
    _same_calls(fixed_chains)
    if fmt == "timeb":
        recs = tsampling.read_timeb(out["port"][".timeb"])
        muts = tscripts._load_pair(str(inputs / "in"))[1]
        assert len(recs) == sum(len(m.branch) <= 1 for m in muts) > 0.9 * SNPS
        assert all(r["anctimes"].shape[0] == 3 for r in recs)


@pytest.mark.parametrize("pairwise", [False, True])
def test_reestimate_branch_lengths(inputs, tmp_path, fixed_chains, pairwise):
    coal = str(tmp_path / "eps")
    tcli.main(["CoalescentRate", "--mode", "EstimatePopulationSize", "-i",
               str(inputs / "in"), "-o", coal, "--poplabels",
               str(inputs / "p.poplabels"), "--device", "cpu"])
    args = ["-i", str(inputs / "in"), "--coal",
            coal + (".pairwise.coal" if pairwise else ".coal"), "--seed", "6"]
    if pairwise:
        args += ["--poplabels", str(inputs / "p.poplabels")]
    out = _run_both(tmp_path, "ReEstimateBranchLengths", args,
                    [".anc", ".mut"])
    _same_bytes(out)
    (_, kw), = fixed_chains["port"]
    assert (kw["group_R"] is not None) == pairwise
    if pairwise:
        assert np.array_equal(kw["memberships"], [0, 0, 1, 1, 0, 0, 1, 1])
        assert kw["group_R"].shape[1:] == (2, 2)
    _same_calls(fixed_chains)


def test_other_tools_name_their_roadmap_item(tmp_path):
    for tool, item in (("MutationRate", 2), ("Selection", 2), ("Extract", 3),
                       ("TreeView", 3), ("FileFormats", 3)):
        with pytest.raises(SystemExit, match=f"item {item}"):
            tcli.main([tool, "-i", "x", "-o", str(tmp_path / "o")])
    with pytest.raises(SystemExit, match="item 4"):
        tcli.main(["CoalescentRate", "--mode", "CoalRateForTree", "-i", "x",
                   "-o", "y", "--devices", "2"])
    with pytest.raises(SystemExit, match="EstimatePopulationSizeEM"):
        tcli.main(["CoalescentRate", "--mode", "Nope", "-i", "x", "-o", "y",
                   "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(["CoalescentRate", "--mode", "GenerateConstCoalFile",
                       "-i", "x", "-o", str(tmp_path / "c")])
        assert not (tmp_path / "c.coal").exists()
