"""The slices as a whole: the tools of the port's ``pipeline/tools_cli.py``
against the JAX package's, mode by mode, on the same files.

CoalescentRate runs on files cut from the reference's final
``golden.anc/.mut`` (two "chromosomes" of 1,200 SNPs each, N = 8).
MutationRate, Selection, Extract, FileFormats and TreeView run on the panel
of tests/test_cli_smoke.py (``synth_panel(8, 400, seed=3)``, its two-group
``.poplabels`` and its all-A ``anc.fasta``, here also a seeded random
fasta) and on the output of the port's ``run_all`` on the CPU; their text
files must hold the JAX tool's bytes (gzipped ones decompressed, a
``.trees`` in every key but its ``uuid``), and their ``.npz`` arrays agree
at rtol 1e-12 (float64 sums in another order).

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
from relate_tpu.pipeline import scripts as jscripts
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


def _run_both(tmp_path, mode, args, files, monkeypatch=None,
              tool="CoalescentRate"):
    """The mode through both CLIs with the same arguments; the files each
    wrote, by suffix. With ``monkeypatch`` the JAX package runs again with
    its host twin of ``coalescence_stats`` ("jax" then names that run,
    "jax_device" the first)."""
    out = {}
    runs = [("jax", jcli.main, []), ("port", tcli.main, ["--device", "cpu"])]
    for name, main, extra in runs:
        o = str(tmp_path / name)
        assert main([tool, "--mode", mode, "-o", o] + args + extra) == 0
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
        assert tk.pop("mesh", None) is None and tk.pop("pool", None) is None
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
    with pytest.raises(SystemExit, match="not CoalescentRate --mode "
                       "CoalRateForTree"):
        tcli.main(["CoalescentRate", "--mode", "CoalRateForTree", "-i", "x",
                   "-o", "y", "--devices", "2"])
    for tool, listed in (("CoalescentRate", "EstimatePopulationSizeEM"),
                         ("MutationRate", "ForCategoryForPopForChromosome"),
                         ("Selection", "FreqDiff"),
                         ("Extract", "GenerateSNPAnnotationsUsingTree"),
                         ("FileFormats", "ConvertFromMsPrime"),
                         ("TreeView", "BranchesBelowMutation")):
        with pytest.raises(SystemExit, match=listed):
            tcli.main([tool, "--mode", "Nope", "-i", "x", "-o", "y",
                       "--device", "cpu"])
    if not torch.cuda.is_available():
        for tool, mode in (("CoalescentRate", "GenerateConstCoalFile"),
                           ("MutationRate", "Avg"),
                           ("Selection", "Frequency")):
            with pytest.raises(RuntimeError, match="CUDA"):
                tcli.main([tool, "--mode", mode, "-i", "x", "-o",
                           str(tmp_path / "c")])
        assert not list(tmp_path.iterdir())


# ---------------------------------------------------------------------------
# MutationRate, Selection and Extract on the panel of tests/test_cli_smoke.py
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    """``run`` (the port's ``run_all`` output on the CPU), ``chr``
    (``chr_1``, ``chr_2``: its DivideAncMut halves), the ``.poplabels``,
    ``anc.fasta`` (all A) and ``random.fasta``, and the extra SNPs
    (``extra.haps/.sample``) for MapMutations."""
    from relate_tpu_torch.pipeline import relate as trelate
    from relate_tpu_torch.utils import synth
    d = tmp_path_factory.mktemp("tools_panel")
    G, bp = synth.synth_panel(8, 400, seed=3)
    prefix = str(d / "toy")
    synth.write_haps_sample(G, bp, prefix)
    synth.write_flat_map(prefix + ".map", int(bp[-1]))
    with open(d / "pop.poplabels", "w") as f:
        f.write("sample population group sex\n")
        for i in range(4):
            f.write(f"s{i} P{'AB'[i % 2]} G{'AB'[i % 2]} NA\n")
    (d / "anc.fasta").write_text(">1\n" + "A" * (int(bp[-1]) + 2) + "\n")
    rng = np.random.default_rng(17)
    seq = "".join(rng.choice(list("acgt"), int(bp[-1]) + 2))
    (d / "random.fasta").write_text(
        ">1\n" + "\n".join(seq[i: i + 60] for i in range(0, len(seq), 60))
        + "\n")
    trelate.run_all(prefix + ".haps", prefix + ".sample", prefix + ".map",
                    str(d / "run"), memory_gb=1.0, verbose=False,
                    device="cpu")
    assert tcli.main(["Extract", "--mode", "DivideAncMut", "-i",
                      str(d / "run"), "-o", str(d / "chr"), "--threads",
                      "2"]) == 0
    extra_bp = bp[:20] + 7
    synth.write_haps_sample((rng.random((20, 8)) < 0.4).astype(np.uint8),
                            extra_bp, str(d / "extra"))
    return d


def _npz_close(out, suffix):
    got, want = (np.load(out[k][suffix]) for k in ("port", "jax"))
    assert got.files == want.files
    for k in got.files:
        g, w = got[k], want[k]
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)
        else:
            assert np.array_equal(g, w), k


@pytest.mark.parametrize("mode,fasta", [
    ("Avg", None), ("FinalizeAvg", None), ("WithContext", "anc"),
    ("WithContext", "random"), ("WithContextForChromosome", "random"),
    ("MutationRateForCategory", "random"),
    ("ForCategoryForChromosome", "random"),
    ("ForCategoryForPopForChromosome", "random"), ("MutationDensity", None)])
def test_mutation_rate_modes(panel, tmp_path, mode, fasta):
    args = ["-i", str(panel / "run")]
    if fasta:
        args += ["--ancestor", str(panel / f"{fasta}.fasta")]
    if mode == "ForCategoryForPopForChromosome":
        args += ["--poplabels", str(panel / "pop.poplabels"),
                 "--pop_of_interest", "GA"]
    if mode == "MutationDensity":
        args += ["--sample_id", "3"]
    text, npz = {"Avg": ([".rate"], "_avg.npz"),
                 "MutationDensity": ([], ".density.npz")}.get(
                     mode.replace("FinalizeAvg", "Avg"),
                     ([".rate"], "_bycat.npz"))
    if mode in ("Avg", "FinalizeAvg"):
        text = ["_avg.rate"]
    out = _run_both(tmp_path, mode, args, text + [npz],
                    tool="MutationRate")
    _same_bytes({k: {f: v[f] for f in text} for k, v in out.items()})
    _npz_close(out, npz)
    m = np.load(out["port"][npz])["mutation"]
    assert m.sum() > 0
    if fasta == "random":
        assert (m.sum(axis=0) > 0).sum() > 8


@pytest.mark.parametrize("mode", ["Avg", "WithContext"])
def test_mutation_rate_over_chromosomes(panel, tmp_path, mode):
    """The --first_chr..--last_chr loop: each chromosome, the genome sum
    and the finalised rates."""
    args = ["-i", str(panel / "chr"), "--first_chr", "1", "--last_chr", "2",
            "--ancestor", str(panel / "random.fasta")]
    npz = "_avg.npz" if mode == "Avg" else "_bycat.npz"
    per = [f"_chr{c}{s}" for c in (1, 2) for s in
           ([npz, "_avg.rate"] if mode == "Avg" else [npz, ".rate"])]
    out = _run_both(tmp_path, mode, args, per + [npz, ".rate"],
                    tool="MutationRate")
    _same_bytes({k: {f: v[f] for f in v if f.endswith("rate")}
                 for k, v in out.items()})
    for f in per + [npz]:
        if f.endswith(".npz"):
            _npz_close(out, f)


def test_mutation_rate_summaries(panel, tmp_path):
    """The summary modes of both CLIs on the same per-chromosome outputs
    (the port's)."""
    parts = []
    for c, mode in ((1, "Avg"), (2, "Avg"), (1, "WithContext"),
                    (2, "WithContext")):
        o = str(tmp_path / f"in_{mode}_{c}")
        assert tcli.main(["MutationRate", "--mode", mode, "-i",
                          str(panel / f"chr_chr{c}"), "-o", o, "--ancestor",
                          str(panel / "random.fasta"), "--device",
                          "cpu"]) == 0
        parts.append(o)
    avg, cat = ",".join(parts[:2]), ",".join(parts[2:])
    for mode, inp, files in (
            ("SummarizeForGenome", avg, ["_avg.npz"]),
            ("SummarizeForGenomeForCategory", cat, ["_bycat.npz"]),
            ("Finalize", avg, [".rate"]),
            ("FinalizeForCategory", cat, [".rate"]),
            ("FinalizeMutationCount", avg, [".count"]),
            ("XY", avg, [".xy"])):
        (tmp_path / mode).mkdir()
        out = _run_both(tmp_path / mode, mode, ["-i", inp], files,
                        tool="MutationRate")
        if files[0].endswith(".npz"):
            _npz_close(out, files[0])
        else:
            _same_bytes(out)


@pytest.mark.parametrize("mode,files", [
    ("Frequency", [".freq", ".lin"]), ("Selection", [".sele"]),
    ("Quality", [".qual"]), ("SDS", [".sds"]),
    ("FreqDiff", [".freqdiff", ".zfreqdiff"])])
def test_selection_modes(panel, tmp_path, mode, files):
    out = _run_both(tmp_path, mode, ["-i", str(panel / "run")], files,
                    tool="Selection")
    _same_bytes(out)
    with open(out["port"][files[0]]) as f:
        assert len(f.readlines()) > 100


def test_detect_selection(panel, tmp_path):
    """``scripts.detect_selection`` of both packages, whole and on a
    subregion."""
    for region in ((None, None), (20_000, 150_000)):
        for name, scripts, kw in (("jax", jscripts, {}),
                                  ("port", tscripts, dict(device="cpu"))):
            scripts.detect_selection(str(panel / "run"),
                                     str(tmp_path / name), first_bp=region[0],
                                     last_bp=region[1], **kw)
        _same_bytes({k: {f: str(tmp_path / k) + f for f in
                         (".freq", ".lin", ".sele", ".qual")}
                     for k in ("jax", "port")})


@pytest.mark.parametrize("mode,extra,files", [
    ("AncToNewick", ["--first_bp", "500", "--last_bp", "100000"],
     [".newick"]),
    ("SubTreesForSubpopulation", ["--poplabels", "POP", "--pop_of_interest",
                                  "GA"], [".anc", ".mut"]),
    ("AncMutForSubregion", ["--first_bp", "500", "--last_bp", "100000"],
     [".anc", ".mut"]),
    ("RemoveTreesWithFewMutations", ["--threshold", "0.2"], [".anc", ".mut"]),
    ("ExtractDistFromMut", [], [".dist"]),
    ("DivideAncMut", ["--threads", "3"],
     [f"_chr{i}{s}" for i in (1, 2, 3) for s in (".anc", ".mut")]),
    ("MapMutations", ["--haps", "EXTRA.haps", "--sample", "EXTRA.sample"],
     [".mut"]),
    ("UnlinkTips", ["--pop_of_interest", "0,1"], [".anc", ".mut"]),
    ("GetMut", [], [".anc", ".mut"]),
    ("AncientToModern", [], [".anc", ".mut"]),
    ("CountMutonBranches", [], [".mutcount"]),
    ("GetAllBranchesOfMut", [], [".branches"]),
    ("CheckBranchPersistence", [], [".persistence"]),
    ("GenerateSNPAnnotationsUsingTree", [], [".annot"])])
def test_extract_modes(panel, tmp_path, mode, extra, files):
    extra = [str(panel / "pop.poplabels") if e == "POP" else
             e.replace("EXTRA", str(panel / "extra")) for e in extra]
    out = _run_both(tmp_path, mode, ["-i", str(panel / "run")] + extra,
                    files, tool="Extract")
    _same_bytes(out)


def test_extract_combine_anc_mut(panel, tmp_path):
    """CombineAncMut reads the chunks at ``<output>_chr<i>``: both CLIs
    rejoin the same DivideAncMut chunks into the run's own files."""
    for name in ("jax", "port"):
        for c in (1, 2):
            for s in (".anc", ".mut"):
                (tmp_path / f"{name}_chr{c}{s}").write_bytes(
                    (panel / f"chr_chr{c}{s}").read_bytes())
    out = _run_both(tmp_path, "CombineAncMut", ["-i", "unused"],
                    [".anc", ".mut"], tool="Extract")
    _same_bytes(out)
    for s in (".anc", ".mut"):
        assert (panel / f"run{s}").read_bytes() == \
            open(out["port"][s], "rb").read()


# ---------------------------------------------------------------------------
# FileFormats, TreeView and Extract's ConvertNewickToTimeb on the same panel
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ff_inputs(panel):
    """The panel as ``toy.haps.gz``/``toy.sample.gz``, a phased VCF, IMPUTE
    hap/legend/sample files, a mask, a list of samples to remove, and the
    run's trees as Newick (``pos newick``), RENT+ (1-based leaves),
    ARGweaver ``.smc`` and msprime text; ``one.newick`` holds five copies
    of one tree."""
    import gzip
    from relate_tpu_torch.io import haps as thio
    d = panel
    data = thio.read_haps(str(d / "toy.haps"), str(d / "toy.sample"))
    for s in (".haps", ".sample"):
        with open(d / f"toy{s}", "rb") as f, \
                gzip.open(d / f"toy{s}.gz", "wb") as g:
            g.write(f.read())
    G = data.genotypes
    with open(d / "toy.vcf", "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\t" + "\t".join(
                    f"s{i}" for i in range(data.N // 2)) + "\n")
        for l in range(data.L):
            f.write(f"1\t{data.bp[l]}\t{data.rsid[l]}\tA\tT\t.\tPASS\t.\t"
                    "GT\t" + "\t".join(f"{G[l, 2 * i]}|{G[l, 2 * i + 1]}"
                                       for i in range(data.N // 2)) + "\n")
    with gzip.open(d / "imp.hap.gz", "wt") as f:
        for l in range(data.L):
            f.write(" ".join(str(x) for x in G[l]) + "\n")
    with gzip.open(d / "imp.legend.gz", "wt") as f:
        f.write("id position a0 a1\n")
        for l in range(data.L):
            f.write(f"{data.rsid[l]} {data.bp[l]} A T\n")
    (d / "imp.sample").write_text("ID_1 ID_2 missing\n0 0 0\n" + "".join(
        f"s{i} s{i} 0\n" for i in range(data.N // 2)))
    rng = np.random.default_rng(23)
    (d / "mask.fasta").write_text(">1\n" + "".join(np.where(
        rng.random(int(data.bp[-1]) + 2) < 0.2, "N", "P")) + "\n")
    (d / "remove.txt").write_text("s1\ns3\n")
    anc = tscripts._load_pair(str(d / "run"))[0]
    lines = [f"{mt.pos} {mt.tree.to_newick()}" for mt in anc.seq]
    (d / "run.newick").write_text("\n".join(lines) + "\n")
    rent = []
    for mt in anc.seq:
        t = mt.tree
        nw = t.to_newick()
        for leaf in range(t.N - 1, -1, -1):      # 1-based leaf labels
            nw = nw.replace(f"({leaf}:", f"(#{leaf + 1}:").replace(
                f",{leaf}:", f",#{leaf + 1}:")
        rent.append(f"{mt.pos} {nw.replace('#', '')}")
    (d / "run.rent").write_text("\n".join(rent) + "\n")
    smc = ["NAMES\t" + "\t".join(str(i + 1) for i in range(anc.N)),
           "REGION\tchr1\t1\t1000000"]
    for mt in anc.seq:
        smc.append(f"TREE\t{mt.pos}\t{mt.pos + 1}\t"
                   f"{mt.tree.to_newick()[:-1]}[&&NHX:age=0];")
    (d / "run.smc").write_text("\n".join(smc) + "\n")
    ms = ["#msprime", f"{anc.N} {len(anc.seq)}"]
    for mt in anc.seq:
        t = mt.tree
        ms.append(str(mt.pos))
        for v in range(t.num_nodes):
            if t.child_left[v] < 0:
                ms.append(str(v))
            else:
                a, b = int(t.child_left[v]), int(t.child_right[v])
                ms.append(f"{v} {a} {b} {t.branch_length[a]:f} "
                          f"{t.branch_length[b]:f}")
    (d / "run.ms").write_text("\n".join(ms) + "\n")
    (d / "one.newick").write_text((lines[3].split()[1] + "\n") * 5)
    return d


def _decompressed_bytes(out):
    import gzip
    for f, path in out["port"].items():
        got = []
        for p in (path, out["jax"][f]):
            with open(p, "rb") as h:
                head = h.read(2)
            with (gzip.open if head == b"\x1f\x8b" else open)(p, "rb") as h:
                got.append(h.read())
        assert got[0] == got[1] and got[0], f


@pytest.mark.parametrize("mode,extra,files", [
    ("ConvertFromVcf", ["-i", "D/toy.vcf"], [".haps", ".sample"]),
    ("ConvertFromHapLegendSample", ["-i", "D/imp"], [".haps", ".sample"]),
    ("RemoveNonBiallelicSNPs", ["-i", "D/toy"], [""]),
    ("RemoveSamples", ["-i", "D/toy", "--remove_ids", "D/remove.txt"], [""]),
    ("FilterHapsUsingMask", ["-i", "D/toy", "--mask", "D/mask.fasta"], [""]),
    ("FlipHapsUsingAncestor", ["-i", "D/toy", "--ancestor",
                               "D/random.fasta"], [""]),
    ("GenerateSNPAnnotations", ["-i", "D/toy", "--ancestor",
                                "D/random.fasta", "--poplabels",
                                "D/pop.poplabels"], [".annot"]),
    ("ConvertFromNewick", ["-i", "D/run.newick", "-N", "2"], [".anc"]),
    ("ConvertFromRent", ["-i", "D/run.rent"], [".anc"]),
    ("ConvertFromArgweaverSMC", ["-i", "D/run.smc"], [".anc"]),
    ("ConvertFromMsPrime", ["-i", "D/run.ms"], [".anc"])])
def test_file_formats_modes(ff_inputs, tmp_path, mode, extra, files):
    extra = [e.replace("D/", str(ff_inputs) + "/") for e in extra]
    out = _run_both(tmp_path, mode, extra, files, tool="FileFormats")
    _decompressed_bytes(out)
    if mode == "RemoveSamples":
        # the .haps without a matching .sample, as the JAX CLI writes it
        # (ROADMAP section C)
        assert not (tmp_path / "port.sample").exists()
        row = open(out["port"][""]).readline().split()
        assert len(row) == 5 + 8 - 4
    if mode == "FlipHapsUsingAncestor":
        rows = open(out["port"][""]).read().splitlines()
        assert 100 < len(rows) < 300
        assert {r.split()[3] for r in rows} == {"A", "T"}


@pytest.mark.parametrize("mode", ["ConvertToTreeSequence",
                                  "ConvertToTreeSequenceTxt"])
def test_convert_to_tree_sequence(panel, tmp_path, mode):
    from relate_tpu_torch.io import kastore
    out = _run_both(tmp_path, mode, ["-i", str(panel / "run")], [".trees"],
                    tool="FileFormats")
    got, want = (kastore.load(out[k][".trees"]) for k in ("port", "jax"))
    assert sorted(got) == sorted(want)
    for k in got:
        if k != "uuid":
            assert got[k].dtype == want[k].dtype, k
            assert np.array_equal(got[k], want[k]), k
    assert not np.array_equal(got["uuid"], want["uuid"])
    nt = got["nodes/time"]
    assert (nt[got["edges/parent"]] > nt[got["edges/child"]]).all()
    assert len(got["mutations/site"]) > 300


@pytest.mark.parametrize("mode,files", [
    ("TreeView", [".coords"]), ("TreeViewSample", [".coords"]),
    ("MutationsOnBranches", [".muts"]),
    ("BranchesBelowMutation", [".branches"])])
@pytest.mark.parametrize("bp_of_interest", ["0", "60000", "150000"])
def test_tree_view_modes(panel, tmp_path, mode, files, bp_of_interest):
    out = _run_both(tmp_path, mode, ["-i", str(panel / "run"),
                                     "--bp_of_interest", bp_of_interest],
                    files, tool="TreeView")
    _same_bytes(out)
    rows = open(out["port"][files[0]]).read().splitlines()
    if mode.startswith("TreeView"):
        assert len(rows) == 1 + 15
        assert (tmp_path / "port.png").exists() == \
            (tmp_path / "jax.png").exists()


def test_convert_newick_to_timeb(ff_inputs, tmp_path):
    out = _run_both(tmp_path, "ConvertNewickToTimeb",
                    ["-i", str(ff_inputs / "one")], [".timeb"],
                    tool="Extract")
    _same_bytes(out)
    hdr = np.fromfile(out["port"][".timeb"], dtype=np.int32, count=3)
    assert list(hdr) == [5, 1, 15]
