"""The native IO of the port (``relate_tpu_torch/csrc/relate_io.cpp``,
loaded by ``io/native.py``): its ``.haps`` parser against the port's and
the JAX package's Python parsers and the JAX native one, its text ``.anc``
writer against the Python writers of both packages (the same bytes), a
build that fails, rows it must refuse, and ``run_all`` reading and writing
through it.

The JAX native parser names every chromosome "1" and cuts the text fields
at 63 characters; the port's keeps them whole, as both Python parsers do
(ROADMAP section C)."""
import gzip
import os

import numpy as np
import pytest

from relate_tpu.io import ancmut as jancmut
from relate_tpu.io import haps as jhio
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.io import ancmut as tancmut
from relate_tpu_torch.io import haps as thio
from relate_tpu_torch.io import native
from relate_tpu_torch.utils import synth

L, N = 500, 16
LONG = "rs_" + "x" * 80


def _write(path, G, bp, chrom="1", blank=False, final_newline=True,
           sep=" "):
    lines = []
    for l in range(len(bp)):
        rsid = LONG if l == 3 else f"snp{l}"
        lines.append(sep.join([chrom, rsid, str(bp[l]), "A", "GT"[l % 2]]
                              + [str(int(x)) for x in G[l]]))
        if blank and l in (0, 200):
            lines.append("")
    text = "\n".join(lines) + ("\n" if final_newline else "")
    if blank:
        text += "\n  \n"
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "wt") as f:
        f.write(text)


@pytest.fixture(scope="module")
def panel(tmp_path_factory):
    d = tmp_path_factory.mktemp("native")
    G, bp = synth.synth_panel(N, L, seed=4)
    with open(d / "p.sample", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(N // 2):
            f.write(f"s{i} s{i} 0\n")
    return d, G, bp


def _same(a, b, fields=("rsid", "ancestral", "alternative", "chrom")):
    assert a.genotypes.dtype == b.genotypes.dtype == np.uint8
    assert np.array_equal(a.genotypes, b.genotypes)
    assert a.bp.dtype == b.bp.dtype and np.array_equal(a.bp, b.bp)
    for f in fields:
        assert list(getattr(a, f)) == list(getattr(b, f)), f


@pytest.mark.parametrize("name,kw", [
    ("plain.haps", {}), ("gz.haps.gz", {}),
    ("tabs.haps", dict(sep="\t")), ("blank.haps.gz", dict(blank=True)),
    ("open_end.haps", dict(final_newline=False)),
    ("chr.haps", dict(chrom="chr2"))])
def test_native_parser_matches_the_python_parsers(panel, name, kw):
    d, G, bp = panel
    path = str(d / name)
    _write(path, G, bp, **kw)
    sample = str(d / "p.sample")
    got = thio.read_haps(path, sample, use_native=True)
    _same(got, thio.read_haps(path, sample, use_native=False))
    _same(got, jhio.read_haps(path, sample, use_native=False))
    assert np.array_equal(got.genotypes, G) and got.rsid[3] == LONG
    assert native._LIB is not None
    if name == "chr.haps":
        # the JAX native parser: chromosome "1", text cut at 63 characters
        jn = jhio.read_haps(path, sample, use_native=True)
        _same(got, jn, fields=("ancestral", "alternative"))
        assert set(jn.chrom) == {"1"} and set(got.chrom) == {"chr2"}
        assert jn.rsid[3] == LONG[:63]


@pytest.mark.parametrize("row,why", [
    ("1 s 10 A T 0 1 2 0", "allele 2"), ("1 s 10 A T 0 1 0", "3 alleles"),
    ("1 s 10 A T 0 1 0 0 1", "5 alleles"), ("1 s 10 A T 0 1 01", "01"),
    ("1 s x10 A T 0 1 0 0", "position"), ("1 s 10", "no alleles")])
def test_native_parser_refuses_malformed_rows(tmp_path, row, why):
    (tmp_path / "p.sample").write_text("ID_1 ID_2 missing\n0 0 0\na a 0\n"
                                       "b b 0\n")
    (tmp_path / "p.haps").write_text("1 s 5 A T 0 0 1 1\n" + row + "\n")
    with pytest.raises(ValueError, match="SNP 1"):
        thio.read_haps(str(tmp_path / "p.haps"), str(tmp_path / "p.sample"))


def test_a_build_that_fails_raises():
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build("no-such-compiler")
    assert not [f for f in os.listdir(native.BUILD_DIR)
                if f".tmp.{os.getpid()}." in f]


def test_the_library_is_built_into_the_build_directory():
    path = native.build()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.basename(path).startswith("relate_io-")
    assert native.BUILD_DIR.endswith(os.path.join("relate_tpu_torch",
                                                  "build"))
    src_dir = os.path.dirname(native.SOURCE)
    assert not [f for f in os.listdir(src_dir) if f.endswith(".so")]
    with open(os.path.join(os.path.dirname(native.BUILD_DIR), "..",
                           ".gitignore")) as f:
        assert "relate_tpu_torch/build/" in f.read().split()


@pytest.mark.parametrize("ages", [False, True])
def test_native_anc_writer_bytes(golden_dir, tmp_path, ages):
    anc = tancmut.read_anc_text(str(golden_dir / "golden.anc"))
    janc = jancmut.read_anc_text(str(golden_dir / "golden.anc"))
    anc.seq, janc.seq = anc.seq[:700], janc.seq[:700]
    if ages:
        anc.sample_ages = janc.sample_ages = \
            np.asarray([0, 0, 0, 0, 0, 150.0, 900.5, 4000.25])
    out = {}
    for name, mod, a, native_ in (("port_native", tancmut, anc, True),
                                  ("port_py", tancmut, anc, False),
                                  ("jax_native", jancmut, janc, True),
                                  ("jax_py", jancmut, janc, False)):
        p = tmp_path / f"{name}.anc"
        mod.write_anc_text(str(p), a, use_native=native_)
        out[name] = p.read_bytes()
    assert len(set(out.values())) == 1
    assert out["port_native"].count(b"\n") == 702


def test_native_anc_writer_truncates_and_handles_no_trees(golden_dir,
                                                          tmp_path):
    from relate_tpu_torch.core.trees import AncesTree
    p = tmp_path / "a.anc"
    p.write_text("old text that must go\n" * 100)
    tancmut.write_anc_text(str(p), AncesTree(N=4, seq=[]))
    assert p.read_text() == "NUM_HAPLOTYPES 4\nNUM_TREES 0\n"
    anc = tancmut.read_anc_text(str(golden_dir / "golden.anc"))
    anc.seq = anc.seq[:3]
    p.write_text("old text that must go\n" * 10000)
    tancmut.write_anc_text(str(p), anc)
    assert p.read_bytes().count(b"\n") == 5
    assert b"old" not in p.read_bytes()


def test_run_all_reads_and_writes_through_the_library(tmp_path, monkeypatch):
    from relate_tpu_torch.pipeline import cli
    calls = []

    def record(fn):
        def wrapped(*a, **kw):
            calls.append(fn.__name__)
            return fn(*a, **kw)
        return wrapped
    monkeypatch.setattr(native, "read_haps_rows",
                        record(native.read_haps_rows))
    monkeypatch.setattr(native, "write_anc_trees",
                        record(native.write_anc_trees))
    G, bp = synth.synth_panel(8, 200, seed=3)
    prefix = str(tmp_path / "p")
    synth.write_haps_sample(G, bp, prefix)
    synth.write_flat_map(prefix + ".map", int(bp[-1]))
    with open(prefix + ".haps", "rb") as f, \
            gzip.open(prefix + ".haps.gz", "wb") as g:
        g.write(f.read())
    assert cli.main(["--mode", "All", "--haps", prefix + ".haps.gz",
                     "--sample", prefix + ".sample", "--map",
                     prefix + ".map", "--memory", "1", "-o",
                     str(tmp_path / "o"), "--device", "cpu"]) == 0
    assert calls == ["read_haps_rows", "write_anc_trees"]
    anc = tancmut.read_anc_text(str(tmp_path / "o.anc"))
    tancmut.write_anc_text(str(tmp_path / "py.anc"), anc, use_native=False)
    assert (tmp_path / "py.anc").read_bytes() == \
        (tmp_path / "o.anc").read_bytes()
    # the JAX package reads what the port wrote
    assert len(jscripts._load_pair(str(tmp_path / "o"))[0].seq) == \
        len(anc.seq)
