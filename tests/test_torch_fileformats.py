"""The input-file utilities of the port (``relate_tpu_torch/io/
fileformats.py``, ``pipeline/scripts.py:prepare_input_files``) against the
JAX package's, function by function, on a seeded panel (12 haplotypes, 300
SNPs, random alleles, some positions doubled). Host code on both sides:
panels, kept indexes and files must be equal; gzipped files are compared
decompressed (the gzip header carries a time)."""
import gzip

import numpy as np
import pytest

from relate_tpu.io import fileformats as jff
from relate_tpu.io import haps as jhio
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.io import fileformats as tff
from relate_tpu_torch.io import haps as thio
from relate_tpu_torch.pipeline import scripts as tscripts

L, N = 300, 12
BASES = np.asarray(list("ACGT"))


def _panel(seed=5, chrom="1"):
    rng = np.random.default_rng(seed)
    G = (rng.random((L, N)) < 0.3).astype(np.uint8)
    bp = np.cumsum(rng.integers(1, 40, L)) + 100
    bp[[20, 150, 151]] = bp[[19, 149, 150]]            # doubled positions
    bp = np.maximum.accumulate(bp)
    anc = rng.integers(0, 4, L)
    alt = (anc + rng.integers(1, 4, L)) % 4
    return dict(genotypes=G, bp=bp.astype(np.int64),
                rsid=[f"rs{i}" for i in range(L)],
                ancestral=list(BASES[anc]), alternative=list(BASES[alt]),
                chrom=[chrom] * L)


def _data(fields, mod):
    return mod.HapsData(**{k: (v.copy() if isinstance(v, np.ndarray)
                               else list(v)) for k, v in fields.items()})


def _same_data(a, b):
    assert a.genotypes.dtype == b.genotypes.dtype
    assert np.array_equal(a.genotypes, b.genotypes)
    assert np.array_equal(a.bp, b.bp)
    for f in ("rsid", "ancestral", "alternative", "chrom"):
        assert list(getattr(a, f)) == list(getattr(b, f)), f


def _fasta(path, seq):
    with open(path, "w") as f:
        f.write(">1\n")
        for i in range(0, len(seq), 60):
            f.write(seq[i: i + 60] + "\n")


def _ancestor(fields, seed=6):
    """A fasta over the panel: a SNP's base is its ancestral allele, its
    alternative one (it flips), N (it drops) or another base (it drops)."""
    rng = np.random.default_rng(seed)
    seq = BASES[rng.integers(0, 4, int(fields["bp"][-1]) + 5)].astype("<U1")
    for i, b in enumerate(fields["bp"]):
        u = rng.random()
        seq[b - 1] = (fields["ancestral"][i] if u < 0.6 else
                      fields["alternative"][i] if u < 0.85 else
                      "N" if u < 0.92 else "acgt"[i % 4])
    return "".join(seq)


def _mask(fields, seed=7):
    rng = np.random.default_rng(seed)
    return "".join(np.where(rng.random(int(fields["bp"][-1]) + 5) < 0.15,
                            "N", "P"))


def _read(path):
    with open(path, "rb") as f:
        head = f.read(2)
    op = gzip.open if head == b"\x1f\x8b" else open
    with op(path, "rb") as f:
        return f.read()


def _write_vcf(path, fields, rows_extra=()):
    G = fields["genotypes"]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n##source=test\n")
        f.write("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
                + "\t".join(f"ind{i}" for i in range(N // 2)) + "\n")
        for l in range(L):
            sep = "/" if l % 7 == 3 else "|"
            gts = [f"{G[l, 2 * i]}{sep}{G[l, 2 * i + 1]}"
                   for i in range(N // 2)]
            if l % 11 == 5:
                gts = [g + ":35:0.9" for g in gts]        # FORMAT fields
            if l % 13 == 7:
                gts[2] = ".|1"                            # missing: dropped
            if l % 17 == 9:
                gts[-1] = "2|0"                           # multi-allelic
            if l % 19 == 4:
                gts[1] = "1"                              # haploid call
            f.write(f"{fields['chrom'][l]}\t{fields['bp'][l]}\t"
                    f"{fields['rsid'][l]}\t{fields['ancestral'][l]}\t"
                    f"{fields['alternative'][l]}\t50\tPASS\t.\tGT\t"
                    + "\t".join(gts) + "\n")
        for row in rows_extra:
            f.write(row + "\n")


@pytest.mark.parametrize("gz", [False, True])
def test_convert_from_vcf(tmp_path, gz):
    fields = _panel(chrom="chr20")
    vcf = str(tmp_path / "in.vcf")
    _write_vcf(vcf, fields, ["20\t99999\t.\tA\tG\t.\t.\t.\tGT"])
    if gz:
        with open(vcf, "rb") as f, gzip.open(vcf + ".gz", "wb") as g:
            g.write(f.read())
        vcf += ".gz"
    for name, ff in (("jax", jff), ("port", tff)):
        ff.convert_from_vcf(vcf, str(tmp_path / name))
    for s in (".haps", ".sample"):
        assert _read(tmp_path / f"port{s}") == _read(tmp_path / f"jax{s}")
    rows = _read(tmp_path / "port.haps").decode().splitlines()
    assert L * 0.75 < len(rows) < L
    assert rows[0].split()[:5] == ["chr20", "rs0", str(fields["bp"][0]),
                                   fields["ancestral"][0],
                                   fields["alternative"][0]]


def test_convert_from_hap_legend_sample(tmp_path):
    fields = _panel()
    G = fields["genotypes"]
    with gzip.open(tmp_path / "in.hap.gz", "wt") as f:
        for l in range(L):
            f.write(" ".join(str(x) for x in G[l]) + "\n")
    with gzip.open(tmp_path / "in.legend.gz", "wt") as f:
        f.write("id position a0 a1\n")
        for l in range(L):
            f.write(f"{fields['rsid'][l]} {fields['bp'][l]} "
                    f"{fields['ancestral'][l]} {fields['alternative'][l]}\n")
    with open(tmp_path / "in.sample", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(N // 2):
            f.write(f"ind{i} ind{i} 0\n")
    for name, ff in (("jax", jff), ("port", tff)):
        ff.convert_from_hap_legend_sample(
            str(tmp_path / "in.hap.gz"), str(tmp_path / "in.legend.gz"),
            str(tmp_path / "in.sample"), str(tmp_path / name), chrom="7")
    for s in (".haps", ".sample"):
        assert _read(tmp_path / f"port{s}") == _read(tmp_path / f"jax{s}")
    assert len(_read(tmp_path / "port.haps").splitlines()) == L


@pytest.mark.parametrize("fn", ["remove_non_biallelic_snps", "remove_samples",
                                "filter_haps_using_mask",
                                "flip_haps_using_ancestor"])
def test_haps_functions(fn):
    fields = _panel()
    arg = {"remove_non_biallelic_snps": (),
           "remove_samples": ([0, 5, 11],),
           "filter_haps_using_mask": (_mask(fields),),
           "flip_haps_using_ancestor": (_ancestor(fields),)}[fn]
    got = getattr(tff, fn)(_data(fields, thio), *arg)
    want = getattr(jff, fn)(_data(fields, jhio), *arg)
    if fn == "remove_samples":
        _same_data(got, want)
        assert got.N == N - 3
        return
    _same_data(got[0], want[0])
    assert np.array_equal(got[1], want[1])
    assert 0 < len(got[1]) < L
    if fn == "flip_haps_using_ancestor":
        flipped = [i for i, k in enumerate(got[1])
                   if got[0].ancestral[i] != fields["ancestral"][k]]
        assert flipped
        for i in flipped:
            k = got[1][i]
            assert np.array_equal(got[0].genotypes[i],
                                  1 - fields["genotypes"][k])


@pytest.mark.parametrize("with_ancestor,with_pop", [(True, True),
                                                     (False, True),
                                                     (True, False)])
def test_generate_snp_annotations(tmp_path, with_ancestor, with_pop):
    fields = _panel()
    seq = _ancestor(fields) if with_ancestor else None
    pops = {}
    if with_pop:
        path = tmp_path / "p.poplabels"
        path.write_text("sample population group sex\n" + "".join(
            f"ind{i} P{'XYZ'[i % 3]} G{'XYZ'[i % 3]} NA\n"
            for i in range(N // 2)))
        pops = {"port": thio.read_poplabels(str(path)),
                "jax": jhio.read_poplabels(str(path))}
    got = tff.generate_snp_annotations(_data(fields, thio), seq,
                                       pops.get("port"))
    want = jff.generate_snp_annotations(_data(fields, jhio), seq,
                                        pops.get("jax"))
    assert got[0] == want[0]
    assert list(got[1]) == list(want[1])
    assert len(got[1]) == L


@pytest.mark.parametrize("suffix", ["", ".gz"])
@pytest.mark.parametrize("wide", [False, True])
def test_write_haps(tmp_path, suffix, wide):
    fields = _panel()
    if wide:                  # values of two digits take the general path
        fields["genotypes"] = fields["genotypes"] * 12
    for name, ff, hio in (("jax", jff, jhio), ("port", tff, thio)):
        ff.write_haps(_data(fields, hio), str(tmp_path / f"{name}{suffix}"))
    assert _read(tmp_path / f"port{suffix}") == \
        _read(tmp_path / f"jax{suffix}")


@pytest.mark.parametrize("options", ["all", "none"])
def test_prepare_input_files(tmp_path, options):
    """PrepareInputFiles of both packages: the four outputs decompressed."""
    fields = _panel()
    prefix = str(tmp_path / "in")
    tff.write_haps(_data(fields, thio), prefix + ".haps")
    with open(prefix + ".sample", "w") as f:
        f.write("ID_1 ID_2 missing\n0 0 0\n")
        for i in range(N // 2):
            f.write(f"ind{i} ind{i} 0\n")
    kw = {}
    if options == "all":
        _fasta(tmp_path / "anc.fa", _ancestor(fields))
        _fasta(tmp_path / "mask.fa", _mask(fields))
        (tmp_path / "p.poplabels").write_text(
            "sample population group sex\n" + "".join(
                f"ind{i} P{'AB'[i % 2]} {'AB'[i % 2]} NA\n"
                for i in range(N // 2) if i != 2))
        kw = dict(ancestor_path=str(tmp_path / "anc.fa"),
                  mask_path=str(tmp_path / "mask.fa"), remove_ids=["ind2"],
                  poplabels_path=str(tmp_path / "p.poplabels"))
    for name, scripts in (("jax", jscripts), ("port", tscripts)):
        scripts.prepare_input_files(prefix + ".haps", prefix + ".sample",
                                    str(tmp_path / name), **kw)
    suffixes = [".haps.gz", ".sample", ".dist"]
    if options == "all":
        suffixes.append(".annot")
    else:
        assert not (tmp_path / "port.annot").exists()
    for s in suffixes:
        got = _read(tmp_path / f"port{s}")
        assert got == _read(tmp_path / f"jax{s}"), s
        assert got
    rows = _read(tmp_path / "port.haps.gz").decode().splitlines()
    if options == "all":
        assert len(rows[0].split()) == 5 + N - 2
        assert L * 0.4 < len(rows) < L * 0.9
