"""The selection scan of the port (``relate_tpu_torch/evaluate/selection.py``)
against the JAX package's, on the same inputs, and against the C++
reference's own outputs.

Tolerances: the counts (freq, lin, daf, both anchors, ``quality``'s counts)
are equal; log10 p-values within 1e-10 absolute; rSDS at rtol 1e-12; the
files the writers produce are the bytes the JAX writers produce, except
that a ``.sele`` line may differ where a p-value lies within 1e-9 of a
``%.4g`` rounding boundary (counted, and 0 on these inputs).
"""
import filecmp
import math

import numpy as np
import pytest
import torch

from relate_tpu.evaluate import coalrate as jcoalrate
from relate_tpu.evaluate import selection as jsel
from relate_tpu.io import extract as jextract
from relate_tpu.pipeline import scripts as jscripts
from relate_tpu_torch.evaluate import selection as tsel
from relate_tpu_torch.io import ancmut as tancmut
from relate_tpu_torch.io import extract as textract
from relate_tpu_torch.pipeline import scripts as tscripts

torch.set_num_threads(1)

EPOCHS = jcoalrate.default_epochs(28.0)


@pytest.fixture(scope="module")
def pairs(golden_dir):
    """The reference's final ``golden.anc/.mut`` (N = 8, 9,412 trees, every
    SNP of the example), read by each package's own reader."""
    prefix = str(golden_dir / "golden")
    return jscripts._load_pair(prefix), tscripts._load_pair(prefix)


@pytest.fixture(scope="module")
def scans(pairs):
    """``selection_scan`` of both packages over every SNP of the pair."""
    (ja, jr, jbp, _, jrs, _), (ta, tr, tbp, _, trs, _) = pairs
    return (jsel.selection_scan(ja, jr, EPOCHS, jbp, jrs),
            tsel.selection_scan(ta, tr, EPOCHS, tbp, trs, device="cpu"))


def _rows_equal(jrows, trows):
    assert len(jrows) == len(trows)
    n = 0
    for a, b in zip(jrows, trows):
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
        n += 1
    return n


def _pvalues(scan):
    return np.asarray([np.concatenate([r["pvalues"], [r["p_half"],
                                                      r["p_freq2"]]])
                       for r in scan if r is not None])


def test_golden_pair_matches_jax(scans):
    (jrows, jscan), (trows, tscan) = scans
    assert _rows_equal(jrows, trows) > 100_000
    assert [r is None for r in jscan] == [r is None for r in tscan]
    jp, tp = _pvalues(jscan), _pvalues(tscan)
    assert jp.shape == tp.shape and (jp < 0).sum() > 100_000
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-10)


def test_compute_freq_lin_alone_matches_jax(pairs):
    """``compute_freq_lin`` by itself, on the first 3,000 SNPs."""
    (ja, jr, jbp, _, jrs, _), (ta, tr, tbp, _, trs, _) = pairs
    assert _rows_equal(
        jsel.compute_freq_lin(ja, jr[:3000], EPOCHS, jbp, jrs),
        tsel.compute_freq_lin(ta, tr[:3000], EPOCHS, tbp, trs,
                              device="cpu")) > 2000


def _tails(N, n, seed):
    """Seeded (k, fk, fN) at width N, with every masked case."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-1, N + 1, n)
    fk = rng.integers(0, N + 1, n)
    fN = rng.integers(0, N + 1, n)
    # the masked cases: fk < 2, k = -1, fN >= N, fk >= k, fN = 0
    k[:5], fk[:5], fN[:5] = [9, -1, 9, 3, 9], [1, 3, 3, 3, 3], \
        [5, 5, N, 5, 0]
    if N > 9:
        # rows that are defined, from a tail of a single term to N terms
        m = n // 2
        k[5:m] = rng.integers(3, N, m - 5)
        fk[5:m] = rng.integers(2, k[5:m])
        fN[5:m] = np.minimum(fk[5:m] + rng.integers(0, N, m - 5), N - 1)
    return k, fk, fN


@pytest.mark.parametrize("N", [8, 64, 2048])
def test_log_pvalue_batch_matches_jax(N):
    n = 400 if N == 2048 else 2000
    k, fk, fN = _tails(N, n, seed=N)
    logF = np.zeros(N + 1)
    logF[1:] = np.cumsum(np.log(np.arange(1, N + 1)))
    want = jsel.log_pvalue_batch(k, fk, N, fN, logF)
    valid = (fk >= 2) & (k != -1) & (fN < N) & (fk < k) & (fN > 0)
    assert 0 < valid.sum() < n and (want[~valid] == 1).all()
    assert (want[valid] <= 0).all()
    from relate_tpu_torch.utils import trace
    for max_cells in (None, 3 * N):
        with trace.stage("pvalues", verbose=False):
            got = tsel.log_pvalue_batch(k, fk, N, fN, logF,
                                        max_cells=max_cells, device="cpu")
        rec = trace.STAGES.pop()["log_pvalue"][0]
        assert rec["rows"] == valid.sum()
        if max_cells is not None:
            assert rec["chunks"] > 3
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)
        assert (got[~valid] == 1).all()
    i = int(np.nonzero(valid)[0][-1])
    assert math.isclose(tsel.log_pvalue(k[i], fk[i], N, fN[i], logF),
                        jsel.log_pvalue(k[i], fk[i], N, fN[i], logF),
                        rel_tol=0, abs_tol=1e-10)


def test_log_pvalue_batch_with_no_defined_tail():
    logF = np.zeros(9)
    logF[1:] = np.cumsum(np.log(np.arange(1, 9)))
    got = tsel.log_pvalue_batch([3, -1], [1, 2], 8, [4, 4], logF,
                                device="cpu")
    assert np.array_equal(got, [1.0, 1.0])


def test_sample_ages_match_jax(pairs):
    """A tree sequence with sample ages: 400 trees of the pair, three of the
    eight haplotypes dated (node times, and so the counts, move)."""
    (ja, jr, jbp, _, jrs, _), (ta, tr, tbp, _, trs, _) = pairs
    lo, hi = jbp[0], jbp[2999]
    sub = []
    for ext, a, r, bp in ((jextract, ja, jr, jbp), (textract, ta, tr, tbp)):
        s, sm, _ = ext.anc_mut_for_subregion(a, r, bp, lo, hi)
        s.sample_ages = np.asarray([0, 0, 0, 0, 0, 150.0, 900.0, 4000.0])
        sub.append((s, sm))
    (js, jm), (ts, tm) = sub
    jrows, jscan = jsel.selection_scan(js, jm, EPOCHS, jbp, jrs)
    trows, tscan = tsel.selection_scan(ts, tm, EPOCHS, tbp, trs,
                                       device="cpu")
    assert _rows_equal(jrows, trows) > 2000
    plain = tsel.compute_freq_lin(ts, tm, EPOCHS, tbp, trs, device="cpu")
    ts.sample_ages = None
    moved = tsel.compute_freq_lin(ts, tm, EPOCHS, tbp, trs, device="cpu")
    assert sum(not np.array_equal(a["freq"], b["freq"])
               for a, b in zip(plain, moved) if a is not None) > 100
    np.testing.assert_allclose(_pvalues(tscan), _pvalues(jscan), rtol=0,
                               atol=1e-10)


def test_sds_quality_freq_diff_match_jax(pairs):
    (ja, jr, jbp, _, jrs, _), (ta, tr, tbp, _, trs, _) = pairs
    js, ts = jsel.sds(ja, jr, jbp, jrs), tsel.sds(ta, tr, tbp, trs,
                                                  device="cpu")
    assert [r is None for r in js] == [r is None for r in ts]
    pairs_ = [(a, b) for a, b in zip(js, ts) if a is not None]
    assert len(pairs_) > 100_000
    assert all(a["snp"] == b["snp"] and a["pos"] == b["pos"]
               and a["rsid"] == b["rsid"] for a, b in pairs_)
    np.testing.assert_allclose([b["rSDS"] for _, b in pairs_],
                               [a["rSDS"] for a, _ in pairs_], rtol=1e-12,
                               atol=0)
    jq, tq = jsel.quality(ja, jr), tsel.quality(ta, tr)
    for k in jq:
        assert np.array_equal(jq[k], tq[k]), k
    rows = tsel.compute_freq_lin(ta, tr[:3000], EPOCHS, tbp, trs,
                                 device="cpu")
    (jd, jz), (td, tz) = jsel.freq_diff(rows, 8), tsel.freq_diff(rows, 8)
    assert sum(r is not None for r in tz) > 1000
    for a, b in zip(jd + jz, td + tz):
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for k in a:
                x, y = np.asarray(a[k]), np.asarray(b[k])
                assert np.array_equal(x, y, equal_nan=x.dtype.kind == "f"), k


def _near_rounding(p):
    """Per value of p: whether a %.4g rounding boundary, (m + 1/2) *
    10^(e-3) for the decimal exponent e of |p|, lies within 1e-9 of it."""
    x = np.abs(np.asarray(p, np.float64))
    nz = x > 0
    unit = 10.0 ** (np.floor(np.log10(np.where(nz, x, 1.0))) - 3)
    frac = x / unit - np.floor(x / unit)
    return nz & (np.abs(frac - 0.5) * unit < 1e-9)


def test_the_four_writers_write_the_jax_bytes(pairs, scans, tmp_path):
    """The writers on the first 20,000 SNPs' rows."""
    n = 20_000
    (ja, jr, jbp, _, jrs, _), (ta, tr, tbp, _, trs, _) = pairs
    (jrows, jscan), (trows, tscan) = scans
    jrows, jscan, trows, tscan = jrows[:n], jscan[:n], trows[:n], tscan[:n]
    for pkg, rows, scan in (("jax", jrows, jscan), ("port", trows, tscan)):
        mod = jsel if pkg == "jax" else tsel
        o = str(tmp_path / pkg)
        mod.write_freq_lin(o, rows, EPOCHS)
        mod.write_sele(o + ".sele", scan, EPOCHS)
        mod.write_freqdiff(o, *mod.freq_diff(rows, 8), EPOCHS)
    jsel.write_sds(str(tmp_path / "jax.sds"), jsel.sds(ja, jr[:n], jbp, jrs))
    tsel.write_sds(str(tmp_path / "port.sds"),
                   tsel.sds(ta, tr[:n], tbp, trs, device="cpu"))
    for ext in (".freq", ".lin", ".freqdiff", ".zfreqdiff", ".sds"):
        assert filecmp.cmp(tmp_path / f"jax{ext}", tmp_path / f"port{ext}",
                           shallow=False), ext
    jl = (tmp_path / "jax.sele").read_text().splitlines()
    tl = (tmp_path / "port.sele").read_text().splitlines()
    assert len(jl) == len(tl) > 15_000
    # a line may differ only where one of its p-values lies within 1e-9 of
    # a rounding boundary of its text; such lines are counted, and there
    # are none on these inputs
    near = _near_rounding(_pvalues(tscan)).any(axis=1)
    differ = [i for i, (a, b) in enumerate(zip(jl[1:], tl[1:])) if a != b]
    assert jl[0] == tl[0] and set(differ) <= set(np.nonzero(near)[0])
    assert len(differ) == 0
    assert _near_rounding([0.12341, 0.1234 + 0.00005, 1.0, 0.0]).tolist() \
        == [False, True, False, False]


# ---------------------------------------------------------------------------
# the port against the C++ reference's own outputs (twins of
# tests/test_evaluate.py:40-124), the pair read by the port's readers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_pair(golden_dir):
    anc = tancmut.read_anc_text(str(golden_dir / "golden.anc"))
    md = tancmut.read_mut_final(str(golden_dir / "golden.mut"))
    from relate_tpu_torch.core.topology import MutationRecord
    recs = [MutationRecord(tree=m["tree"], branch=m["branch"],
                           flipped=bool(m["flipped"])) for m in md]
    bp = np.array([m["pos"] for m in md])
    rsid = [m["rsid"] for m in md]
    return anc, recs, bp, rsid


def _load_ref(path):
    out = {}
    with open(path) as f:
        f.readline()
        for line in f:
            p = line.split()
            out[int(p[0])] = p[2:]
    return out


@pytest.mark.golden
def test_port_freq_lin_sele_match_reference(golden_dir, port_pair):
    anc, recs, bp, rsid = port_pair
    rows, scan = tsel.selection_scan(anc, recs[:800], EPOCHS, bp, rsid,
                                     device="cpu")
    gf = _load_ref(golden_dir / "goldenfreq.freq.head")
    gl = _load_ref(golden_dir / "goldenfreq.lin.head")
    gs = _load_ref(golden_dir / "goldensel.sele.head")
    ncmp = 0
    for row, sc in zip(rows, scan):
        if row is None or row["pos"] not in gf:
            continue
        ncmp += 1
        assert np.array_equal(row["freq"],
                              [int(float(x)) for x in gf[row["pos"]][:31]])
        lg = gl[row["pos"]]
        assert np.array_equal(row["lin"], [int(float(x)) for x in lg[:31]])
        assert row["lin_when_half"] == int(lg[-2])
        assert row["lin_when_freq2"] == int(lg[-1])
        mine = np.concatenate([sc["pvalues"], [sc["p_half"], sc["p_freq2"]]])
        gold = np.asarray([float(x) for x in gs[row["pos"]]])
        np.testing.assert_allclose(mine, gold, atol=1e-4)
    assert ncmp > 500


@pytest.mark.golden
def test_port_sds_matches_reference(golden_dir, port_pair):
    anc, recs, bp, rsid = port_pair
    gold = {int(k): v[0] for k, v in
            _load_ref(golden_dir / "ref_sds_head.SDS").items()}
    ncmp = 0
    for r in tsel.sds(anc, recs, bp, rsid, device="cpu"):
        if r is None or r["pos"] not in gold:
            continue
        assert f"{r['rSDS']:g}" == gold[r["pos"]], r
        ncmp += 1
    assert ncmp > 1500


@pytest.mark.golden
def test_port_freqdiff_matches_reference(golden_dir, port_pair):
    anc, recs, bp, rsid = port_pair
    gold = _load_ref(golden_dir / "ref_freqdiff_head")
    last = max(gold)
    n = int(np.searchsorted(bp, last, side="right"))
    rows = tsel.compute_freq_lin(anc, recs[:n], EPOCHS, bp, rsid,
                                 device="cpu")
    diffs, _ = tsel.freq_diff(rows, anc.N)
    ncmp = 0
    for r in diffs:
        if r is None or r["pos"] not in gold:
            continue
        mine = [f"{x:g}" for x in r["diff"][::-1]] + [str(r["fN"])]
        assert mine == gold[r["pos"]], r["pos"]
        ncmp += 1
    assert ncmp > 150
