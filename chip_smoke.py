#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path (MakeChunks -> Paint -> BuildTopology through
``relate_tpu_torch.pipeline.relate``) at N = 1024 haplotypes and L = 16384
SNPs of a seeded synthetic panel, builds the CUDA kernels from
``relate_tpu_torch/csrc``, holds every kernel against its plain PyTorch
version on the card, and checks the artifacts it wrote. Phases, each
printing one JSON line: ``device``, ``build``, ``kernels``, ``main_path``,
``cpu_vs_card``; then the ``{"kernels": [...]}`` line, the card's name and
power limit as ``nvidia-smi`` gives them, and the result line. Any phase
that fails ends the run with a non-zero exit code. Needs a CUDA device and
no network. ``--phases a,b`` runs a subset (the build always runs);
``--phases profile`` adds a ``torch.profiler`` breakdown of Paint and of one
section of BuildTopology, which the default run leaves out.

How the kernels are compared. The sweeps rescale a row whenever its sum
leaves [1e-10, 1e10]; the kernel and the plain version add the row in
another order, so a sum that lands within rounding of a threshold can move
one rescale by a row. Such a row carries the same state at another scale:
the row times c, its logscale minus log c. Rows are therefore compared
with the scale taken out: row / sum(row) at rtol 1e-5 (atol 1e-12) and
logscale + log(sum(row)) at atol 2e-3, on the valid rows; rows at and
past D[b] of the backward outputs must be exactly zero. ``max_abs_err`` is
the largest difference of the rows normalised to sum 1. ``rows_rescaled_
elsewhere`` counts the rows that differ before the scale is taken out.
The merge scan's outputs (cis, cjs, clades) must be equal exactly.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_HAP = 1024
L_SNPS = 16384
SEED = 20240611
THETA = 0.001
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
TIME_BUDGET_S = 560.0          # further sections are built while under this
SMALLER_MEMORY_GB = 2.5        # gives this panel 3 windows of about 6,000 SNPs
DEV = "cuda"                   # the port's entry points get this device

T_START = time.time()


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ---------------------------------------------------------------------------
# timing and comparison helpers
# ---------------------------------------------------------------------------

def time_ms(fn, reps):
    fn()                                    # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def compare_rows(name, got, ls_got, ref, ls_ref, valid):
    """Scale-free comparison of (..., N) rows with their logscales (see the
    module docstring). ``valid`` masks the rows that carry a state.
    Returns (max_abs_err of normalised rows, rows off before normalising)."""
    s_got = got.sum(dim=-1)
    s_ref = ref.sum(dim=-1)
    ok_rows = valid & (s_ref > 0)
    if not bool((s_got[ok_rows] > 0).all()):
        fail(f"{name}: a valid row of the kernel sums to zero")
    one = torch.ones_like(s_ref)
    ng = got / torch.where(ok_rows, s_got, one)[..., None]
    nr = ref / torch.where(ok_rows, s_ref, one)[..., None]
    diff = (ng - nr).abs()
    tol = 1e-5 * nr.abs() + 1e-12
    bad = ((diff > tol) & ok_rows[..., None]).sum().item()
    tg = ls_got + torch.log(torch.where(ok_rows, s_got, one))
    tr = ls_ref + torch.log(torch.where(ok_rows, s_ref, one))
    ls_err = ((tg - tr).abs() * ok_rows).max().item()
    if bad or not ls_err <= 2e-3:
        fail(f"{name}: kernel and plain version disagree: {bad} elements "
             f"beyond rtol 1e-5, logscale error {ls_err:.3g}")
    direct = (((got - ref).abs() > 1e-5 * ref.abs() + 1e-30).any(dim=-1)
              & ok_rows).sum().item()
    return (diff * ok_rows[..., None]).max().item(), int(direct)


def rows_valid(D, Dmax):
    j = torch.arange(Dmax, device=D.device)[:, None]
    return j < D[None, :].long()


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", kind=name, count=torch.cuda.device_count(),
         nvidia_smi=line, torch=torch.__version__, cuda=torch.version.cuda)
    return line


def phase_build():
    from relate_tpu_torch.ops import _build
    t0 = time.time()
    logs = _build.build_all(verbose=True)
    for name in _build.SOURCES:
        _build.load(name)
    ptxas = {k: [ln for ln in v.splitlines()
                 if "registers" in ln or "spill" in ln][:12]
             for k, v in logs.items()}
    emit("build", seconds=round(time.time() - t0, 2),
         sources=[f"relate_tpu_torch/csrc/{n}.cu" for n in _build.SOURCES],
         ptxas=ptxas)


def make_panel():
    from relate_tpu_torch.utils import synth
    G, bp = synth.synth_coalescent_panel(N_HAP, L_SNPS, seed=SEED)[:2]
    return np.ascontiguousarray(G, dtype=np.uint8), bp


def phase_kernels(G, bp, memory_gb):
    """Each kernel against its plain version on the card, at the shapes of
    the main path: the plan of the panel's middle window (both capture
    kernels have work there) and N x N merge matrices."""
    from relate_tpu_torch.core import painting
    from relate_tpu_torch.core.distance import _assemble_ops
    from relate_tpu_torch.core.treebuilder import thresholds
    from relate_tpu_torch.io import chunking
    from relate_tpu_torch.io import haps as hio
    from relate_tpu_torch.ops import merge_scan as ms
    from relate_tpu_torch.ops import paint_kernels as pk

    dev = torch.device(DEV)
    L, N = G.shape
    gmap = hio.GeneticMap(np.array([0.0, float(bp[-1]) + 2e6]),
                          np.array([0.0, (float(bp[-1]) + 2e6) / 1e6]))
    r = hio.rates_from_rpos(hio.interpolate_rpos(gmap, bp))
    _, wplans = chunking.plan_chunks_and_windows(G, memory_gb)
    bounds = np.asarray(wplans[0].boundaries)
    W = len(bounds) - 1
    if W < 3:
        fail(f"kernels: expected >= 3 windows, got {W}")
    model = painting.PaintingModel(N=N, theta=THETA)
    painter = painting.Painter(G, r, model, device=dev)
    bsb, bse = painter.window_boundary_sites(bounds)
    w = 1
    targets = np.arange(N, dtype=np.int32)
    prep = painter._prep(targets, bsb[w], bse[w],
                         final_raw=painter._extended_final_raw(bse[w]))
    D, mism, pfac, nxt, kmask = (prep[k] for k in
                                 ("D", "mism", "pfac", "nxt", "kmask"))
    Dmax, B, _ = mism.shape
    a0 = painter._to_dev(painting.initial_alpha(G, model, 0, targets))
    be = torch.ones((N, N), dtype=torch.float32, device=dev)
    to_i32 = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    want_f = to_i32(painter._rows_of_sites(prep, targets, bsb[w + 1]))
    want_b = to_i32(painter._rows_of_sites(prep, targets, bse[w - 1]))
    valid = rows_valid(D, Dmax)
    Dl = D.long()
    all_b = torch.ones(B, dtype=torch.bool, device=dev)
    res = []

    def record(name, source, replaces, err, direct, ms_k, ms_p, nbytes, ops,
               **extra):
        b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
        res.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms_k, plain_ms=ms_p,
            bound_ms=max(b_ms, o_ms),
            bound_by="bytes" if b_ms >= o_ms else "operations",
            library_ms=None, rows_rescaled_elsewhere=direct,
            bytes=int(nbytes), operations=int(ops), **extra))

    small = 3 * B * N * 4 + 2 * B * Dmax * 4 + Dmax * B * 4
    cells = int(Dl.sum().item())            # valid (row, target) pairs

    # B1 forward
    fk = lambda: pk.fwd(D, a0, kmask, mism, pfac, nxt, theta=THETA)  # noqa: E731
    fp = lambda: pk.fwd_plain(D, a0, kmask, mism, pfac, nxt, theta=THETA)  # noqa: E731
    al_k, ls_k = fk()
    al_p, ls_p = fp()
    torch.cuda.synchronize()
    err, direct = compare_rows("paint_fwd", al_k, ls_k, al_p, ls_p,
                               torch.ones_like(valid))
    del al_p, ls_p
    record("paint_fwd", "relate_tpu_torch/csrc/paint_fwd.cu",
           "relate_tpu/ops/paint_kernels.py:233", err, direct,
           time_ms(fk, 3), time_ms(fp, 1),
           (cells - B) * N + Dmax * B * N * 4 + small, 6 * cells * N,
           shape=[Dmax, B, N])

    # B2 backward + posterior (and its beta-emitting mode)
    for emit_beta in (False, True):
        bk = lambda: pk.bwd(D, be, kmask, mism, pfac, nxt, al_k, ls_k,  # noqa: E731
                            theta=THETA, emit_beta=emit_beta)
        bpl = lambda: pk.bwd_plain(D, be, kmask, mism, pfac, nxt, al_k, ls_k,  # noqa: E731
                                   theta=THETA, emit_beta=emit_beta)
        to_k, lt_k = bk()
        to_p, lt_p = bpl()
        torch.cuda.synchronize()
        nm = "paint_bwd" + ("[emit_beta]" if emit_beta else "")
        err, direct = compare_rows(nm, to_k, lt_k, to_p, lt_p, valid)
        if bool((to_k * ~valid[..., None]).any()) or \
                bool((lt_k * ~valid).any()):
            fail(f"{nm}: rows at and past D are not zero")
        del to_p, lt_p
        if not emit_beta:
            topo, lstot = to_k, lt_k
            record("paint_bwd", "relate_tpu_torch/csrc/paint_bwd.cu",
                   "relate_tpu/ops/paint_kernels.py:284", err, direct,
                   time_ms(bk, 3), time_ms(bpl, 1),
                   cells * N * 5 + Dmax * B * N * 4 + small + Dmax * B * 4,
                   8 * cells * N, shape=[Dmax, B, N])
        else:
            res[-1]["emit_beta_max_abs_err"] = err
        del to_k, lt_k
    del al_k, ls_k

    # B3 / B4 capture variants
    ck = lambda: pk.fwd_capture(D, want_f, a0, kmask, mism, pfac, nxt,  # noqa: E731
                                theta=THETA)
    cp_ = lambda: pk.fwd_capture_plain(D, want_f, a0, kmask, mism, pfac,  # noqa: E731
                                       nxt, theta=THETA)
    (ac_k, lc_k), (ac_p, lc_p) = ck(), cp_()
    torch.cuda.synchronize()
    err, direct = compare_rows("paint_fwd_capture", ac_k, lc_k, ac_p, lc_p,
                               all_b)
    rows_f = int(torch.minimum(want_f.long(), Dl - 1).sum().item())
    record("paint_fwd_capture", "relate_tpu_torch/csrc/paint_fwd.cu",
           "relate_tpu/ops/paint_kernels.py:394", err, direct,
           time_ms(ck, 3), time_ms(cp_, 1),
           rows_f * N + 3 * B * N * 4 + 2 * B * Dmax * 4, 6 * rows_f * N,
           shape=[Dmax, B, N])

    ck = lambda: pk.bwd_capture(D, want_b, be, kmask, mism, pfac, nxt,  # noqa: E731
                                theta=THETA)
    cp_ = lambda: pk.bwd_capture_plain(D, want_b, be, kmask, mism, pfac,  # noqa: E731
                                       nxt, theta=THETA)
    (bc_k, lc_k), (bc_p, lc_p) = ck(), cp_()
    torch.cuda.synchronize()
    hit = want_b.long() < Dl
    err, direct = compare_rows("paint_bwd_capture", bc_k, lc_k, bc_p, lc_p,
                               hit)
    if bool((bc_k * ~hit[:, None]).any()):
        fail("paint_bwd_capture: a target with no wanted row is not zero")
    rows_b = int(((Dl - want_b.long()) * hit).sum().item())
    record("paint_bwd_capture", "relate_tpu_torch/csrc/paint_bwd.cu",
           "relate_tpu/ops/paint_kernels.py:515", err, direct,
           time_ms(ck, 3), time_ms(cp_, 1),
           rows_b * N + 3 * B * N * 4 + 2 * B * Dmax * 4, 8 * rows_b * N,
           shape=[Dmax, B, N])
    del ac_k, ac_p, bc_k, bc_p

    # B5 merge scan: a distance matrix assembled from the posterior above
    # (use_cf off, then on with the clade prior of the first tree) and a
    # tie-heavy integer matrix that leans on the hash
    thr, thr_cf = thresholds(THETA)
    val = -float(np.log(THETA / (1.0 - THETA)))
    rows = torch.clamp(Dl // 2, max=Dmax - 2)
    half = torch.full((B,), 0.5, dtype=torch.float32, device=dev)
    exact = torch.arange(B, device=dev) % 3 == 0
    mat = _assemble_ops(topo, lstot, rows, exact, half, half,
                        torch.arange(B, device=dev)).contiguous()
    del topo, lstot
    zeros = torch.zeros_like(mat)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ties = torch.randint(0, 4, (N, N), generator=gen).to(torch.float32).to(dev)
    ties_cf = torch.randint(0, 3, (N, N), generator=gen).to(
        torch.float32).to(dev)
    worst, ms_k, ms_p, detail = 0.0, None, None, []
    # the second case takes its clade prior from the first one's tree
    _, _, cl0 = ms.merge_scan(mat, zeros, False, thr, thr_cf, 12345)
    dcf1 = (val * (cl0.t() @ (1.0 - cl0))).contiguous()
    cases = [("posterior", mat, zeros, False, 12345),
             ("posterior+clade_prior", mat + 0.25 * ties, dcf1, True, 777),
             ("ties", ties, ties_cf, True, 4242)]
    for label, d_, dcf_, ucf, seed in cases:
        d_ = d_.contiguous()
        k = ms.merge_scan(d_, dcf_, ucf, thr, thr_cf, seed)
        p = ms.merge_scan_plain(d_, dcf_, ucf, thr, thr_cf, seed)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k, p))
        detail.append({"case": label, "use_cf": ucf, "equal": same})
        if not same:
            t_bad = int((k[0] != p[0]).nonzero()[0]) if \
                bool((k[0] != p[0]).any()) else -1
            fail(f"merge_scan[{label}]: merge lists differ from the plain "
                 f"version (first at step {t_bad})")
        worst = max(worst, float((k[2] - p[2]).abs().max().item()))
        if label == "posterior+clade_prior":
            fn_k = lambda: ms.merge_scan(d_, dcf_, ucf, thr, thr_cf, seed)  # noqa: E731
            fn_p = lambda: ms.merge_scan_plain(d_, dcf_, ucf, thr, thr_cf,  # noqa: E731
                                               seed)
            ms_k, ms_p = time_ms(fn_k, 3), time_ms(fn_p, 1)
    live_pairs = sum((N - t) * (N - t - 1) for t in range(N - 1))
    record("merge_scan", "relate_tpu_torch/csrc/merge_scan.cu",
           "relate_tpu/ops/merge_scan.py:371", worst, 0, ms_k, ms_p,
           2 * N * N * 4 + (N - 1) * N * 4 + 2 * (N - 1) * 4,
           9 * live_pairs, shape=[N, N], cases=detail,
           live_bytes_ms=live_pairs * 16 / HBM_BYTES_PER_S * 1e3)
    emit("kernels", kernels=res,
         tolerance="sweeps: rows/sum rtol 1e-5, logscale+log(sum) atol 2e-3; "
                   "merge scan: exact")
    return res


def check_section(store, w, N, n_snps_expected):
    from relate_tpu_torch.io import ancmut
    anc = ancmut.read_anc_bin(store.path("chunk_0", f"trees_{w}.anc"))
    muts = ancmut.read_mut_short(store.path("chunk_0", f"muts_{w}.mut"))
    M = 2 * N - 1
    if anc.N != N or not anc.seq:
        fail(f"section {w}: empty or wrong-sized .anc")
    prev = -1
    for mt in anc.seq:
        tr = mt.tree
        par = np.asarray(tr.parent)
        if par.shape != (M,) or par[M - 1] != -1 or (par[:M - 1] < N).any() \
                or (par[:M - 1] <= np.arange(M - 1)).any():
            fail(f"section {w}: tree at {mt.pos} is not a merge-ordered tree")
        kids = np.bincount(par[:M - 1], minlength=M)
        if (kids[N:] != 2).any() or kids[:N].any():
            fail(f"section {w}: tree at {mt.pos} is not binary on {N} leaves")
        if not np.isfinite(tr.num_events).all():
            fail(f"section {w}: non-finite event counts")
        if mt.pos <= prev or (tr.SNP_begin > tr.SNP_end).any() \
                or (tr.SNP_begin != mt.pos).any():
            fail(f"section {w}: pos / SNP_begin / SNP_end out of order")
        prev = mt.pos
    if len(muts) != n_snps_expected:
        fail(f"section {w}: {len(muts)} mutation records for "
             f"{n_snps_expected} SNPs")
    for m in muts:
        if not 0 <= m.tree < len(anc.seq):
            fail(f"section {w}: a record names tree {m.tree}")
    n_unmapped = sum(1 for m in muts if not m.branch)
    n_multi = sum(1 for m in muts if m.is_not_mapping)
    return dict(section=w, trees=len(anc.seq), snps=len(muts),
                not_mapping=n_multi, no_carrier=n_unmapped,
                not_mapping_share=n_multi / len(muts))


def phase_main_path(G, bp, memory_gb, kernels):
    """MakeChunks -> Paint -> BuildTopology through the port's entry points,
    with every launch count set to 0 just before and read just after."""
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.ops import merge_scan as ms
    from relate_tpu_torch.ops import paint_kernels as pk
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth
    from relate_tpu_torch.utils.trace import stage, STAGES

    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        t0 = time.time()
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        t_inputs = time.time() - t0

        for k in pk.launches:
            pk.launches[k] = 0
        ms.launches["merge_scan"] = 0
        del STAGES[:]

        out = os.path.join(tmp, "store")
        with stage("MakeChunks", verbose=False):
            relate.make_chunks(prefix + ".haps", prefix + ".sample",
                               os.path.join(tmp, "map.txt"), out,
                               memory_gb=memory_gb, device=DEV)
        store = ArtifactStore(out)
        ch = store.load_chunk(0)
        bounds = ch.windows.boundaries
        W = len(bounds) - 1
        if ch.N != N_HAP or W < 3:
            fail(f"main_path: N = {ch.N}, W = {W}; wanted N = {N_HAP}, "
                 "W >= 3")
        cache = {}
        with stage("Paint", verbose=False):
            relate.paint(store, 0, theta=THETA, cache=cache, device=DEV)
        for w in range(W):
            if not os.path.exists(store.path("chunk_0", f"paint_{w}.npz")):
                fail(f"main_path: paint_{w}.npz was not written")
        built = []
        with stage("BuildTopology[0]", verbose=False):
            relate.build_topology(store, 0, seed=1, theta=THETA, cache=cache,
                                  first_section=0, last_section=0,
                                  device=DEV)
        built.append(0)
        for w in range(1, W):
            per_section = STAGES[-1]["wall_s"]
            if time.time() - T_START + 1.5 * per_section > TIME_BUDGET_S:
                break
            with stage(f"BuildTopology[{w}]", verbose=False):
                relate.build_topology(store, 0, seed=1, theta=THETA,
                                      first_section=w, last_section=w,
                                      device=DEV)
            built.append(w)
        torch.cuda.synchronize()
        counts = {"paint_fwd": pk.launches["fwd"],
                  "paint_bwd": pk.launches["bwd"],
                  "paint_fwd_capture": pk.launches["fwd_capture"],
                  "paint_bwd_capture": pk.launches["bwd_capture"],
                  "merge_scan": ms.launches["merge_scan"]}
        # every stage() sets the peak counter back, so the run's peak is the
        # largest of the stages' own peaks
        peak = max(r.get("dev_peak_mb", 0.0) for r in STAGES) * 1e6

        sections = []
        for w in built:
            end = (bounds[w + 1] - 1) if w < W - 1 else ch.L - 1
            sections.append(check_section(store, w, ch.N,
                                          end - bounds[w] + 1))
        z = np.load(store.path("chunk_0", "paint_1.npz"))
        for key in ("alpha", "beta", "ls_alpha", "ls_beta"):
            if not np.isfinite(z[key]).all():
                fail(f"main_path: paint_1.npz {key} is not finite")
        if z["alpha"].shape != (ch.N, ch.N) or not (z["alpha"] >= 0).all():
            fail("main_path: paint_1.npz alpha has the wrong shape or sign")

    for k in kernels:
        k["launches"] = counts[k["name"]]
    missing = [n for n, c in counts.items() if c <= 0]
    emit("main_path", N=int(ch.N), L=int(ch.L), windows=W,
         boundaries=[int(b) for b in bounds], memory_gb=memory_gb,
         sections_built=built, sections=sections,
         stages=[{k: r.get(k) for k in ("stage", "wall_s", "cpu_s",
                                         "dev_peak_mb")}
                 for r in STAGES],
         write_inputs_s=round(t_inputs, 2), launches=counts,
         peak_device_memory_gb=round(peak / 1e9, 3))
    if missing:
        fail(f"main_path: kernels never launched: {missing}")


def phase_profile(G, bp, memory_gb):
    """Optional (``--phases profile``): Paint and one section of
    BuildTopology under ``torch.profiler``; prints the device's busy share
    of the wall time and the kernels that take most of the device time."""
    from torch.profiler import ProfilerActivity, profile
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth

    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        out = os.path.join(tmp, "store")
        relate.make_chunks(prefix + ".haps", prefix + ".sample",
                           os.path.join(tmp, "map.txt"), out,
                           memory_gb=memory_gb, device=DEV)
        store = ArtifactStore(out)
        rows = {}
        for name, fn in (
                ("Paint", lambda: relate.paint(store, 0, theta=THETA,
                                               device=DEV)),
                ("BuildTopology[1]", lambda: relate.build_topology(
                    store, 0, seed=1, theta=THETA, first_section=1,
                    last_section=1, device=DEV))):
            torch.cuda.synchronize()
            t0 = time.time()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            wall = time.time() - t0
            dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                                       getattr(e, "self_cuda_time_total", 0))
            evs = [e for e in prof.key_averages() if dev_us(e) > 0]
            busy = sum(dev_us(e) for e in evs) / 1e6
            top = sorted(evs, key=dev_us, reverse=True)[:8]
            rows[name] = dict(
                wall_s_profiled=round(wall, 3), device_busy_s=round(busy, 4),
                device_busy_share=round(busy / wall, 4),
                top=[[e.key[:60], round(dev_us(e) / 1e3, 3), e.count]
                     for e in top])
    emit("profile", note="wall time includes the profiler's overhead; "
         "top = [kernel, device ms, calls]", **rows)


def phase_cpu_vs_card():
    """The three stages at N = 64 on the card (kernels) and on the CPU
    (plain versions) from the same files."""
    from relate_tpu_torch.io import ancmut
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth

    N, L = 64, 2000
    G, bp = synth.synth_coalescent_panel(N, L, seed=SEED + 1)[:2]
    out = {}
    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        prefix = os.path.join(tmp, "p")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        for dev in (DEV, "cpu"):
            sd = os.path.join(tmp, "store_" + dev)
            relate.make_chunks(prefix + ".haps", prefix + ".sample",
                               os.path.join(tmp, "map.txt"), sd,
                               memory_gb=0.0008, device=dev)
            store = ArtifactStore(sd)
            relate.paint(store, 0, theta=THETA, device=dev)
            relate.build_topology(store, 0, seed=1, theta=THETA, device=dev)
            W = len(store.load_chunk(0).windows.boundaries) - 1
            cps = [np.load(store.path("chunk_0", f"paint_{w}.npz"))
                   for w in range(W)]
            trees = [len(ancmut.read_anc_bin(
                store.path("chunk_0", f"trees_{w}.anc")).seq)
                for w in range(W)]
            out[dev] = (W, [{k: z[k] for k in z.files} for z in cps], trees)
    (Wc, cps_c, trees_c), (Wh, cps_h, trees_h) = out[DEV], out["cpu"]
    if Wc != Wh or Wc < 2:
        fail(f"cpu_vs_card: windows {Wc} on the card, {Wh} on the CPU")
    worst = 0.0
    for a, b in zip(cps_c, cps_h):
        for slab, ls in (("alpha", "ls_alpha"), ("beta", "ls_beta")):
            if not np.array_equal(a["bsb"], b["bsb"]):
                fail("cpu_vs_card: boundary sites differ")
            sa, sb = a[slab].sum(axis=1), b[slab].sum(axis=1)
            na, nb = a[slab] / sa[:, None], b[slab] / sb[:, None]
            if not np.allclose(na, nb, rtol=1e-4, atol=1e-12):
                fail(f"cpu_vs_card: {slab} checkpoints differ beyond rtol "
                     "1e-4")
            tot = np.abs((a[ls] + np.log(sa)) - (b[ls] + np.log(sb))).max()
            if not tot <= 2e-3:
                fail(f"cpu_vs_card: {ls} differs by {tot}")
            worst = max(worst, float(np.abs(na - nb).max()))
    note = "equal"
    if trees_c != trees_h:
        # float32 sums are taken in another order on the card, and a merge
        # list is discrete, so one rebuild may be accepted on one device
        # and reverted on the other; more than a few is a fault
        gap = max(abs(x - y) for x, y in zip(trees_c, trees_h))
        if gap > max(3, 0.05 * max(trees_h)):
            fail(f"cpu_vs_card: tree counts {trees_c} on the card, "
                 f"{trees_h} on the CPU")
        note = ("differ within the accept/revert noise of summation order "
                "(float32 posterior rows feed a discrete merge list)")
    emit("cpu_vs_card", N=N, L=int(G.shape[0]), windows=Wc,
         checkpoint_max_abs_err_normalised=worst, trees_card=trees_c,
         trees_cpu=trees_h, tree_counts=note)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", default="kernels,main_path,cpu_vs_card")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card "
             "and does not fall back to the CPU")
    import relate_tpu_torch  # noqa: F401 - fail before any output without it
    torch.backends.cuda.matmul.allow_tf32 = False   # 0/1 operands stay exact
    smi_line = phase_device()
    phase_build()
    from relate_tpu_torch.io.chunking import plan_chunks_and_windows
    from relate_tpu_torch.utils.devmem import auto_memory_gb
    G, bp = make_panel()
    # the budget the card's memory gives; if this panel then has fewer than
    # 3 windows, a smaller budget is passed so that both capture kernels
    # have work (a middle window has a forward and a backward checkpoint)
    memory_auto = memory_gb = auto_memory_gb()
    if len(plan_chunks_and_windows(G, memory_gb)[1][0].boundaries) - 1 < 3:
        memory_gb = SMALLER_MEMORY_GB
    emit("inputs", N=int(G.shape[1]), L=int(G.shape[0]), seed=SEED,
         memory_gb_from_card=round(memory_auto, 3), memory_gb=memory_gb)
    kernels = []
    if "kernels" in phases:
        kernels = phase_kernels(G, bp, memory_gb)
        torch.cuda.empty_cache()
    if "main_path" in phases:
        phase_main_path(G, bp, memory_gb, kernels)
    if "cpu_vs_card" in phases:
        phase_cpu_vs_card()
    if "profile" in phases:
        phase_profile(G, bp, memory_gb)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in keys},
         **{k: v for k, v in r.items() if k not in keys and k != "cases"}}
        for r in kernels]}), flush=True)
    print(smi_line, flush=True)
    emit("done", seconds=round(time.time() - T_START, 1))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
