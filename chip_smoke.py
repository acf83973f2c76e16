#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``relate_tpu_torch/csrc``, holds every kernel
against its plain PyTorch version on the card, drives the port's main
paths through ``relate_tpu_torch.pipeline.relate``, its CLI and the tools'
CLI and checks what they wrote:

- ``run_all`` (``Relate --mode All``: MakeChunks -> Paint -> BuildTopology
  -> FindEquivalentBranches -> InferBranchLengths -> CombineSections ->
  Finalize) at N = 4096 haplotypes and L = 2048 SNPs of a seeded synthetic
  panel (its first 2,048 of 4,096): above 2048 every tree is built by the incremental merge scan;
- ``run_all`` at N = 2048 and L = 8192: the width at which the merge scan
  takes its large dense kernel;
- MakeChunks -> Paint -> BuildTopology at N = 1024 and L = 8192, the width
  of the merge-scan kernel that also emits the clade rows;
- ``run_all`` at N = 1024 and L = 2048 with sample ages (128 ancient
  haplotypes, 200 to 4,000 generations): the host topology builder, whose
  trees are all built by the age-aware scan (PyTorch ops), and the MCMC with
  ancient samples; the trees must hold the tips at their ages;
- MakeChunks -> Paint -> BuildTopology ``--anc_allele_unknown`` at N = 1024
  through the stage modes of ``pipeline/cli.py``: the host topology builder
  with symmetrised distances and flip coins, every tree built by the merge
  scan with clade rows (L = 4096);
- ``run_all(postprocess=True)`` at N = 2048 and L = 4096: PostProcess (one
  product a tree for the clade counts, the node loop on the host, every SNP
  mapped again) and FindEquivalentBranches again before the branch
  lengths; every window's records must map their own SNPs;
- OptimizeParameters at N = 1024 on a 2 x 2 grid of theta and rho over the
  first 151 SNPs (the stepping stones, the repaint and one merge scan a
  SNP); the CLI's ``--mode OptimizeParameters --input`` runs at its
  default on the N = 64 store of ``cpu_vs_card``;
- the CoalescentRate tool (``pipeline/tools_cli.py``) on the ``.anc``/
  ``.mut`` of ``run_all`` at N = 2048: EstimatePopulationSize with two
  groups and with ``--poplabels hap`` (a rate for each of the 2048 x 2048
  haplotype pairs), EstimatePopulationSizeEM (2 iterations),
  SampleBranchLengths (``.timeb``, 2 samples); and ReEstimateBranchLengths
  under the pairwise group prior on the output of a ``run_all`` of its own
  at N = 512 and L = 4096 (one proposal an iteration: at N = 2048 its
  chains take 430.8 s even replayed as CUDA graphs);
- the Selection, MutationRate and Extract tools on the same N = 2048
  output, with a fasta of random bases: Selection in its five modes and
  DetectSelection, MutationRate Avg, WithContext,
  ForCategoryForPopForChromosome and MutationDensity, Extract
  SubTreesForSubpopulation, AncMutForSubregion and
  RemoveTreesWithFewMutations, Selection on the subregion; then the
  selection scan's tails alone at a chromosome's size (50,000 SNPs);
- the mesh of every card of this host (``parallel.mesh.default_mesh()``;
  one card on a one-card host): the Painter at N = 1024 with the mesh
  against one card (bit for bit), ``run_all(mesh=)`` at N = 2048 whose
  files must equal the one-card ``run_all``'s byte for byte, with each
  kernel's launches by card (its InferBranchLengths on a pool of one
  process a card where there are several), InferBranchLengths of that
  run again through a pool of one process a card of the mesh (one worker
  on ``cuda:0`` on a one-card host) and in this process on the first
  card, each writing the same section files, ``run_mcmc(mesh=)`` on 9
  trees, ``coalescence_counts_psum`` and ``dryrun``; the CoalescentRate
  tool through ``--devices`` beside one card: EstimatePopulationSize with
  two groups on the ``run_all`` output at N = 2048, and
  EstimatePopulationSizeEM (one iteration) and SampleBranchLengths (one
  sample) on that output repeated along the chromosome to 305 trees, two
  chain parts, which go to a pool of one process a card (the files equal
  byte for byte); ``sample_branch_lengths`` on four parts of 256 chains
  through the phase's pool beside one card (one worker on ``cuda:0`` on a
  one-card host); with more than one card also ``reduce_sum`` beside
  ``torch.cuda.comm.reduce_add``, the chains' parts dealt from one thread,
  ``coalescence_stats``' batches dealt from one thread and from a thread a
  card, InferBranchLengths' chains dealt to the cards from one thread, and
  the Painter's stepping stones cut over the cards a thread a card with
  the host planner's share of each thread;
- BuildTopology of the bundled example (``tests/golden``, N = 8, the C++
  reference's chunk 0) over its first 12,000 SNPs on the card, through the
  merge scan with clade rows, against the reference's own trees with the
  bounds of ``tests/test_torch_golden.py``;
- ``--mode All`` on two hosts at N = 2048 and L = 4096: two processes of
  the port's CLI (``--num_hosts 2 --host_id k``) on one store, with chunk
  constants that plan the panel as two chunks, whose files must equal one
  host's;
- the interchange path at N = 2048 and L = 4096: the panel as a phased VCF
  whose REF is the derived allele at a tenth of the SNPs -> FileFormats
  ConvertFromVcf -> ``scripts.prepare_input_files`` with an ancestor fasta
  (which flips those SNPs back and drops 2 %), a mask (5 % N) and two
  groups of poplabels -> ``Relate --mode All`` through the port's CLI on
  the prepared ``.haps.gz``/``.sample``/``.dist``/``.annot`` (the native
  ``.haps`` parser and ``.anc`` writer, each held against its Python twin)
  -> ConvertToTreeSequence (a tskit ``.trees``, read back with the port's
  ``kastore.load``) -> TreeView's four modes -> Extract AncToNewick ->
  FileFormats ConvertFromNewick (every tree back) and ConvertNewickToTimeb;
  ``pairwise_tmrca`` and ``pearson_distance`` on the card and the CPU.

Phases, each printing one JSON line: ``device``, ``build``, ``inputs``,
``kernels`` (the incremental merge scan also at N = 2 ... 1000, the sizes
that leave blocks of its cluster of 8 empty or ragged, and with its
cluster's launch configuration; the dense scans likewise, with the grid
of their cooperative launch; the backward sweep and the capture sweeps
with the time a row of the longest chain takes, their launch configuration
(the backward sweep's with its bytes in flight a SM) and the share of rows
the full plain sweep rescales), ``main_path`` (N = 1024), ``run_all``
(N = 2048), ``run_all_n512`` and ``coalescent_rate`` (the tool's modes and
EM iterations in wall seconds, ``coalescence_stats`` a call with its
kernels and the card against the CPU, the chains' rounds, the device peak;
``--phases coalescent_rate`` runs both ``run_all`` it needs),
``selection_mutation_rate`` (each mode's wall seconds, the rows, chunks and
ms of ``log_pvalue_batch`` on the card and the CPU, ``compute_freq_lin``'s
ms a tree on both, the tails of 50,000 SNPs on the card, the device peak;
the card against the CPU), ``mesh`` (the cards, the Painter's and each
stage's time with the mesh beside one card's, the launches by card, each
card's peak memory, the pool's start by worker and InferBranchLengths
through it beside one card, the tools' chain parts through pools beside
one card; ``--phases mesh`` runs the one-card ``run_all`` it
compares with, and on a host with four cards uses all four),
``dealing`` (not run by default; more than one card: the one-card
``run_all`` and then only the mesh phase's ``mesh_dealing``: the chain
parts on one card, dealt from one thread and through a pool of every
card, and the statistics' batches dealt),
``golden`` (the example's trees and clade agreement against the
reference's, the launches, seconds),
``interchange`` (each step's wall seconds, the
flipped, dropped and masked SNPs, the launches of ``--mode All``),
``hosts`` (each process's chunks, launches by kernel and seconds, the
one-host and the two-host wall seconds), ``run_all_n4096``,
``run_all_ancient`` (with the age-aware scan's ms a
build and the kernels it launches), ``anc_unknown``,
``run_all_postprocess`` (with PostProcess's ms a tree for the product, the
node loop and the remapping), ``optimize``, ``cpu_vs_card`` (N = 64, with
two sections through the host topology builder, and PostProcess,
OptimizeParameters, EstimatePopulationSize and CoalRateForTree, which must
be equal on both devices); then the ``{"kernels": [...]}`` line,
the card's name and power limit as ``nvidia-smi`` gives them, and the result
line. The launch counts are set to 0 just before each path and read just
after it. Any phase that fails ends the run with a non-zero exit code. Needs
a CUDA device and no network. ``--phases a,b`` runs a subset (the build always runs);
``--phases profile`` adds a ``torch.profiler`` breakdown of Paint and one
section of BuildTopology at N = 1024, of one section of BuildTopology,
FindEquivalentBranches and InferBranchLengths at N = 2048, and of Paint at
N = 4096 with host timers around the stepping-stone sweeps and the
checkpoint writes, which the default run leaves out;
``--phases inc_edges`` holds only the incremental merge scan against its
plain version at those edge sizes (a short check after an edit of it);
``--phases dense_edges`` does the same for the two dense merge scans (B5
and B6) at N = 2 ... 1000, where most warps and blocks of their cooperative
grid own no row, at the benchmark cells' widths (N = 1006 for both, 1858
for B6: rows padded to 16 bytes), and with a negative threshold (the
fallback at every step) at N = 1024 and N = 2048; ``--phases
sweep_edges`` for the full backward sweep in both modes (B2) and the two capture sweeps (B3 and B4) on seeded
synthetic inputs at N = 2, 3, 100, 1000 and 5000 (rows that start off a
16-byte boundary), at N = 16384 and 25827 (the widest, on few targets),
with wanted rows -1, 0, D-1, D, Dmax and beyond, targets with D = 2, and
rows that rescale every other or every step. The kernels phase runs those
cases too.

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
The merge scans' outputs (cis, cjs, clades) must be equal exactly, and the
incremental scan's counts of repairs and fallback steps as well.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_HAP = 1024                   # the path of the merge scan with clade rows
N_LARGE = 2048                 # the run_all path: the large merge scan
N_ODD = 1576                   # no multiple of 256: the loop tails
N_KGP = 1006                   # the benchmark's cells' widths (B5, B6): no
N_HGDP = 1858                  # multiple of 4, rows padded to 16 bytes
N_INC = 4096                   # the run_all path of the incremental merge scan
N_INC_SMALL = 512              # the incremental scan's four small cases
N_INC_ODD = 5008               # no multiple of 128 or of the block sizes
N_INC_MAX = 16384              # the widest panel the port takes
N_INC_EDGES = (2, 3, 9, 15, 100, 1000)   # blocks of B7's cluster left empty
                                         # or ragged
N_DENSE_EDGES = (2, 3, 9, 33, 100, 1000)  # fewer rows than warps in B5's and
                                          # B6's grid, or a ragged last block
N_SWEEP_EDGES = (2, 3, 100, 1000, 5000)   # fewer sources than a warp's, rows
                                          # off a 16-byte boundary
N_SWEEP_WIDE = (16384, 25827)  # the streaming sweeps' widest blocks, and
                               # the largest width the wrappers take
L_SNPS = 8192
L_SNPS_INC = 4096              # of the N = 4096 panel
SEED = 20240611
THETA = 0.001
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS = 67e12             # H100 SXM, float32 outside the tensor cores
L2_BYTES = 50e6                # H100 SXM: what is re-read from below this stays on chip
TIME_BUDGET_S = 560.0          # further sections are built while under this
SMALLER_MEMORY_GB = 1.25       # gives the N = 1024 panel 3 windows (about 2,900 SNPs)
OPT_MAX_SNPS = 150             # OptimizeParameters: SNPs 0 ... 150 of section 0
EM_ITERS = 2                   # EstimatePopulationSizeEM (its default is 10)
SBL_SAMPLES = 2                # SampleBranchLengths --num_samples
N_PAIR = 512                   # ReEstimateBranchLengths under the pair
L_SNPS_PAIR = 4096             # prior: a run_all of its own (at N = 2048
PAIR_MEMORY_GB = 0.25          # its chains take minutes; PERF.md), 3 windows
HAP_ROWS_CHECKED = 64          # rows of the --poplabels hap .pairwise.coal read back
CHROMOSOME_SNPS = 50_000       # log_pvalue_batch alone: the tails of this many SNPs
MESH_EM_ITERS = 1              # the mesh phase's EstimatePopulationSizeEM
MESH_SBL_SAMPLES = 1           # and SampleBranchLengths --num_samples
MESH_STATS_BATCH = 8           # coalescence_stats in batches of this many trees
PARTS_PROPOSALS = 10_000       # sample_branch_lengths in parts: proposals a sample
SAMPLE_PARTS = 4               # and parts of chain_batch_cap chains
MESH_STORE_COPIES = 5          # the N = 2048 output repeated: 305 trees, two
                               # chain parts (one after the EM's filter)
GOLDEN_SNPS = 12_000           # BuildTopology of the golden chunk: its first
                               # SNPs
GOLDEN_MARGIN = 500            # trees straddling the cut are not compared
L_SNPS_HOSTS = 4096            # the hosts phase: the first SNPs of the N = 2048
HOSTS_MEMORY_GB = 2.0          # panel, which with these chunk constants plans
HOSTS_CHUNKING = dict(OVERLAP=500, MERGE_DISCARD=250,    # as 2 chunks
                      MAX_WINDOWS_PER_CHUNK=4)
HOSTS_TIMEOUT_S = 600.0        # a host process's limit and barrier timeout
L_SNPS_ANCIENT = 2048          # run_all_ancient: the first SNPs of the N = 1024
ANCIENT_MEMORY_GB = 0.5        # panel, in 2 windows
L_SNPS_ANC_UNKNOWN = 4096      # anc_unknown: the first SNPs of the N = 1024
ANC_UNKNOWN_MEMORY_GB = 0.6    # panel, in 3 windows
L_SNPS_RUN_ALL_INC = 2048      # run_all_n4096: the first SNPs of its panel
L_SNPS_POSTPROCESS = 4096      # run_all_postprocess and interchange: the first
L_SNPS_INTERCHANGE = 4096      # SNPs of the N = 2048 panel
DEV = "cuda"                   # the port's entry points get this device

T_START = time.time()


def emit(phase, **kw):
    """One JSON line a phase; ``at_s``: seconds since the script started."""
    print(json.dumps({"phase": phase, "at_s": round(time.time() - T_START, 1),
                      **kw}), flush=True)


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


def make_panel(N, L):
    from relate_tpu_torch.utils import synth
    G, bp = synth.synth_coalescent_panel(N, L, seed=SEED)[:2]
    return np.ascontiguousarray(G, dtype=np.uint8), bp


def make_row(name, source, replaces, err, direct, ms_k, ms_p, nbytes, ops,
             **extra):
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_FLOPS * 1e3
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=0, max_abs_err=err, ms=ms_k, plain_ms=ms_p,
        bound_ms=max(b_ms, o_ms),
        bound_by="bytes" if b_ms >= o_ms else "operations",
        library_ms=None, rows_rescaled_elsewhere=direct,
        bytes=int(nbytes), operations=int(ops), **extra)


def chain(ms, walked, launch):
    """A streaming sweep's chain: the most rows a target walks, the time a
    row of that chain takes, and the launch configuration."""
    rows = int(walked.max().item())
    return dict(rows_max=rows, us_per_row=ms * 1e3 / max(rows, 1),
                ring_rows=launch["ring_rows"], launch=launch)


def sweep_rows(G, bp, memory_gb, w):
    """The four sweep kernels against their plain versions on the card, at
    the shapes that window ``w`` of the panel's plan gives them (a middle
    window, so both capture kernels have work). Returns the four rows and a
    distance matrix assembled from the posterior, for the merge scans."""
    from relate_tpu_torch.core import painting
    from relate_tpu_torch.core.distance import _assemble_ops
    from relate_tpu_torch.io import chunking
    from relate_tpu_torch.io import haps as hio
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
        fail(f"kernels: expected >= 3 windows at N = {N}, got {W}")
    model = painting.PaintingModel(N=N, theta=THETA)
    painter = painting.Painter(G, r, model, device=dev)
    bsb, bse = painter.window_boundary_sites(bounds)
    targets = np.arange(N, dtype=np.int32)
    final_raw = painter._extended_final_raw(bse[w], targets)
    prep = painter._prep(targets, bsb[w], bse[w], final_raw=final_raw)
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
    small = 3 * B * N * 4 + 2 * B * Dmax * 4 + Dmax * B * 4
    cells = int(Dl.sum().item())            # valid (row, target) pairs
    shape = [Dmax, B, N]

    # B1 forward
    fk = lambda: pk.fwd(D, a0, kmask, mism, pfac, nxt, theta=THETA)  # noqa: E731
    fp = lambda: pk.fwd_plain(D, a0, kmask, mism, pfac, nxt, theta=THETA)  # noqa: E731
    al_k, ls_k = fk()
    al_p, ls_p = fp()
    torch.cuda.synchronize()
    err, direct = compare_rows("paint_fwd", al_k, ls_k, al_p, ls_p,
                               torch.ones_like(valid))
    rescaled = {False: rescaled_share(D, nxt, ls_p, False)}
    del al_p, ls_p
    res.append(make_row(
        "paint_fwd", "relate_tpu_torch/csrc/paint_fwd.cu",
        "relate_tpu/ops/paint_kernels.py:233", err, direct,
        time_ms(fk, 3), time_ms(fp, 1),
        (cells - B) * N + Dmax * B * N * 4 + small, 6 * cells * N,
        shape=shape))

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
        ms_k = time_ms(bk, 10)
        launch = pk.bwd_config(N, B, emit_beta=emit_beta)
        if not emit_beta:
            topo, lstot = to_k, lt_k
            res.append(make_row(
                "paint_bwd", "relate_tpu_torch/csrc/paint_bwd.cu",
                "relate_tpu/ops/paint_kernels.py:284", err, direct,
                ms_k, time_ms(bpl, 1),
                cells * N * 5 + Dmax * B * N * 4 + small + Dmax * B * 4,
                8 * cells * N, shape=shape, **chain(ms_k, Dl, launch),
                bytes_in_flight_per_sm=launch["bytes_in_flight_per_sm"]))
        else:
            res[-1].update(emit_beta_max_abs_err=err, emit_beta_ms=ms_k,
                           emit_beta_rows_rescaled_elsewhere=direct,
                           emit_beta_launch=launch)
            rescaled[True] = rescaled_share(D, nxt, lt_p, True)
        del to_k, lt_k, to_p, lt_p
    res[-1]["rescaled_row_share"] = rescaled[True]
    del al_k, ls_k

    # B3 / B4 capture sweeps
    ck = lambda: pk.fwd_capture(D, want_f, a0, kmask, mism, pfac, nxt,  # noqa: E731
                                theta=THETA)
    cp_ = lambda: pk.fwd_capture_plain(D, want_f, a0, kmask, mism, pfac,  # noqa: E731
                                       nxt, theta=THETA)
    (ac_k, lc_k), (ac_p, lc_p) = ck(), cp_()
    torch.cuda.synchronize()
    err, direct = compare_rows("paint_fwd_capture", ac_k, lc_k, ac_p, lc_p,
                               all_b)
    walked = torch.minimum(want_f.long(), Dl - 1)   # rows after row 0
    rows_f = int(walked.sum().item())
    ms_k = time_ms(ck, 10)
    res.append(make_row(
        "paint_fwd_capture", "relate_tpu_torch/csrc/paint_capture.cu",
        "relate_tpu/ops/paint_kernels.py:394", err, direct,
        ms_k, time_ms(cp_, 1),
        rows_f * N + 3 * B * N * 4 + 2 * B * Dmax * 4, 6 * rows_f * N,
        shape=shape, rescaled_row_share=rescaled[False],
        **chain(ms_k, walked, pk.capture_config(N, B, False))))

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
    walked = (Dl - want_b.long()) * hit
    rows_b = int(walked.sum().item())
    ms_k = time_ms(ck, 10)
    res.append(make_row(
        "paint_bwd_capture", "relate_tpu_torch/csrc/paint_capture.cu",
        "relate_tpu/ops/paint_kernels.py:515", err, direct,
        ms_k, time_ms(cp_, 1),
        rows_b * N + 3 * B * N * 4 + 2 * B * Dmax * 4, 8 * rows_b * N,
        shape=shape, rescaled_row_share=rescaled[True],
        **chain(ms_k, walked, pk.capture_config(N, B, True))))
    del ac_k, ac_p, bc_k, bc_p

    # a distance matrix assembled from the posterior above
    rows = torch.clamp(Dl // 2, max=Dmax - 2)
    half = torch.full((B,), 0.5, dtype=torch.float32, device=dev)
    exact = torch.arange(B, device=dev) % 3 == 0
    mat = _assemble_ops(topo, lstot, rows, exact, half, half,
                        torch.arange(B, device=dev)).contiguous()
    return res, mat


def merge_cases(mat, scan):
    """The three inputs of a merge-scan comparison at the size of ``mat``:
    the posterior's distance matrix with use_cf off, the same plus
    tie-heavy integers with the clade prior of the first case's tree on,
    and tie-heavy integer matrices that lean on the hash. ``scan`` gives
    (cis, cjs, clades) for the first case."""
    from relate_tpu_torch.core.treebuilder import thresholds
    N = mat.shape[0]
    dev = mat.device
    thr, thr_cf = thresholds(THETA)
    val = -float(np.log(THETA / (1.0 - THETA)))
    zeros = torch.zeros_like(mat)
    gen = torch.Generator(device="cpu").manual_seed(SEED + N)
    ties = torch.randint(0, 4, (N, N), generator=gen).to(torch.float32).to(dev)
    ties_cf = torch.randint(0, 3, (N, N), generator=gen).to(
        torch.float32).to(dev)
    cl0 = scan(mat, zeros, False, thr, thr_cf, 12345)[2]
    dcf1 = (val * (cl0.t() @ (1.0 - cl0))).contiguous()
    return thr, thr_cf, [
        ("posterior", mat, zeros, False, 12345),
        ("posterior+clade_prior", (mat + 0.25 * ties).contiguous(), dcf1,
         True, 777),
        ("ties", ties, ties_cf, True, 4242)]


def first_difference(a, b):
    ne = (a != b).nonzero()
    return int(ne[0]) if ne.numel() else -1


def dense_against_plain(detail, n, label, d_, dcf_, ucf, thr, thr_cf, seed,
                        large):
    """B6 (``large``) or B5 against the plain version on one input: merge
    lists equal exactly, and the clade rows (B5's own, or rebuilt from B6's
    lists by ``clades_from_merges``) equal to the plain version's. Appends
    the record to ``detail`` and returns the kernel's outputs."""
    from relate_tpu_torch.ops import merge_scan as ms
    name = "merge_scan_large" if large else "merge_scan"
    args = (d_, dcf_, ucf, thr, thr_cf, seed)
    k = ms.merge_scan_large(*args) if large else ms.merge_scan(*args)
    p = ms.merge_scan_plain(*args)
    torch.cuda.synchronize()
    same = torch.equal(k[0], p[0]) and torch.equal(k[1], p[1])
    detail.append({"N": n, "case": label, "use_cf": ucf, "threshold": thr,
                   "equal": same})
    if not same:
        fail(f"{name}[N={n}, {label}]: merge lists differ from the plain "
             f"version (first at step {first_difference(k[0], p[0])})")
    clades = ms.clades_from_merges(k[0], k[1], n) if large else k[2]
    if not torch.equal(clades, p[2]):
        fail(f"{name}[N={n}, {label}]: the clade rows differ from the plain "
             "version's")
    return k


def scan_counts(fn):
    """(outputs, counters) of one dense scan: ``merge_scan.<counter>`` of
    the record open at its launch."""
    from relate_tpu_torch.ops import merge_scan as ms
    from relate_tpu_torch.utils import trace
    rec = {}
    with trace.within(rec):
        out = fn()
    torch.cuda.synchronize()
    ms.read_counts()
    got = rec.get("counts", {})
    return out, {k: got.get("merge_scan." + k, 0) for k in ms.COUNTERS}


def cell_width(mat, n, large):
    """B6 (``large``) or B5 at a benchmark cell's width n, on the top-left
    n x n of a posterior's matrix: the three ``merge_cases`` inputs and the
    first with a negative threshold (the fallback at every step) against the
    plain version, exactly; the time a call and a step of the second and of
    the last; and the kernel's four counters on the second against the CPU
    model's (``merge_scan_counts``)."""
    from relate_tpu_torch.ops import merge_scan as ms
    sub = mat[:n, :n].contiguous()
    thr, thr_cf, cases = merge_cases(sub, ms.merge_scan)
    label, d_, dcf_, ucf, seed = cases[0]
    cases.append(("posterior, negative threshold", d_, dcf_, ucf, seed))
    fn = ms.merge_scan_large if large else ms.merge_scan
    detail, out = [], {"N": n}
    for label, d_, dcf_, ucf, seed in cases:
        t = -1.0 if label.endswith("negative threshold") else thr
        dense_against_plain(detail, n, label, d_, dcf_, ucf, t, thr_cf, seed,
                            large)
        if label == "posterior+clade_prior":
            _, got = scan_counts(lambda: fn(d_, dcf_, ucf, t, thr_cf, seed))
            want = ms.merge_scan_counts(d_.cpu().numpy(), dcf_.cpu().numpy(),
                                        ucf, t, thr_cf, seed)[2]
            out.update(counters=got, model_counters=want)
            if got != want:
                fail(f"{'merge_scan_large' if large else 'merge_scan'}"
                     f"[N={n}, {label}]: counters {got}, the model's {want}")
        if label in ("posterior+clade_prior", "posterior, negative threshold"):
            ms_k = time_ms(lambda: fn(d_, dcf_, ucf, t, thr_cf, seed), 3)
            detail[-1].update(ms=ms_k, us_per_step=ms_k * 1e3 / (n - 1))
    out["cases"] = detail
    out.update(ms=detail[1]["ms"], us_per_step=detail[1]["us_per_step"])
    return out


def dense_edge_cases(large):
    """B6 (``large``) or B5 at the edges of its cooperative grid: N = 2, 3,
    9, 33 and 100 leave most warps and blocks without a row, N = 1000 a
    ragged last block, N = 1006 and (B6) 1858 are the cells' widths
    (continuous and tie-heavy values, the clade prior off and on, and a
    negative threshold); and the negative threshold, where no
    pair is ever mutual and every step takes the symmetric fallback, at the
    kernel's own main-path width (N = 1024 for B5, 2048 for B6), timed.
    Returns the records."""
    from relate_tpu_torch.ops import merge_scan as ms
    detail = []
    for n in N_DENSE_EDGES + ((N_KGP, N_HGDP) if large else (N_KGP,)):
        for case in edge_cases(n):
            dense_against_plain(detail, n, *case, large)
    n = N_LARGE if large else N_HAP
    label, d_, dcf_, ucf, thr, thr_cf, seed = random_cases(n)[3]
    dense_against_plain(detail, n, label, d_, dcf_, ucf, thr, thr_cf, seed,
                        large)
    fn = ms.merge_scan_large if large else ms.merge_scan
    detail[-1]["ms"] = time_ms(lambda: fn(d_, dcf_, ucf, thr, thr_cf, seed),
                               3)
    detail[-1]["us_per_step"] = detail[-1]["ms"] * 1e3 / (n - 1)
    return detail


def merge_scan_row(mat):
    """B5, the merge scan that also emits the clade rows, at N = 1024, and
    at the edges of its grid (``dense_edge_cases``)."""
    from relate_tpu_torch.ops import merge_scan as ms
    N = mat.shape[0]
    thr, thr_cf, cases = merge_cases(mat, ms.merge_scan)
    ms_k, ms_p = None, None
    detail = dense_edge_cases(large=False)
    for label, d_, dcf_, ucf, seed in cases:
        dense_against_plain(detail, N, label, d_, dcf_, ucf, thr, thr_cf,
                            seed, large=False)
        if label == "posterior+clade_prior":
            fn_k = lambda: ms.merge_scan(d_, dcf_, ucf, thr, thr_cf, seed)  # noqa: E731
            fn_p = lambda: ms.merge_scan_plain(d_, dcf_, ucf, thr, thr_cf,  # noqa: E731
                                               seed)
            ms_k, ms_p = time_ms(fn_k, 3), time_ms(fn_p, 1)
    live_pairs = sum((N - t) * (N - t - 1) for t in range(N - 1))
    return make_row(
        "merge_scan", "relate_tpu_torch/csrc/merge_scan.cu",
        "relate_tpu/ops/merge_scan.py:371", 0.0, 0, ms_k, ms_p,
        2 * N * N * 4 + (N - 1) * N * 4 + 2 * (N - 1) * 4,
        9 * live_pairs, shape=[N, N], cases=detail,
        us_per_step=ms_k * 1e3 / (N - 1), grid=ms.grid_config(N, large=False),
        live_bytes_ms=live_pairs * 16 / HBM_BYTES_PER_S * 1e3,
        at_n1006=cell_width(mat, N_KGP, large=False))


def merge_scan_large_row(mat_large, mat_small):
    """B6, the merge scan without clade state: against its plain version at
    N = 2048, at an N that is no multiple of 256 and at the edges of its
    grid (``dense_edge_cases``; merge lists equal exactly), and against B5
    at N = 1024 (merge lists equal, and ``clades_from_merges`` of its lists
    equal to B5's clade rows). The clades rebuilt from its lists are held
    against the plain version's at every size."""
    from relate_tpu_torch.ops import merge_scan as ms
    N = mat_large.shape[0]
    if not ms.MAX_N_SMALL < N <= ms.MAX_N_LARGE:
        fail(f"merge_scan_large: N = {N} is not on the large route")
    ms_k, ms_p, ms_c = None, None, None
    detail = dense_edge_cases(large=True)

    def against_plain(n, *case):
        return dense_against_plain(detail, n, *case, large=True)

    thr, thr_cf, cases = merge_cases(mat_large, ms.merge_scan)
    for label, d_, dcf_, ucf, seed in cases[1:]:
        k = against_plain(N, label, d_, dcf_, ucf, thr, thr_cf, seed)
        if label == "posterior+clade_prior":
            fn_k = lambda: ms.merge_scan_large(d_, dcf_, ucf, thr, thr_cf,  # noqa: E731
                                               seed)
            fn_p = lambda: ms.merge_scan_plain(d_, dcf_, ucf, thr, thr_cf,  # noqa: E731
                                               seed, with_clades=False)
            fn_c = lambda: ms.clades_from_merges(k[0], k[1], N)  # noqa: E731
            ms_k, ms_p, ms_c = time_ms(fn_k, 3), time_ms(fn_p, 1), \
                time_ms(fn_c, 3)
    odd = mat_large[:N_ODD, :N_ODD].contiguous()
    _, _, cases = merge_cases(odd, ms.merge_scan)
    for label, d_, dcf_, ucf, seed in cases[1:]:
        against_plain(N_ODD, label, d_, dcf_, ucf, thr, thr_cf, seed)
    # the large kernel below its route's size, against the kernel with
    # clade rows
    n = mat_small.shape[0]
    _, _, cases = merge_cases(mat_small, ms.merge_scan)
    for label, d_, dcf_, ucf, seed in cases[1:]:
        small = ms.merge_scan(d_, dcf_, ucf, thr, thr_cf, seed)
        large = ms.merge_scan_large(d_, dcf_, ucf, thr, thr_cf, seed)
        rebuilt = ms.clades_from_merges(large[0], large[1], n)
        torch.cuda.synchronize()
        same = (torch.equal(small[0], large[0])
                and torch.equal(small[1], large[1])
                and torch.equal(small[2], rebuilt))
        detail.append({"N": n, "case": label + " vs merge_scan",
                       "use_cf": ucf, "equal": same})
        if not same:
            fail(f"merge_scan_large[N={n}, {label}]: lists or rebuilt clades "
                 "differ from the kernel with clade rows")
    live_pairs = sum((N - t) * (N - t - 1) for t in range(N - 1))
    # two reckonings, the larger is the bound: the float operations, and
    # the bytes that must come from device memory. Step t reads the live
    # entries of d, dt, dcf, dcft, (N-t)^2 * 16 bytes (67 MB at N = 2048);
    # they come from device memory only while that region is larger than
    # the L2, and at least once (the inputs read, the lists written).
    # ``live_bytes_ms`` is every step's live entries at the memory rate,
    # as in the row of the scan with clade rows.
    io_bytes = 2 * N * N * 4 + 2 * (N - 1) * 4
    hbm_bytes = sum((N - t) * (N - t - 1) * 16 for t in range(N - 1)
                    if (N - t) * (N - t) * 16 > L2_BYTES)
    return make_row(
        "merge_scan_large", "relate_tpu_torch/csrc/merge_scan.cu",
        "relate_tpu/ops/merge_scan.py:303", 0.0, 0, ms_k, ms_p,
        max(io_bytes, hbm_bytes), 9 * live_pairs, shape=[N, N], cases=detail,
        clades_from_merges_ms=ms_c, us_per_step=ms_k * 1e3 / (N - 1),
        grid=ms.grid_config(N, large=True),
        steps_above_l2=sum((N - t) * (N - t) * 16 > L2_BYTES
                           for t in range(N - 1)),
        live_bytes_ms=live_pairs * 16 / HBM_BYTES_PER_S * 1e3,
        io_bytes_ms=io_bytes / HBM_BYTES_PER_S * 1e3,
        at_n1858=cell_width(mat_large, N_HGDP, large=True))


def random_cases(N):
    """Four inputs of the incremental merge scan that no panel gives:
    continuous values with the clade prior off and on (wide bands, so many
    pairs are mutual and the prior decides), tie-heavy small integers with
    the prior on, and a negative threshold (no pair is ever mutual: the
    fallback runs every step). (label, d, dcf, use_cf, threshold,
    threshold_cf, seed)."""
    gen = torch.Generator(device="cpu").manual_seed(SEED + N)

    def rand(scale):
        m = torch.rand((N, N), generator=gen) * scale
        return m.fill_diagonal_(0.0).to(DEV)

    def ints(high):
        m = torch.randint(0, high, (N, N), generator=gen).to(torch.float32)
        return m.fill_diagonal_(0.0).to(DEV)

    d, dcf = rand(10.0), rand(3.0)
    return [("continuous", d, dcf, False, 5.0, 1.0, 31),
            ("continuous+clade_prior", d, dcf, True, 5.0, 1.0, 31),
            ("ties+clade_prior", ints(4), ints(3), True, 1e-6, 0.01, 4242),
            ("fallback_every_step", d, dcf, False, -1.0, 1.0, 7)]


def edge_cases(N):
    """``random_cases(N)`` and tie-heavy integers with the prior off."""
    cases = random_cases(N)
    d_, dcf_ = cases[2][1], cases[2][2]
    return cases[:2] + [("ties", d_, dcf_, False, 1e-6, 0.01, 4242)] \
        + cases[2:]


def inc_bound_bytes(N, counts, use_cf):
    """Bytes the incremental scan must move for this run's counts: the four
    matrices read once by the set-up, per step eight rows read, four rows
    written and four columns written with stride N (a strided float costs
    its 32-byte sector), a repair's rows (row w of d and of its transpose,
    and of the clade prior's two where the prior is on), the live entries of
    d and of its transpose at each fallback step (``fallback_entries``:
    the square of the number of live rows, summed over those steps), and
    the two merge lists written."""
    return (4 * N * N * 4 + (N - 1) * (8 * N * 4 + 4 * N * 4 + 4 * N * 32)
            + counts["repairs"] * (4 if use_cf else 2) * N * 4
            + counts["fallback_entries"] * 2 * 4 + 2 * (N - 1) * 4)


def inc_timed(n, args, counts, profile=False):
    """B7's time at width n on ``args``, per call and per step, its bound from
    this run's counts and, with ``profile``, the device time of each of its
    kernels."""
    from relate_tpu_torch.ops import merge_scan_inc as mi
    ms_k = time_ms(lambda: mi.merge_scan_inc_lists(*args),
                   3 if n <= N_INC_ODD else 1)
    out = {"ms": ms_k, "us_per_step": ms_k * 1e3 / max(n - 1, 1),
           "repairs_per_step": counts["repairs"] / max(n - 1, 1),
           "bound_ms": inc_bound_bytes(n, counts, args[2])
           / HBM_BYTES_PER_S * 1e3}
    if profile:
        out["device_kernels"] = profiled(
            lambda: mi.merge_scan_inc_lists(*args))["top"]
    return out


def inc_against_plain(detail, n, label, d_, dcf_, ucf, thr, thr_cf, seed,
                      profile=False, timed=True):
    """B7 against its plain version on one input: merge lists and the three
    counts equal, the lists a tree on all leaves. Appends the record to
    ``detail`` and returns it."""
    from relate_tpu_torch.ops import merge_scan as ms
    from relate_tpu_torch.ops import merge_scan_inc as mi
    args = (d_, dcf_, ucf, thr, thr_cf, seed)
    ck, cp = {}, {}
    k = mi.merge_scan_inc_lists(*args, ck)
    torch.cuda.synchronize()
    t0 = time.time()
    p = mi.merge_scan_inc_plain(*args, cp)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    rec = {"N": n, "case": label, "use_cf": ucf,
           "equal": torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
           "repairs": ck["repairs"],
           "fallback_steps": ck["fallback_steps"],
           "fallback_entries": ck["fallback_entries"],
           "plain_ms": plain_ms}
    detail.append(rec)
    if not rec["equal"]:
        steps = [first_difference(x, y) for x, y in zip(k, p)]
        fail(f"merge_scan_inc[N={n}, {label}]: merge lists differ from "
             "the plain version (first at step "
             f"{min(t for t in steps if t >= 0)})")
    if ck != cp:
        fail(f"merge_scan_inc[N={n}, {label}]: the kernel counted {ck}, "
             f"the plain version {cp}")
    clades = ms.clades_from_merges(k[0], k[1], n)
    if float(clades[-1].sum()) != n or bool((clades.sum(dim=1) < 2).any()):
        fail(f"merge_scan_inc[N={n}, {label}]: the merge lists are no "
             "tree on all leaves")
    if timed:
        rec.update(inc_timed(n, args, ck, profile))
    return rec


def inc_edge_cases(detail):
    """B7 at the edges of its cluster of 8 blocks: N = 2, 3, 9 and 15 leave
    blocks without lanes, N = 100 and 1000 a ragged last block; continuous
    and tie-heavy values, each with the clade prior off and on, and the
    fallback at every step. At N = 1000 only the continuous cases (the
    plain version of the tie-heavy ones takes a minute there)."""
    for n in N_INC_EDGES:
        for case in edge_cases(n):
            if n > 100 and not case[0].startswith("continuous"):
                continue
            inc_against_plain(detail, n, *case, timed=False)


def merge_scan_inc_row(mat_inc, mat_large):
    """B7, the incremental merge scan, against its plain version on the card
    (merge lists and the counts of repairs and fallback steps equal exactly):
    the cluster's edge sizes (``inc_edge_cases``), four cases at N = 512,
    the posterior's distance matrix of the N = 4096 panel with the old
    tree's clade prior, and N = 5008 (no multiple of 128 or of the block
    sizes) with a band so narrow that a third of the steps fall back.
    Against B6 at N = 2048 on a continuous matrix with the prior off, where
    every minimum is unique and the two scans' semantics coincide. A scan at
    N = 4096 that falls back at every step is timed and checked to be a
    tree; its plain version would take a minute and a half. Both N = 4096
    scans are also run under ``torch.profiler`` for the device time of each
    of their kernels. The widest scan the port takes, N = 16384, is timed on
    a uniform random matrix with the prior on and checked to be a tree; its
    plain version would take a quarter of an hour."""
    from relate_tpu_torch.ops import merge_scan as ms
    from relate_tpu_torch.ops import merge_scan_inc as mi
    N = mat_inc.shape[0]
    if not ms.MAX_N_LARGE < N <= ms.MAX_N_INC:
        fail(f"merge_scan_inc: N = {N} is not on the incremental route")
    detail = []

    def against_plain(n, *case):
        return inc_against_plain(detail, n, *case, profile=n == N)

    def timed(n, args, counts):
        return inc_timed(n, args, counts, profile=n == N)

    inc_edge_cases(detail)
    for case in random_cases(N_INC_SMALL):
        against_plain(N_INC_SMALL, *case)
    if detail[-1]["fallback_steps"] != N_INC_SMALL - 1:
        fail("merge_scan_inc: the negative threshold did not fall back at "
             "every step")
    # the main path's input: the posterior's matrix with the clade prior of
    # the tree built from it
    thr, thr_cf, cases = merge_cases(mat_inc, mi.merge_scan_incremental)
    label, d_, dcf_, ucf, seed = cases[1]
    main = against_plain(N, label, d_, dcf_, ucf, thr, thr_cf, seed)
    lists = mi.merge_scan_inc_lists(d_, dcf_, ucf, thr, thr_cf, seed)
    ms_c = time_ms(lambda: ms.clades_from_merges(lists[0], lists[1], N), 3)
    zeros = torch.zeros_like(mat_inc)
    fb_args = (mat_inc, zeros, False, -1.0, thr_cf, 7)
    fb_counts = {}
    fb_lists = mi.merge_scan_inc_lists(*fb_args, fb_counts)
    fb_clades = ms.clades_from_merges(fb_lists[0], fb_lists[1], N)
    if fb_counts["fallback_steps"] != N - 1 \
            or fb_counts["fallback_entries"] != sum(
                k * k for k in range(2, N + 1)) \
            or float(fb_clades[-1].sum()) != N:
        fail(f"merge_scan_inc[N={N}, fallback_every_step]: {fb_counts}, or "
             "the merge lists are no tree on all leaves")
    fb = dict(fb_counts, **timed(N, fb_args, fb_counts))
    del cases, d_, dcf_, zeros, fb_clades
    torch.cuda.empty_cache()
    label, d_, dcf_, ucf, _, thr_cf_odd, seed = random_cases(N_INC_ODD)[1]
    odd = against_plain(N_INC_ODD, label + ", narrow band", d_, dcf_, ucf,
                        0.5, thr_cf_odd, seed)
    del d_, dcf_
    torch.cuda.empty_cache()
    # the widest scan: made on the card, 1 GB a matrix
    gen = torch.Generator(device=DEV).manual_seed(SEED)
    d_ = (torch.rand((N_INC_MAX, N_INC_MAX), generator=gen, device=DEV)
          * 10).fill_diagonal_(0.0)
    dcf_ = (torch.rand((N_INC_MAX, N_INC_MAX), generator=gen, device=DEV)
            * 3).fill_diagonal_(0.0)
    max_args = (d_, dcf_, True, 5.0, 0.01, 9)
    max_counts = {}
    max_lists = mi.merge_scan_inc_lists(*max_args, max_counts)
    max_clades = ms.clades_from_merges(max_lists[0], max_lists[1], N_INC_MAX)
    if float(max_clades[-1].sum()) != N_INC_MAX \
            or bool((max_clades.sum(dim=1) < 2).any()):
        fail(f"merge_scan_inc[N={N_INC_MAX}]: the merge lists are no tree on "
             "all leaves")
    del max_clades
    widest = dict(N=N_INC_MAX, case="uniform random+clade_prior",
                  **max_counts, **timed(N_INC_MAX, max_args, max_counts))
    del d_, dcf_, max_args
    torch.cuda.empty_cache()
    # against the large dense scan where the semantics coincide
    n = mat_large.shape[0]
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    d_ = (torch.rand((n, n), generator=gen) * 10).fill_diagonal_(0.0).to(DEV)
    zeros = torch.zeros_like(d_)
    a = mi.merge_scan_inc_lists(d_, zeros, False, 5.0, 0.01, 3)
    b = ms.merge_scan_large(d_, zeros, False, 5.0, 0.01, 3)
    torch.cuda.synchronize()
    same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    detail.append({"N": n, "case": "continuous vs merge_scan_large",
                   "use_cf": False, "equal": same})
    if not same:
        fail(f"merge_scan_inc[N={n}]: lists differ from the large dense "
             f"scan's (first at step {first_difference(a[0], b[0])})")
    nbytes = inc_bound_bytes(N, main, main["use_cf"])
    # operations: the blend (12 a lane a step) and a rescan's tests, sums
    # and hash (about 20 a lane a repair)
    ops = (N - 1) * 12 * N + main["repairs"] * 20 * N
    return make_row(
        "merge_scan_inc", "relate_tpu_torch/csrc/merge_scan_inc.cu",
        "relate_tpu/ops/merge_scan_inc.py:726", 0.0, 0, main["ms"],
        main["plain_ms"], nbytes, ops, shape=[N, N], cases=detail,
        us_per_step=main["us_per_step"],
        repairs_per_step=main["repairs_per_step"],
        fallback_steps=main["fallback_steps"],
        clades_from_merges_ms=ms_c, device_kernels=main["device_kernels"],
        cluster=mi.cluster_config(N),
        fallback_every_step=fb, at_n16384=widest,
        at_odd_n={k: odd[k] for k in (
            "N", "case", "ms", "us_per_step", "repairs_per_step",
            "fallback_steps", "fallback_entries", "plain_ms", "bound_ms")})


def capture_inputs(N, B, Dmax, seed, pfac_scale=0.01, density=0.3,
                   d_max=None):
    """Seeded synthetic inputs of the capture sweeps on the card: D in
    [2, d_max] (D[0] = 2, D[1] = d_max), and the wanted rows cycling over
    -1, 0, D-1, D (held by the forward sweep, none for the backward), Dmax
    (none for either) and a row drawn below D. (D, want, state, kmask,
    mism, pfac, nxt)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    d_max = Dmax if d_max is None else d_max
    D = torch.randint(2, d_max + 1, (B,), generator=gen, dtype=torch.int32)
    D[0] = 2
    D[1 % B] = d_max
    drawn = (torch.rand(B, generator=gen) * D).to(torch.int32)
    kinds = torch.arange(B) % 6
    want = torch.where(kinds == 0, -1, torch.where(
        kinds == 1, 0, torch.where(kinds == 2, D - 1, torch.where(
            kinds == 3, D, torch.where(kinds == 4, Dmax, drawn))))).to(
        torch.int32)
    state = torch.rand((B, N), generator=gen) + 0.1
    kmask = torch.ones((B, N))
    kmask[torch.arange(B), torch.arange(B) % N] = 0.0
    mism = (torch.rand((Dmax, B, N), generator=gen) < density).to(torch.int8)
    pfac = (torch.rand((B, Dmax), generator=gen) + 0.5) * pfac_scale
    nxt = -torch.rand((B, Dmax), generator=gen)
    return tuple(t.contiguous().to(DEV) for t in
                 (D, want, state, kmask, mism, pfac, nxt))


def rescaled_share(D, nxt, lss, backward):
    """Share of the stepped rows that the plain full sweep rescaled: those
    whose logscale moved by more than its step term (a rescale moves it by
    the log of a sum outside [1e-10, 1e10], at least 23)."""
    Dmax = lss.shape[0]
    j = torch.arange(1, Dmax, device=D.device)[:, None]
    stepped = j < D[None, :]
    if backward:   # row j - 1 steps from row j with nxt[j]
        step = lss[:-1] - lss[1:] - nxt.t()[1:]
    else:          # row j steps from row j - 1 with nxt[j - 1]
        step = lss[1:] - lss[:-1] - nxt.t()[:-1]
    moved = (step.abs() > 1.0) & stepped
    return moved.sum().item() / max(stepped.sum().item(), 1)


def capture_against_plain(detail, label, theta, inputs):
    """B3 and B4 against their plain versions on one input: the scale-free
    row comparison on the targets with a wanted row, exact zeros on the
    others. Appends one record a direction to ``detail``."""
    from relate_tpu_torch.ops import paint_kernels as pk
    D, want, state, kmask, mism, pfac, nxt = inputs
    Dmax, B, N = mism.shape
    Dl, wl = D.long(), want.long()
    for backward in (False, True):
        name = "paint_bwd_capture" if backward else "paint_fwd_capture"
        k_fn = pk.bwd_capture if backward else pk.fwd_capture
        p_fn = pk.bwd_capture_plain if backward else pk.fwd_capture_plain
        out_k, ls_k = k_fn(D, want, state, kmask, mism, pfac, nxt,
                           theta=theta)
        out_p, ls_p = p_fn(D, want, state, kmask, mism, pfac, nxt,
                           theta=theta)
        torch.cuda.synchronize()
        hit = (wl >= 0) & (wl < Dmax)
        if backward:
            hit &= wl < Dl
        what = f"{name}[N={N}, {label}]"
        err, direct = compare_rows(what, out_k, ls_k, out_p, ls_p, hit)
        if bool((out_k * ~hit[:, None]).any()) or bool((ls_k * ~hit).any()):
            fail(f"{what}: a target with no wanted row is not zero")
        if backward:
            full = pk.bwd_plain(D, state, kmask, mism, pfac, nxt,
                                torch.zeros((Dmax, B, N), device=DEV),
                                torch.zeros((Dmax, B), device=DEV),
                                theta=theta, emit_beta=True)[1]
        else:
            full = pk.fwd_plain(D, state, kmask, mism, pfac, nxt,
                                theta=theta)[1]
        detail.append({"N": N, "B": B, "Dmax": Dmax, "case": label,
                       "kernel": name, "targets_with_row": int(hit.sum()),
                       "max_abs_err": err, "rows_rescaled_elsewhere": direct,
                       "rescaled_row_share": rescaled_share(D, nxt, full,
                                                            backward),
                       "launch": pk.capture_config(N, B, backward)})


def bwd_against_plain(detail, label, theta, inputs):
    """B2 in both modes against its plain version on one input of the
    capture sweeps, with the plain forward sweep's rows as alphas and lsf:
    the scale-free row comparison on the rows below D, exact zeros at and
    past D. Appends one record a mode to ``detail``."""
    from relate_tpu_torch.ops import paint_kernels as pk
    D, _, state, kmask, mism, pfac, nxt = inputs
    Dmax, B, N = mism.shape
    alphas, lsf = pk.fwd_plain(D, state, kmask, mism, pfac, nxt, theta=theta)
    valid = rows_valid(D, Dmax)
    beta_ls = None
    for emit_beta in (True, False):
        name = "paint_bwd" + ("[emit_beta]" if emit_beta else "")
        out_k, ls_k = pk.bwd(D, state, kmask, mism, pfac, nxt, alphas, lsf,
                             theta=theta, emit_beta=emit_beta)
        out_p, ls_p = pk.bwd_plain(D, state, kmask, mism, pfac, nxt, alphas,
                                   lsf, theta=theta, emit_beta=emit_beta)
        torch.cuda.synchronize()
        what = f"{name}[N={N}, {label}]"
        err, direct = compare_rows(what, out_k, ls_k, out_p, ls_p, valid)
        if bool((out_k * ~valid[..., None]).any()) or \
                bool((ls_k * ~valid).any()):
            fail(f"{what}: rows at and past D are not zero")
        if emit_beta:
            beta_ls = ls_p
        detail.append({"N": N, "B": B, "Dmax": Dmax, "case": label,
                       "kernel": name, "rows": int(valid.sum()),
                       "max_abs_err": err, "rows_rescaled_elsewhere": direct,
                       "rescaled_row_share": rescaled_share(D, nxt, beta_ls,
                                                            True),
                       "launch": pk.bwd_config(N, B, emit_beta=emit_beta)})


def sweep_edge_cases():
    """B2, B3 and B4 at the edges of their blocks and rings: N = 2, 3, 100,
    1000 and 5000 (fewer sources than a warp's, and rows that start off a
    16-byte boundary), the wanted rows -1, 0, D-1, D, Dmax and drawn ones,
    all targets at D = 2, rows that rescale at every other step (theta
    0.999999: a mismatch multiplies a source by 1e6) and at every step (pfac
    1e11); and N = 16384 and
    N = 25827, the widest blocks, on 4 targets. Returns the records."""
    detail = []

    def both(label, theta, inputs):
        capture_against_plain(detail, label, theta, inputs)
        bwd_against_plain(detail, label, theta, inputs)

    for i, n in enumerate(N_SWEEP_EDGES):
        both("mixed", THETA, capture_inputs(n, 24, 40, SEED + i))
    for n in (100, 1000):
        both("theta 0.999999: a rescale every other step", 0.999999,
             capture_inputs(n, 24, 40, SEED + n, density=0.95))
        both("pfac 1e11: a rescale every step", THETA,
             capture_inputs(n, 24, 40, SEED + 2 * n, pfac_scale=1e11))
    both("D = 2 for all targets", THETA,
         capture_inputs(1000, 24, 6, SEED + 7, d_max=2))
    for i, n in enumerate(N_SWEEP_WIDE):
        both("mixed", THETA, capture_inputs(n, 4, 48, SEED + 11 + i))
    both("pfac 1e11: a rescale every step", THETA,
         capture_inputs(N_SWEEP_WIDE[-1], 4, 48, SEED + 13, pfac_scale=1e11))
    return detail


AT_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
           "rows_rescaled_elsewhere", "rows_max", "us_per_row", "ring_rows",
           "launch", "rescaled_row_share", "bytes_in_flight_per_sm",
           "emit_beta_max_abs_err", "emit_beta_ms", "emit_beta_launch")


def phase_kernels(panels):
    """Each kernel against its plain version on the card, at the shapes of
    the three main paths. ``panels``: {N: (G, bp, memory_gb)}. The rows of
    the sweeps and of the merge scan with clade rows hold the numbers at
    N = 1024 (the sweeps' numbers at N = 2048 and N = 4096 stand beside
    them under ``at_n2048`` and ``at_n4096``); the row of the large merge
    scan holds those at N = 2048, the incremental scan's those at
    N = 4096."""
    res, mat_small = sweep_rows(*panels[N_HAP], w=1)
    edges = sweep_edge_cases()
    for row in res:
        cases = [c for c in edges if c["kernel"].split("[")[0] == row["name"]]
        if cases:
            row["cases"] = cases
    res.append(merge_scan_row(mat_small))
    torch.cuda.empty_cache()
    wide, mat_large = sweep_rows(*panels[N_LARGE], w=1)
    for row, at in zip(res, wide):
        row["at_n2048"] = {k: at[k] for k in AT_KEYS if k in at}
    torch.cuda.empty_cache()
    wide, mat_inc = sweep_rows(*panels[N_INC], w=1)
    for row, at in zip(res, wide):
        row["at_n4096"] = {k: at[k] for k in AT_KEYS if k in at}
    torch.cuda.empty_cache()
    res.append(merge_scan_large_row(mat_large, mat_small))
    res.append(merge_scan_inc_row(mat_inc, mat_large))
    emit("kernels", kernels=res,
         tolerance="sweeps: rows/sum rtol 1e-5, logscale+log(sum) atol 2e-3; "
                   "merge scans: exact")
    return res


def phase_inc_edges():
    """Only B7 at the cluster's edge sizes against its plain version
    (``--phases inc_edges``, a short check of a new build)."""
    from relate_tpu_torch.ops import merge_scan_inc as mi
    detail = []
    inc_edge_cases(detail)
    emit("inc_edges", cases=detail, cluster=mi.cluster_config(N_INC))


def phase_dense_edges():
    """Only B5 and B6 at the edges of their grid against their plain
    versions (``--phases dense_edges``, a short check of a new build)."""
    from relate_tpu_torch.ops import merge_scan as ms
    emit("dense_edges", merge_scan=dense_edge_cases(large=False),
         merge_scan_large=dense_edge_cases(large=True),
         grid={n: ms.grid_config(n, large=n > ms.MAX_N_SMALL)
               for n in N_DENSE_EDGES + (N_HAP, N_ODD, N_LARGE)})


def phase_sweep_edges():
    """Only B2, B3 and B4 at the edges of their blocks and rings against
    their plain versions (``--phases sweep_edges``, a short check of a new
    build)."""
    emit("sweep_edges", cases=sweep_edge_cases(),
         tolerance="rows/sum rtol 1e-5, logscale+log(sum) atol 2e-3; "
                   "targets with no wanted row and rows at and past D "
                   "exactly zero")


def reset_counts():
    from relate_tpu_torch.ops import _build
    from relate_tpu_torch.ops import merge_scan as ms
    from relate_tpu_torch.ops import paint_kernels as pk
    _build.reset_launches(pk.launches, ms.launches)


# the kernels' rows by the names of their wrappers' counters
COUNTER_OF = {"paint_fwd": "fwd", "paint_bwd": "bwd",
              "paint_fwd_capture": "fwd_capture",
              "paint_bwd_capture": "bwd_capture", "merge_scan": "merge_scan",
              "merge_scan_large": "merge_scan_large",
              "merge_scan_inc": "merge_scan_inc"}


def read_counts():
    from relate_tpu_torch.ops import merge_scan as ms
    from relate_tpu_torch.ops import paint_kernels as pk
    both = {**pk.launches, **ms.launches}
    return {row: both[c] for row, c in COUNTER_OF.items()}


def read_counts_by_card():
    """{kernel row: {"cuda:k": launches}} since the last ``reset_counts``."""
    from relate_tpu_torch.ops import _build
    return {row: dict(_build.launches_by_card.get(c, {}))
            for row, c in COUNTER_OF.items()}


def check_tree(what, par, N):
    """A merge-ordered binary tree on N leaves: the root last, every parent
    an internal node above its child, every internal node two children."""
    M = 2 * N - 1
    par = np.asarray(par)
    if par.shape != (M,) or par[M - 1] != -1 or (par[:M - 1] < N).any() \
            or (par[:M - 1] <= np.arange(M - 1)).any():
        fail(f"{what} is not a merge-ordered tree")
    kids = np.bincount(par[:M - 1], minlength=M)
    if (kids[N:] != 2).any() or kids[:N].any():
        fail(f"{what} is not binary on {N} leaves")


def check_section(store, w, N, n_snps_expected):
    from relate_tpu_torch.io import ancmut
    anc = ancmut.read_anc_bin(store.path("chunk_0", f"trees_{w}.anc"))
    muts = ancmut.read_mut_short(store.path("chunk_0", f"muts_{w}.mut"))
    if anc.N != N or not anc.seq:
        fail(f"section {w}: empty or wrong-sized .anc")
    prev = -1
    for mt in anc.seq:
        tr = mt.tree
        check_tree(f"section {w}: tree at {mt.pos}", tr.parent, N)
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


def add_launches(kernels, path, counts):
    """Add one path's launch counts to the kernels' rows."""
    for k in kernels:
        k["launches"] += counts[k["name"]]
        k.setdefault("launches_by_path", {})[path] = counts[k["name"]]


def phase_main_path(G, bp, memory_gb, kernels):
    """MakeChunks -> Paint -> BuildTopology at N = 1024 through the port's
    entry points, with every launch count set to 0 just before and read just
    after. This is the path of the merge scan with clade rows."""
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth
    from relate_tpu_torch.utils.trace import stage, STAGES

    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        t0 = time.time()
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        t_inputs = time.time() - t0

        reset_counts()
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
        counts = read_counts()
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

    add_launches(kernels, "build_topology_n1024", counts)
    others = ("merge_scan_large", "merge_scan_inc")
    missing = [n for n, c in counts.items() if c <= 0 and n not in others]
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
    if any(counts[n] for n in others):
        fail("main_path: the N = 1024 path launched another merge scan")


def golden_clades(anc, muts, hi):
    """snp -> the carriers of its mapped branch, for the SNPs below
    ``hi`` mapped to one branch."""
    out, leaves = {}, {}
    for snp in range(hi):
        m = muts[snp]
        if len(m.branch) != 1:
            continue
        if m.tree not in leaves:
            leaves[m.tree] = anc.seq[m.tree].tree.leaf_matrix().astype(bool)
        out[snp] = frozenset(np.nonzero(leaves[m.tree][int(m.branch[0])])[0])
    return out


def phase_golden(kernels):
    """BuildTopology of the bundled example on the card: the C++
    reference's chunk 0 (``tests/golden``, N = 8, its own files read with
    the port's readers), painted on the card, then one section over its
    first ``GOLDEN_SNPS`` SNPs through the merge scan with clade rows (B5),
    against the reference's BuildTopology output ``postbt_0.anc/.mut``
    with the bounds of ``tests/test_torch_golden.py``: trees before the
    last ``GOLDEN_MARGIN`` SNPs 0.92 to 1.08 times the reference's, the
    carriers of each SNP's branch equal on at least 78 % of the SNPs both
    map (and more than 80 % of the SNPs mapped by both). The launches of
    each kernel; B5 must have run."""
    import gzip

    from relate_tpu_torch.core import painting, topology_device
    from relate_tpu_torch.io import ancmut, chunking

    t_phase = time.time()
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       "golden")
    with tempfile.TemporaryDirectory(prefix="relate_smoke_golden_") as tmp:
        for name in ("chunk_0.hap", "chunk_0.bp", "chunk_0.dist",
                     "chunk_0.r", "chunk_0.rpos", "chunk_0.state",
                     "postbt_0.anc", "postbt_0.mut"):
            with gzip.open(os.path.join(src, name + ".gz"), "rb") as a, \
                    open(os.path.join(tmp, name), "wb") as b:
                shutil.copyfileobj(a, b)
        ch = chunking.read_reference_chunk(os.path.join(tmp, "chunk_0"))
        ref_anc = ancmut.read_anc_bin(os.path.join(tmp, "postbt_0.anc"))
        ref_muts = ancmut.read_mut_short(os.path.join(tmp, "postbt_0.mut"))
    L, N = ch.G.shape
    reset_counts()
    t0 = time.time()
    painter = painting.Painter(ch.G, ch.r,
                               painting.PaintingModel(N=N, theta=THETA),
                               device=DEV)
    cps = painter.paint_stepping_stones(np.asarray([0, L]))
    res = topology_device.build_topology_section_device(
        painter, cps[0], ch.G, ch.rpos, ch.state, ch.bp, 0, GOLDEN_SNPS,
        seed=1)
    torch.cuda.synchronize()
    wall = time.time() - t0
    counts = read_counts()
    add_launches(kernels, "golden_n8", counts)
    hi = GOLDEN_SNPS - GOLDEN_MARGIN
    ours_trees = sum(1 for mt in res.anc.seq if mt.pos < hi)
    ref_trees = sum(1 for mt in ref_anc.seq if mt.pos < hi)
    ours = golden_clades(res.anc, res.muts, hi)
    ref = golden_clades(ref_anc, ref_muts, hi)
    common = set(ours) & set(ref)
    agree = sum(1 for snp in common if ours[snp] == ref[snp]) / max(
        len(common), 1)
    ratio = ours_trees / max(ref_trees, 1)
    emit("golden", N=N, L=L, snps=GOLDEN_SNPS, compared_below=hi,
         trees=ours_trees, reference_trees=ref_trees,
         tree_ratio=round(ratio, 4), snps_both_map=len(common),
         clade_agreement=round(agree, 4),
         bounds="tree ratio 0.92-1.08, clade agreement >= 0.78",
         build_s=round(wall, 3), launches=counts,
         seconds=round(time.time() - t_phase, 1))
    if counts["merge_scan"] <= 0:
        fail("golden: the merge scan with clade rows (B5) was not launched")
    if not (0.92 <= ratio <= 1.08 and ref_trees > 10
            and len(common) > 0.8 * hi and agree >= 0.78):
        fail(f"golden: BuildTopology outside the reference's bounds: "
             f"{ours_trees} trees against {ref_trees}, clade agreement "
             f"{agree:.3f} on {len(common)} SNPs")


def ancient_ages(N, n_old=128):
    """Sample ages in generations: the last ``n_old`` haplotypes (two
    haplotypes of one diploid sample sharing an age) spaced evenly from 200
    to 4,000; the others 0."""
    ages = np.zeros(N)
    ages[N - n_old:] = np.repeat(np.linspace(200.0, 4000.0, n_old // 2), 2)
    return ages


def check_ancient_trees(phase, anc, ages):
    """With sample ages: every node's age (coordinates from the sample ages
    and the branch lengths) is at least both children's, every ancient
    leaf's parent is older than the leaf, and a node's age taken up from its
    left child agrees with the one from its right child (the chains held
    the tips at their ages). Returns the worst relative disagreement."""
    N = anc.N
    old = np.nonzero(ages > 0)[0]
    worst = 0.0
    for mt in anc.seq:
        tr = mt.tree
        coords = tr.coordinates(ages)
        par = tr.parent[:-1]
        if (coords[par] < coords[:-1]).any():
            fail(f"{phase}: tree at {mt.pos} has a node younger than a "
                 "child")
        if not (coords[tr.parent[old]] > ages[old]).all():
            fail(f"{phase}: tree at {mt.pos} has an ancient leaf whose "
                 "parent is not older than it")
        bl = tr.branch_length
        via = np.zeros(len(tr.parent))
        via[:N] = ages
        for v in range(N, len(tr.parent)):     # children before parents
            a, b = tr.child_left[v], tr.child_right[v]
            via[v] = via[a] + bl[a]
            worst = max(worst, abs(via[v] - via[b] - bl[b]) / via[v])
    if worst > 1e-2:
        fail(f"{phase}: node ages from the two children disagree by "
             f"{worst:.3g} (relative): the chains did not hold the tips at "
             "their ages")
    return worst


def age_scan_cost(N, ages):
    """One age-aware tree build at width N on the card (the PyTorch-op
    scan with a clade prior): ms a build over 3 calls (CUDA events), and the
    kernels one build launches with the device's busy share
    (``torch.profiler``)."""
    from relate_tpu_torch.core import treebuilder as tb
    g = torch.Generator(device=DEV)
    g.manual_seed(SEED)
    d = torch.rand((N, N), generator=g, device=DEV)
    dcf = torch.rand((N, N), generator=g, device=DEV)
    thr, thr_cf = tb.thresholds(THETA)
    a = torch.as_tensor(ages, dtype=torch.float32, device=DEV)
    grid = torch.as_tensor(tb.age_grid(ages, 3e4).astype(np.float32),
                           device=DEV)

    def build():
        tb.quick_build_scan_ages(d, dcf, True, thr, thr_cf, 5, a, grid)
    ms = time_ms(build, 3)
    prof = profiled(build)
    return dict(N=N, ms=round(ms, 3), us_a_step=round(1e3 * ms / (N - 1), 2),
                kernels_a_build=prof["device_kernels"],
                device_busy_share=prof["device_busy_share"])


def check_final_trees(phase, anc, muts, L, N):
    """The checks of a final ``.anc``/``.mut`` of L SNPs and N haplotypes:
    one row a SNP, merge-ordered binary trees at ascending positions with
    finite branch lengths >= 0 (not all equal), valid SNP ranges, records
    that name a tree and have age_begin <= age_end, and mutations with an
    age. Returns (total branch length of each tree, not-mapping SNPs)."""
    if len(muts) != L or [m["snp"] for m in muts] != list(range(L)):
        fail(f"{phase}: {len(muts)} .mut rows for {L} SNPs")
    prev = -1
    totals = []
    for mt in anc.seq:
        check_tree(f"{phase}: tree at {mt.pos}", mt.tree.parent, N)
        bl = mt.tree.branch_length
        if not np.isfinite(bl).all() or (bl < 0).any():
            fail(f"{phase}: tree at {mt.pos} has a branch length that is "
                 "not finite or negative")
        if np.unique(bl[:-1]).size < 2:
            fail(f"{phase}: tree at {mt.pos} has all branch lengths equal")
        if mt.pos <= prev:
            fail(f"{phase}: tree positions are not ascending")
        if (mt.tree.SNP_begin > mt.tree.SNP_end).any():
            fail(f"{phase}: tree at {mt.pos} has SNP_begin > SNP_end")
        prev = mt.pos
        totals.append(float(bl.sum()))
    for m in muts:
        if not 0 <= m["tree"] < len(anc.seq):
            fail(f"{phase}: SNP {m['snp']} names tree {m['tree']}")
        if not (np.isfinite(m["age_begin"]) and np.isfinite(m["age_end"])
                and m["age_begin"] <= m["age_end"]):
            fail(f"{phase}: SNP {m['snp']} has age_begin > age_end")
    mapped = [m for m in muts if len(m["branch"]) == 1]
    if not any(m["age_end"] > 0 for m in mapped):
        fail(f"{phase}: no mutation has an age")
    return totals, sum(m["is_not_mapping"] for m in muts)


def phase_run_all(G, bp, memory_gb, kernels, phase, scan, ages=None,
                  postprocess=False, hand_over=None):
    """``run_all`` (Relate --mode All) through the port's entry point, with
    every launch count set to 0 just before and read just after, and the
    checks on the ``.anc``/``.mut`` it wrote. ``scan`` names the merge-scan
    kernel that this width must launch, once for every tree it builds, and
    the other two must not be launched at all. With ``ages`` (sample ages
    in generations) every tree is built by the age-aware scan, no merge-scan
    kernel is launched, and the trees must hold the ancient tips. With
    ``postprocess`` the run post-processes every chunk and associates its
    trees again; every window's records must then map their own SNPs
    (``check_window_mapping``). With ``hand_over`` (a path prefix) the
    ``.anc``/``.mut`` it wrote are copied there before its directory goes."""
    from relate_tpu_torch.io import ancmut
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth
    from relate_tpu_torch.utils.trace import STAGES

    L, N = G.shape
    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        t0 = time.time()
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        t_inputs = time.time() - t0

        ages_path = None
        if ages is not None:
            ages_path = os.path.join(tmp, "ages.txt")
            np.savetxt(ages_path, ages)

        reset_counts()
        del STAGES[:]
        out = os.path.join(tmp, "out")
        t0 = time.time()
        relate.run_all(prefix + ".haps", prefix + ".sample",
                       os.path.join(tmp, "map.txt"), out, seed=1,
                       memory_gb=memory_gb, theta=THETA, cleanup=False,
                       verbose=False, sample_ages_path=ages_path,
                       postprocess=postprocess, device=DEV)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = read_counts()
        peak = max(r.get("dev_peak_mb", 0.0) for r in STAGES) * 1e6

        store = ArtifactStore(out + ".tmpdir")
        plan, wplans = store.load_plan()
        W = wplans[0].num_windows
        if plan.N != N or plan.num_chunks != 1 or W < 2:
            fail(f"{phase}: N = {plan.N}, chunks = {plan.num_chunks}, "
                 f"W = {W}; wanted N = {N}, one chunk, W >= 2")
        trees_per_section = [len(ancmut.read_anc_bin(
            store.path("chunk_0", f"trees_{w}.anc")).seq) for w in range(W)]
        anc = ancmut.read_anc_text(out + ".anc")
        muts = ancmut.read_mut_final(out + ".mut")
        windows_mapping = (check_window_mapping(phase, store, N)
                           if postprocess else None)
        if hand_over:
            for ext in (".anc", ".mut"):
                shutil.copy(out + ext, hand_over + ext)

    if anc.N != N or len(anc.seq) != sum(trees_per_section):
        fail(f"{phase}: .anc has N = {anc.N} and {len(anc.seq)} trees; the "
             f"sections have {trees_per_section}")
    totals, n_not_mapping = check_final_trees(phase, anc, muts, L, N)
    extra = {}
    if ages is not None:
        # the text .anc writes the ages with six decimals
        if anc.sample_ages is None or len(anc.sample_ages) != N or \
                not np.allclose(anc.sample_ages, ages, rtol=0, atol=1e-6):
            fail(f"{phase}: the .anc does not carry the {N} sample ages")
        extra = dict(
            ancient_haplotypes=int((ages > 0).sum()),
            node_age_disagreement_max=check_ancient_trees(phase, anc, ages),
            age_scan=age_scan_cost(N, ages))
    if postprocess:
        extra = dict(postprocess=post_process_stats(phase, STAGES),
                     windows_mapping=windows_mapping)

    mcmc_stats = [m for r in STAGES for m in r.get("mcmc", [])]
    feb = [m for r in STAGES for m in r.get("feb", [])]
    # every tree build of BuildTopology, the reverted candidates included
    tree_builds = sum(m["tree_builds"] for r in STAGES
                      for m in r.get("topology", []))
    add_launches(kernels, f"{phase}_n{N}" if postprocess else
                 f"run_all_n{N}", counts)
    needed = ("paint_fwd", "paint_bwd", "paint_fwd_capture",
              "paint_bwd_capture") + ((scan,) if scan else ())
    missing = [n for n in needed if counts[n] <= 0]
    scans = ("merge_scan", "merge_scan_large", "merge_scan_inc")
    emit(phase, N=N, L=L, windows=W,
         boundaries=[int(b) for b in wplans[0].boundaries],
         memory_gb=memory_gb, wall_s=round(wall, 3),
         stages=[{k: r.get(k) for k in ("stage", "wall_s", "cpu_s",
                                         "dev_peak_mb")}
                 for r in STAGES],
         write_inputs_s=round(t_inputs, 2), launches=counts,
         trees=len(anc.seq), trees_per_section=trees_per_section,
         tree_builds=tree_builds,
         mcmc=mcmc_stats,
         mcmc_rounds_max=max(r["rounds"] for r in mcmc_stats),
         find_equivalent_branches=feb,
         total_branch_length_generations=dict(
             min=min(totals), median=float(np.median(totals)),
             max=max(totals)),
         not_mapping=n_not_mapping, not_mapping_share=n_not_mapping / L,
         flipped=sum(m["flipped"] for m in muts),
         peak_device_memory_gb=round(peak / 1e9, 3), **extra)
    if missing:
        fail(f"{phase}: kernels never launched: {missing}")
    if any(counts[n] for n in scans if n != scan):
        fail(f"{phase}: the N = {N} path launched another merge scan than "
             f"{scan}")
    launched = counts[scan] if scan else tree_builds
    if launched != tree_builds or tree_builds < len(anc.seq):
        fail(f"{phase}: {launched} merge scans for {tree_builds} tree "
             f"builds and {len(anc.seq)} trees")
    return dict(wall_s=round(wall, 3),
                stages={r["stage"]: r["wall_s"] for r in STAGES})


def paint_all_windows(painter, bounds):
    """The stepping stones and the repaint of every window; returns the
    checkpoints and the posteriors."""
    cps = painter.paint_stepping_stones(bounds)
    return cps, [painter.repaint(cp) for cp in cps]


def node_ages(anc):
    """(trees, nodes) ages in generations from the branch lengths of a
    merge-ordered .anc (a parent is older than its left child by that
    child's branch length)."""
    trees = [mt.tree for mt in anc.seq]
    cl = np.stack([t.child_left for t in trees])
    bl = np.stack([t.branch_length for t in trees])
    N = anc.N
    ages = np.zeros(cl.shape, dtype=np.float64)
    rows = np.arange(len(trees))
    for i in range(N, cl.shape[1]):
        c = cl[:, i]
        ages[:, i] = ages[rows, c] + bl[rows, c]
    return ages


def phase_mesh(G_hap, bp_hap, mem_hap, G, bp, memory_gb, one_card,
               handed, kernels):
    """The port on every card of this host as a mesh (``default_mesh()``,
    each card named once; on a one-card host a mesh of that card, where the
    threads, the dispatch and the gathers run with no copy between cards).

    - A ``parallel.pool.CardPool`` of the mesh (one worker on ``cuda:0``
      on a one-card host) started first, so that its start overlaps the
      steps below.
    - The Painter at N = 1024 (the main path's panel) with the mesh against
      the one-card Painter: checkpoints, posteriors and plans of every
      window equal bit for bit; both timed after one call each that starts
      every card. With more than one card also the stepping stones cut
      over the cards, a thread a card, split into the host planner and the
      rest on each thread (``painter_threads``).
    - ``run_all(mesh=)`` at N = 2048, L = 8192 (the ``run_all`` phase's
      panel, seed and budget): its .anc/.mut must equal that phase's output
      byte for byte (``handed``); each stage's time beside that phase's
      (``one_card``), the launches of each kernel by card (B3 and B4 of
      Paint on the first card, B1, B2 and B6 of BuildTopology on every
      card that built a section), each card's peak memory, the start of
      its own pool by worker where it has one.
    - InferBranchLengths of that run's store again, through the pool
      started first (twice: cold workers, then warm) and in this process
      on the first card, each writing that run's section files byte for
      byte; with more than one card also its chains dealt to the cards
      from this thread (``infer_threads_or_not``).
    - ``run_mcmc(mesh=)`` on the first 9 trees of section 0 of that run
      against ``mesh=None`` (rtol 1e-5, atol 1e-3; it runs on the first
      card), timed in the order card, mesh, mesh, card.
    - ``coalescence_counts_psum`` on the node ages of the final trees
      against a count on the host, and ``dryrun(len(mesh))``.
    """
    from relate_tpu_torch.parallel import mesh as pm

    from relate_tpu_torch.parallel.pool import CardPool

    t_phase = time.time()
    mesh = pm.default_mesh()
    cards = [str(d) for d in mesh]
    res = dict(mesh=cards, cards=len(mesh),
               card_names=[torch.cuda.get_device_name(d) for d in mesh])
    # the mesh's pool, and with several cards the two dealings of
    # infer_on_pool's two-card comparison, all started before the steps
    # that follow
    pools = [CardPool(m, timeout_s=600.0) for m in
             [mesh] + ([mesh[:2], mesh[:1], mesh[1:2]] if len(mesh) > 1
                       else [])]
    try:
        if len(mesh) > 1:
            # before any other sum across cards of this process
            res["reduce_sum"] = reduce_first_and_later(mesh)
        mesh_steps(res, mesh, pm, pools, G_hap, bp_hap, mem_hap, G, bp,
                   memory_gb, one_card, handed, kernels)
        res["tools"] = mesh_tools(mesh, handed, pools[0])
    finally:
        for p in pools:
            p.close()
        # what was measured before a failure is printed too
        emit("mesh", **res, seconds=round(time.time() - t_phase, 1))
    if not res["run_all"]["bytes_equal"]:
        fail(f"mesh: run_all(mesh=) wrote other bytes than one card: "
             f"{res['run_all']['bytes']}")
    if res["run_all"]["idle"]:
        fail(f"mesh: kernels not launched on every card: "
             f"{res['run_all']['idle']}")
    if not res["infer_pool"]["bytes_equal"]:
        fail(f"mesh: InferBranchLengths through the pool or on one card "
             f"wrote other section files: {res['infer_pool']['bytes']}")
    if not res["run_mcmc"]["within_tolerance"]:
        fail(f"mesh: run_mcmc(mesh=) differs from one card by "
             f"{res['run_mcmc']['max_abs_diff']}")
    if not res["coalescence_counts_psum"]["equal_to_host"]:
        fail("mesh: coalescence_counts_psum differs from the host count")
    unequal = {m: r["files_equal"] for m, r in res["tools"].items()
               if "files_equal" in r and not all(r["files_equal"].values())}
    if unequal:
        fail(f"mesh: the tools wrote other files on the mesh than on one "
             f"card: {unequal}")


def mesh_painter(res, mesh, G_hap, bp_hap, mem_hap):
    """The Painter at N = 1024 with the mesh against one card: checkpoints,
    posteriors and plans of every window equal bit for bit; after one call
    each that starts every card, timed in the order card, mesh, mesh,
    card."""
    from relate_tpu_torch.core import painting
    from relate_tpu_torch.io import chunking
    from relate_tpu_torch.io import haps as hio

    L1, N1 = G_hap.shape
    gmap = hio.GeneticMap(np.array([0.0, float(bp_hap[-1]) + 2e6]),
                          np.array([0.0, (float(bp_hap[-1]) + 2e6) / 1e6]))
    r = hio.rates_from_rpos(hio.interpolate_rpos(gmap, bp_hap))
    bounds = np.asarray(chunking.plan_chunks_and_windows(
        G_hap, mem_hap)[1][0].boundaries)
    model = painting.PaintingModel(N=N1, theta=THETA)
    painters = {"card": painting.Painter(G_hap, r, model, device=DEV),
                "mesh": painting.Painter(G_hap, r, model, mesh=mesh)}
    for p in painters.values():
        paint_all_windows(p, bounds)                # starts every card
    painter_times = {"card": [], "mesh": []}
    outs = {}
    for name in ("card", "mesh", "mesh", "card"):
        t0 = synced(mesh)
        out = paint_all_windows(painters[name], bounds)
        painter_times[name].append(round(synced(mesh) - t0, 3))
        outs.setdefault(name, out)
        del out
    del painters
    res["painter"] = dict(N=N1, L=L1, windows=len(bounds) - 1,
                          wall_s=painter_times, mesh_over_card=round(
                              sum(painter_times["mesh"])
                              / sum(painter_times["card"]), 3))
    (cps1, post1), (cps, post) = outs["card"], outs["mesh"]
    for w, (c1, c) in enumerate(zip(cps1, cps)):
        for f in ("alpha", "beta", "ls_alpha", "ls_beta", "bsb", "bse"):
            if not np.array_equal(getattr(c1, f), getattr(c, f)):
                fail(f"mesh: Painter checkpoint {w} {f} differs from one "
                     "card")
    for w, (o1, o) in enumerate(zip(post1, post)):
        same = (torch.equal(o1.topology, o.topology)
                and torch.equal(o1.logscale, o.logscale)
                and np.array_equal(o1.plan.D, o.plan.D)
                and all(torch.equal(getattr(o1.plan, f), getattr(o.plan, f))
                        for f in ("idx", "seqk", "pfac", "nxt", "kmask")))
        if not same:
            fail(f"mesh: Painter repaint of window {w} differs from one card")
    res["painter"]["bit_equal"] = True


def mesh_steps(res, mesh, pm, pools, G_hap, bp_hap, mem_hap, G, bp,
               memory_gb, one_card, handed, kernels):
    """The steps of ``phase_mesh``, each adding its numbers to ``res``."""
    from relate_tpu_torch.core import mcmc
    from relate_tpu_torch.io import ancmut
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth
    from relate_tpu_torch.utils.trace import STAGES

    cards = res["mesh"]
    if len(set(cards)) != len(cards) or len(mesh) != torch.cuda.device_count():
        fail(f"mesh: {cards} is not every card of this host once")
    # in a function of its own, so that none of its posteriors stays
    # allocated through the run_all below (and in its peak memory)
    mesh_painter(res, mesh, G_hap, bp_hap, mem_hap)
    if len(mesh) > 1:
        res["painter_threads"] = painter_threads(mesh, G_hap, bp_hap,
                                                 mem_hap)
    torch.cuda.empty_cache()

    # run_all on the mesh at N = 2048
    L, N = G.shape
    with tempfile.TemporaryDirectory(prefix="relate_smoke_mesh_") as tmp:
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        reset_counts()
        del STAGES[:]
        out = os.path.join(tmp, "out")
        t0 = time.time()
        relate.run_all(prefix + ".haps", prefix + ".sample",
                       os.path.join(tmp, "map.txt"), out, seed=1,
                       memory_gb=memory_gb, theta=THETA, cleanup=False,
                       verbose=False, mesh=mesh)
        for d in mesh:
            torch.cuda.synchronize(d)
        wall = time.time() - t0
        counts = read_counts()
        by_card = read_counts_by_card()
        peaks = {}
        for rec in STAGES:
            for card, mb in rec.get("dev_peak_mb_by_card", {}).items():
                peaks[card] = max(peaks.get(card, 0.0), mb)
        equal = {ext: same_bytes(out + ext, handed + ext)
                 for ext in (".anc", ".mut")}
        store = ArtifactStore(out + ".tmpdir")
        ch = store.load_chunk(0)
        secs = [ancmut.read_anc_bin(store.path("chunk_0", f"trees_{w}.anc"))
                for w in range(ch.windows.num_windows)]
        final = ancmut.read_anc_text(out + ".anc")
        stages = [dict(r) for r in STAGES]
        res["infer_pool"] = infer_on_pool(pools, store, mesh)

    add_launches(kernels, f"mesh_run_all_n{N}", counts)
    for k in kernels:
        k.setdefault("launches_by_card", {})[f"mesh_run_all_n{N}"] = \
            by_card[k["name"]]
    # Paint's capture sweeps run on the first card, BuildTopology's repaint
    # and merge scan on every card that got a section
    builders = cards[:min(len(cards), ch.windows.num_windows)]
    on = {"paint_fwd_capture": cards[:1], "paint_bwd_capture": cards[:1],
          "paint_fwd": builders, "paint_bwd": builders,
          "merge_scan_large": builders}
    idle = {n: [c for c in want if by_card[n].get(c, 0) <= 0]
            for n, want in on.items()}
    res["run_all"] = dict(
        N=N, L=L, windows=ch.windows.num_windows, memory_gb=memory_gb,
        wall_s=round(wall, 3), one_card_wall_s=one_card["wall_s"],
        stages={r["stage"]: dict(mesh=r["wall_s"],
                                 one_card=one_card["stages"].get(r["stage"]),
                                 cpu_s=r["cpu_s"],
                                 peak_mb_by_card=r.get("dev_peak_mb_by_card"),
                                 **({"pool_start_s": r["pool_start_s"]}
                                    if "pool_start_s" in r else {}))
                for r in stages},
        bytes_equal=all(equal.values()), bytes=equal, launches=counts,
        launches_by_card=by_card,
        idle={n: c for n, c in idle.items() if c},
        peak_device_memory_mb_by_card=peaks,
        mcmc=[m for rec in stages for m in rec.get("mcmc", [])])

    # run_mcmc on 9 trees with and without the mesh
    trees = [mt.tree for mt in secs[0].seq[:9]]
    dist = ch.dist.astype(np.float64)
    chains = []
    mcmc_times = {"card": [], "mesh": []}
    ways = {"card": dict(device=DEV), "mesh": dict(mesh=mesh)}
    for name in ("card", "mesh", "mesh", "card"):
        t0 = synced(mesh)
        chains.append(mcmc.run_mcmc(trees, dist, ch.L, seed=11,
                                    **ways[name]))
        mcmc_times[name].append(round(synced(mesh) - t0, 3))
    res["run_mcmc"] = dict(
        trees=len(trees), nodes=trees[0].num_nodes,
        max_abs_diff=max(float(np.abs(c - chains[0]).max())
                         for c in chains),
        within_tolerance=all(np.allclose(c, chains[0], rtol=1e-5, atol=1e-3)
                             for c in chains),
        wall_s=mcmc_times, mesh_over_card=round(
            sum(mcmc_times["mesh"]) / sum(mcmc_times["card"]), 3),
        tolerance="rtol 1e-5, atol 1e-3")

    # the reduction and the dry run
    ages = node_ages(final)
    epochs = np.concatenate([[0.0], 10.0 ** np.arange(2.0, 7.01, 0.25)])
    t0 = time.time()
    counts_red = pm.coalescence_counts_psum(mesh, ages, epochs).cpu().numpy()
    psum_s = time.time() - t0
    e = np.searchsorted(epochs.astype(np.float32),
                        ages.astype(np.float32).ravel(), side="right") - 1
    counts_host = np.bincount(e[e >= 0], minlength=len(epochs))
    res["coalescence_counts_psum"] = dict(
        trees=int(ages.shape[0]), epochs=len(epochs),
        equal_to_host=bool(np.array_equal(counts_red, counts_host)),
        ms=round(psum_s * 1e3, 2))
    t0 = time.time()
    dry = pm.dryrun(len(mesh))
    res["dryrun"] = dict(counts=dry.tolist(), wall_s=round(time.time() - t0,
                                                           3))


def infer_on_pool(pools, store, mesh):
    """InferBranchLengths of ``run_all``'s chunk 0 again on its ``store``,
    each way writing the section files that ``run_all`` wrote (the chains
    do not read the lengths they replace), which must stay byte for byte:
    through ``pools[0]`` (a ``parallel.pool.CardPool`` of the mesh, started
    at the phase's start: each worker's seconds until it was ready), twice
    (its workers cold, then warm), and in this process on the first card.
    Each way's stage seconds and ``mcmc`` notes (one a section); with more
    than one card also ``dealing_on_two_cards`` (``pools[1:]``) and
    ``infer_threads_or_not``."""
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils.trace import STAGES, stage
    W = store.load_chunk(0).windows.num_windows
    paths = [store.path("chunk_0", f"trees_{w}.anc") for w in range(W)]
    want = [open(p, "rb").read() for p in paths]
    pool = pools[0]
    t0 = time.time()
    start_s = pool.start_s()
    res = dict(workers=[str(d) for d in pool.mesh], pool_start_s=start_s,
               wait_for_start_s=round(time.time() - t0, 3), sections=W)
    equal = {}
    for way in ("pool_cold", "pool_warm", "one_card"):
        kw = (dict(pool=pool) if way.startswith("pool")
              else dict(device=mesh.first))
        with stage(f"infer_{way}", verbose=False, devices=mesh):
            relate.infer_branch_lengths(store, 0, seed=1, **kw)
        rec = STAGES[-1]
        res[way] = dict(s=rec["wall_s"], mcmc_notes=len(rec.get("mcmc", [])),
                        peak_mb_by_card=rec.get("dev_peak_mb_by_card"))
        equal[way] = all(open(p, "rb").read() == b
                         for p, b in zip(paths, want))
    res["pool_warm_over_one_card"] = round(
        res["pool_warm"]["s"] / res["one_card"]["s"], 3)
    res["bytes"] = equal
    res["bytes_equal"] = all(equal.values()) and all(
        res[w]["mcmc_notes"] == W for w in ("pool_cold", "pool_warm",
                                            "one_card"))
    if len(mesh) > 1:
        res["dealing_on_two_cards"] = dealing_on_two_cards(
            pools[1], pools[2:], store, paths, want)
        res["infer_threads"] = infer_threads_or_not(mesh, store)
    return res


def dealing_on_two_cards(two, each, store, paths, want):
    """InferBranchLengths' sections of ``store``'s chunk 0 on the first two
    cards, dealt two ways: the library's queue, the longest sections first,
    to whichever worker of ``two`` (a pool of the two cards) is free, and
    section w to card w mod 2, each card's sections issued to its own
    one-worker pool of ``each`` from a thread of its own. Each way twice
    (cold, warm workers) in the order queue, mod, mod, queue; every run
    must leave the section files byte for byte."""
    from concurrent.futures import ThreadPoolExecutor

    from relate_tpu_torch.pipeline import relate
    W = store.load_chunk(0).windows.num_windows

    def queue():
        relate.infer_branch_lengths(store, 0, seed=1, pool=two)

    def mod():
        def card(k):
            for w in range(k, W, 2):
                relate.infer_branch_lengths(store, 0, seed=1, pool=each[k],
                                            first_section=w, last_section=w)
        with ThreadPoolExecutor(max_workers=2) as ex:
            for f in [ex.submit(card, k) for k in range(2)]:
                f.result()

    for p in [two] + list(each):
        p.start_s()
    res = {"queue": [], "mod": []}
    equal = True
    for name, fn in (("queue", queue), ("mod", mod), ("mod", mod),
                     ("queue", queue)):
        t0 = time.time()
        fn()
        res[name].append(round(time.time() - t0, 3))
        equal &= all(open(p, "rb").read() == b for p, b in zip(paths, want))
    res["equal"] = equal
    if not equal:
        fail("mesh: InferBranchLengths dealt to two cards wrote other "
             "section files")
    return res


def infer_threads_or_not(mesh, store):
    """InferBranchLengths' chain batches of ``store``'s chunk 0 (one a
    section, with the seeds of ``relate.infer_branch_lengths``), section w
    on card w mod D, issued from this thread one after the other (each
    section's seconds too; ``one_thread``): the design of one process for
    several cards, beside the pool of one process a card timed in
    ``infer_on_pool``. The lengths must be those the files hold."""
    from relate_tpu_torch.core import mcmc
    from relate_tpu_torch.io import ancmut
    D = len(mesh)
    ch = store.load_chunk(0)
    W = ch.windows.num_windows
    secs = [ancmut.read_anc_bin(store.path("chunk_0", f"trees_{w}.anc"))
            for w in range(W)]
    dist = ch.dist.astype(np.float64)
    got, per_section = {}, []
    c0 = time.thread_time()
    t0 = synced(mesh)
    for w in range(W):
        got[w] = mcmc.run_mcmc([mt.tree for mt in secs[w].seq], dist, ch.L,
                               seed=1 + 7919 + w, device=mesh[w % D])
        per_section.append(round(synced(mesh) - t0 - sum(per_section), 3))
    res = dict(sections=W, chains=[len(s.seq) for s in secs],
               one_thread=dict(s=round(synced(mesh) - t0, 3),
                               section_s=per_section,
                               cpu_s=round(time.thread_time() - c0, 3)))
    res["equal"] = all(
        np.array_equal(got[w], np.stack([mt.tree.branch_length
                                         for mt in secs[w].seq]))
        for w in range(W))
    if not res["equal"]:
        fail("mesh: InferBranchLengths' chains dealt to the cards from one "
             "thread differ from the lengths of the files")
    return res


def painter_threads(mesh, G_hap, bp_hap, mem_hap):
    """Where a thread a card loses in the Painter (the design that
    ``Painter(mesh=)`` had before its sweeps moved to the first card): the
    stepping stones at N = 1024 with the targets cut into one block a card,
    each block chained through every window on its card's replica
    (``Painter.shards``) from a host thread of its own
    (``parallel.mesh.per_card``), against all targets on the first card
    from this thread. Each way timed on its second call; each thread's
    seconds split into the host planner (``_prep``, ``_rows_of_sites``,
    ``_extended_final_raw``) and the rest (the sweeps' launches and the
    logscales' downloads). The slabs and logscales joined must equal one
    card's bit for bit."""
    import threading

    from relate_tpu_torch.core import painting
    from relate_tpu_torch.io import chunking
    from relate_tpu_torch.io import haps as hio
    from relate_tpu_torch.parallel import mesh as pm

    L1, N1 = G_hap.shape
    gmap = hio.GeneticMap(np.array([0.0, float(bp_hap[-1]) + 2e6]),
                          np.array([0.0, (float(bp_hap[-1]) + 2e6) / 1e6]))
    r = hio.rates_from_rpos(hio.interpolate_rpos(gmap, bp_hap))
    bounds = np.asarray(chunking.plan_chunks_and_windows(
        G_hap, mem_hap)[1][0].boundaries)
    painter = painting.Painter(G_hap, r, painting.PaintingModel(
        N=N1, theta=THETA), mesh=mesh)
    bsb, bse = painter.window_boundary_sites(bounds)
    W = len(bounds) - 1
    parts = pm.blocks(N1, len(mesh))
    spent = {}
    lock = threading.Lock()
    planners = ("_prep", "_rows_of_sites", "_extended_final_raw")
    originals = {n: getattr(painting.Painter, n) for n in planners}

    def timed(name, fn):
        def run(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                key = (threading.get_ident(), name)
                with lock:
                    spent[key] = spent.get(key, 0.0) + time.perf_counter() - t
        return run

    def stones(k, dev, lo, hi):
        t = time.perf_counter()
        out = painter.shards[k]._stones(
            bsb, bse, np.arange(lo, hi, dtype=np.int32), W)
        torch.cuda.synchronize(dev)
        return out, threading.get_ident(), time.perf_counter() - t

    def one_card():
        return [stones(0, mesh[0], 0, N1)]

    def threaded():
        return pm.per_card(mesh, lambda k, dev: stones(k, dev, *parts[k]),
                           len(parts))

    res = dict(N=N1, windows=W, blocks=parts)
    for n in planners:
        setattr(painting.Painter, n, timed(n, originals[n]))
    try:
        for way, fn in (("one_card", one_card), ("thread_a_card", threaded)):
            fn()                                  # starts every card
            spent.clear()
            t0 = synced(mesh)
            outs = fn()
            wall = synced(mesh) - t0
            res[way] = dict(s=round(wall, 4), threads=[
                dict(s=round(s, 4), **{n.strip("_") + "_s": round(
                    spent.get((ident, n), 0.0), 4) for n in planners})
                for _, ident, s in outs])
            for th in res[way]["threads"]:
                th["rest_s"] = round(th["s"] - sum(
                    th[n.strip("_") + "_s"] for n in planners), 4)
            res[way + "_outs"] = [o for o, _, _ in outs]
    finally:
        for n, f in originals.items():
            setattr(painting.Painter, n, f)
    one = res.pop("one_card_outs")[0]
    cut = res.pop("thread_a_card_outs")
    equal = True
    for i in range(4):
        for w in range(W):
            parts_w = [o[i][w] for o in cut]
            if isinstance(one[i][w], torch.Tensor):
                joined = torch.cat([p.to(one[i][w].device) for p in parts_w])
                equal &= bool(torch.equal(joined, one[i][w]))
            else:
                equal &= bool(np.array_equal(np.concatenate(parts_w),
                                             one[i][w]))
    res["equal"] = equal
    res["thread_a_card_over_one_card"] = round(
        res["thread_a_card"]["s"] / res["one_card"]["s"], 3)
    if not equal:
        fail("mesh: the Painter's blocks on the cards differ from one card")
    return res


def synced(mesh):
    """The host clock once every card of ``mesh`` has finished."""
    for d in mesh:
        torch.cuda.synchronize(d)
    return time.time()


def reduce_first_and_later(mesh, reps=10):
    """The sum of one (E, 2G, G) float64 tensor a card onto the first card
    (the shape of ``coalescence_stats``' partial sums; E = 31, G = 2 and
    G = 256) two ways: ``parallel.mesh.reduce_sum`` (peer copies added in
    mesh order) and ``torch.cuda.comm.reduce_add``. The first call of each
    (``reduce_sum`` first, before any other sum across cards of this
    process) and the median of ``reps`` later calls, in ms; each result
    must equal the sum taken on the host."""
    from torch.cuda import comm

    from relate_tpu_torch.parallel import mesh as pm
    out = {}
    for G in (2, 256):
        parts = [torch.full((31, 2 * G, G), float(k + 1), dtype=torch.float64,
                            device=d) for k, d in enumerate(mesh)]
        want = float(len(mesh) * (len(mesh) + 1) // 2)

        def ms(fn):
            t0 = synced(mesh)
            r = fn()
            t = synced(mesh) - t0
            if r.device != mesh.first or not bool((r == want).all()):
                fail(f"mesh: a sum across the cards is not {want} on "
                     f"{mesh.first}")
            return t * 1e3
        ways = {"reduce_sum": lambda: pm.reduce_sum(parts, mesh),
                "reduce_add": lambda: comm.reduce_add(
                    parts, destination=mesh.first.index)}
        rec = {w: dict(first_ms=round(ms(f), 3)) for w, f in ways.items()}
        for w, f in ways.items():
            rec[w]["later_ms"] = round(float(np.median(
                [ms(f) for _ in range(reps)])), 4)
        out[f"G={G}"] = rec
    return out


def mesh_tools(mesh, prefix, pool):
    """The CoalescentRate tool through its CLI, each mode once on one card
    (``--device``) and once with ``--devices D``: EstimatePopulationSize
    with two groups on ``prefix`` (``run_all``'s N = 2048 output; the
    statistics run on the first card), then EstimatePopulationSizeEM
    (``MESH_EM_ITERS`` iteration, two groups) and SampleBranchLengths
    (``.timeb``, ``MESH_SBL_SAMPLES`` samples, under a one-card ``.coal``
    of ``prefix``) on ``parts_store``'s trees, whose chain parts go to a
    pool of one process a card of the mesh that the tool starts. Their
    files must be equal byte for byte; each run's wall seconds, the card of
    every ``coalescence_stats`` call and chain part, the pool's start by
    worker and each card's peak memory. Then ``mesh_dealing`` on ``prefix``
    with ``pool`` (the phase's pool of the mesh)."""
    from relate_tpu_torch.pipeline import tools_cli
    from relate_tpu_torch.utils.trace import STAGES

    out = {}
    with tempfile.TemporaryDirectory(prefix="relate_smoke_mesh_tools_") as tmp:
        o = lambda name: os.path.join(tmp, name)  # noqa: E731
        store = o("parts")
        t0 = time.time()
        N, trees = parts_store(prefix, store)
        out["parts_store"] = dict(trees=trees, copies=MESH_STORE_COPIES,
                                  s=round(time.time() - t0, 3))
        pl = o("two.poplabels")
        write_poplabels(pl, N)
        if tools_cli.main(["CoalescentRate", "--mode",
                           "EstimatePopulationSize", "-i", prefix, "-o",
                           o("prior"), "--device", DEV]) != 0:
            fail("mesh: EstimatePopulationSize for the prior failed")
        for name, mode, src, args, files in (
                ("eps", "EstimatePopulationSize", prefix,
                 ["--poplabels", pl], (".coal", ".pairwise.coal")),
                ("em", "EstimatePopulationSizeEM", store,
                 ["--poplabels", pl, "--num_iter", str(MESH_EM_ITERS)],
                 (".coal", ".pairwise.coal", ".anc", ".mut")),
                ("sbl", "SampleBranchLengths", store,
                 ["--coal", o("prior.coal"), "--format", "timeb",
                  "--num_samples", str(MESH_SBL_SAMPLES)], (".timeb",))):
            rec = dict(mode=mode, input="run_all" if src == prefix
                       else "parts_store")
            for where, dev in (("card", ["--device", DEV]),
                               ("mesh", ["--devices", str(len(mesh))])):
                del STAGES[:]
                t0 = synced(mesh)
                rc = tools_cli.main(["CoalescentRate", "--mode", mode, "-i",
                                     src, "-o", o(f"{where}_{name}"),
                                     *args, *dev])
                wall = synced(mesh) - t0
                if rc != 0:
                    fail(f"mesh: {mode} on the {where} returned {rc}")
                starts = [r["pool_start_s"] for r in STAGES
                          if "pool_start_s" in r]
                peaks = {}
                for r in STAGES:
                    for card, mb in r.get("dev_peak_mb_by_card", {}).items():
                        peaks[card] = max(peaks.get(card, 0.0), mb)
                rec[where] = dict(
                    wall_s=round(wall, 3),
                    coal_stats_on=[m["device"] for r in STAGES
                                   for m in r.get("coal_stats", [])],
                    chain_parts_on=[m["device"] for r in STAGES
                                    for m in r.get("mcmc", [])],
                    chains_a_part=[m["chains"] for r in STAGES
                                   for m in r.get("mcmc", [])],
                    pool_start_s=starts[0] if starts else None,
                    peak_mb_by_card=peaks)
            rec["files_equal"] = {f: same_bytes(o(f"card_{name}{f}"),
                                                o(f"mesh_{name}{f}"))
                                  for f in files}
            if name != "eps" and len(mesh) > 1 and (
                    rec["mesh"]["pool_start_s"] is None
                    or len(set(rec["mesh"]["chain_parts_on"])) < 2):
                fail(f"mesh: {mode} --devices gave its chain parts to no "
                     f"pool of the cards: {rec['mesh']}")
            out[name] = rec
        out.update(mesh_dealing(mesh, prefix, o("prior.coal"), pool))
    return out


def parts_store(prefix, out, copies=MESH_STORE_COPIES):
    """``prefix``'s ``.anc``/``.mut`` repeated ``copies`` times along the
    chromosome (each copy's SNPs, trees and positions after the last
    copy's), written with the port's writers as ``out``.anc/.mut: a tree
    sequence of several chain parts (``mcmc.chain_batch_cap``). Returns
    its haplotypes and trees."""
    from relate_tpu_torch.core.topology import MutationRecord
    from relate_tpu_torch.core.trees import AncesTree, MarginalTree
    from relate_tpu_torch.pipeline import scripts

    anc, recs, bp, dist, rsid, alleles = scripts._load_pair(prefix)
    T, L, shift = len(anc.seq), len(recs), int(bp[-1]) + 1
    seq, rows = [], []
    for k in range(copies):
        for mt in anc.seq:
            t = mt.tree.copy()
            t.SNP_begin = t.SNP_begin + k * L
            t.SNP_end = t.SNP_end + k * L
            seq.append(MarginalTree(pos=mt.pos + k * L, tree=t))
        rows += [MutationRecord(tree=m.tree + k * T, branch=list(m.branch),
                                flipped=m.flipped) for m in recs]
    scripts._dump_pair(out, AncesTree(N=anc.N, seq=seq,
                                      sample_ages=anc.sample_ages), rows,
                       np.concatenate([bp + k * shift
                                       for k in range(copies)]),
                       np.tile(dist, copies), list(rsid) * copies,
                       list(alleles) * copies)
    return anc.N, len(seq)


def mesh_dealing(mesh, prefix, prior, pool):
    """The ways to give the cards of ``mesh`` the tools' work, each beside
    one card on the same inputs (the trees of ``prefix``, the rates of the
    ``.coal`` file ``prior``): ``sample_parts`` through ``pool`` (a
    ``CardPool`` of the mesh), and with more than one card
    ``coal_stats_dealt``."""
    from relate_tpu_torch.evaluate import coalrate
    from relate_tpu_torch.pipeline import scripts

    anc, recs, bp, dist = scripts._load_pair(prefix)[:4]
    N = anc.N
    _, epochs_p, rates_p = coalrate.read_coal(prior)
    out = dict(sample_parts=sample_parts(mesh, pool, anc, recs, dist,
                                         epochs_p, rates_p[:, 0, 0]))
    if len(mesh) > 1:
        group = np.repeat((np.arange(N // 2) >= N // 4).astype(np.int64), 2)
        out["coal_stats_dealt"] = coal_stats_dealt(
            mesh, [mt.tree for mt in anc.seq],
            coalrate.tree_spans(anc, recs, dist), coalrate.default_epochs(),
            group)
    return out


def phase_dealing(prefix):
    """``--phases dealing`` (more than one card): ``mesh_dealing`` alone on
    every card of this host, on ``run_all``'s N = 2048 output ``prefix``,
    under the ``.coal`` of its EstimatePopulationSize on one card, with a
    pool of the mesh started first; the mesh phase's four-card
    measurement without the rest of that phase."""
    from relate_tpu_torch.parallel import mesh as pm
    from relate_tpu_torch.parallel.pool import CardPool
    from relate_tpu_torch.pipeline import tools_cli

    t_phase = time.time()
    mesh = pm.default_mesh()
    if len(mesh) < 2:
        fail("dealing: needs more than one card")
    with CardPool(mesh, timeout_s=600.0) as pool, \
            tempfile.TemporaryDirectory(prefix="relate_smoke_dealing_") as tmp:
        prior = os.path.join(tmp, "prior")
        if tools_cli.main(["CoalescentRate", "--mode",
                           "EstimatePopulationSize", "-i", prefix, "-o",
                           prior, "--device", DEV]) != 0:
            fail("dealing: EstimatePopulationSize for the prior failed")
        res = mesh_dealing(mesh, prefix, prior + ".coal", pool)
    emit("dealing", mesh=[str(d) for d in mesh], **res,
         seconds=round(time.time() - t_phase, 1))


def coal_stats_dealt(mesh, trees, spans, epochs, group,
                     batch=MESH_STATS_BATCH):
    """``coalescence_stats``' batches of ``batch`` trees on one card (the
    library) and dealt over the cards of ``mesh``, batch i to card i mod D,
    each card adding into (E, 2G, G) float64 sums of its own that
    ``parallel.mesh.reduce_sum`` adds onto the first card: issued in turn
    from this thread, and from a host thread a card (``per_card``). Each
    way's ms (the second call of each), its counts equal to one card's and
    its opportunity within rtol 1e-12."""
    from relate_tpu_torch.evaluate import coalrate
    from relate_tpu_torch.parallel import mesh as pm

    E, N, D = len(epochs), trees[0].N, len(mesh)
    G = int(group.max()) + 1
    onehot = np.zeros((N, G), np.float32)
    onehot[np.arange(N), group] = 1.0
    live = [i for i in range(len(trees)) if spans[i] != 0.0]
    starts = list(range(0, len(live), batch))

    def inputs(dev):
        return (torch.as_tensor(np.asarray(epochs, np.float64), device=dev),
                torch.as_tensor(onehot, device=dev),
                torch.as_tensor(np.asarray(spans, np.float64), device=dev),
                torch.zeros((E, 2 * G, G), dtype=torch.float64, device=dev))

    def add(dev, on, s):
        eps_d, oh_d, f_d, PR = on
        idx = live[s: s + batch]
        nodes = coalrate._Nodes(trees, idx, oh_d, eps_d, None, dev)
        coalrate._stats_batch(nodes, f_d[torch.as_tensor(idx, device=dev)],
                              PR)

    def finish(on):
        PR = pm.reduce_sum([x[3] for x in on], mesh)
        c, op = PR[:, :G], coalrate._opportunity(PR[:, :G], PR[:, G:],
                                                on[0][0])
        return (0.5 * (c + c.transpose(1, 2))).cpu().numpy(), \
            (0.5 * (op + op.transpose(1, 2))).cpu().numpy()

    def one_thread():
        on = [inputs(d) for d in mesh]
        for i, s in enumerate(starts):
            add(mesh[i % D], on[i % D], s)
        return finish(on)

    def thread_a_card():
        def card(k, dev):
            on = inputs(dev)
            for s in starts[k::D]:
                add(dev, on, s)
            return on
        return finish(pm.per_card(mesh, card))

    ways = {"one_card": lambda: coalrate.coalescence_stats(
                trees, spans, epochs, group, batch=batch, device=mesh.first),
            "one_thread": one_thread, "thread_a_card": thread_a_card}
    got, ms = {}, {}
    for w, fn in ways.items():
        fn()
        t0 = synced(mesh)
        got[w] = fn()
        ms[w] = round((synced(mesh) - t0) * 1e3, 3)
    c1, o1 = got["one_card"]
    for w in ("one_thread", "thread_a_card"):
        c, op = got[w]
        if not (np.array_equal(c, c1)
                and np.allclose(op, o1, rtol=1e-12, atol=0.0)):
            fail(f"mesh: coalescence_stats' batches dealt ({w}) differ from "
                 "one card beyond rtol 1e-12")
    return dict(trees=len(live), batch=batch, batches=len(starts), ms=ms,
                counts_equal=True, opportunity_max_rel={
                    w: max_rel(got[w][1], o1)
                    for w in ("one_thread", "thread_a_card")})


def sample_parts(mesh, pool, anc, recs, dist, epochs, rates, seed=5):
    """``sample_branch_lengths`` on ``SAMPLE_PARTS`` parts of
    ``chain_batch_cap`` chains (the trees of ``anc`` repeated), one sample
    of ``PARTS_PROPOSALS`` proposals, each way on the same inputs: the
    library on the first card, the library with ``pool`` (a ``CardPool``
    of the mesh that has run InferBranchLengths' chains; one worker on
    ``cuda:0`` on a one-card host), with more than one card twice, its
    workers' first piecewise prior (cold) and then warm, and
    with more than one card the parts dealt over the cards in turn from
    this thread, part p on card p mod D, each calling the library on its
    card with its part's seed. The draws must be equal; each way's wall
    seconds and the seconds of each part where it ran, and the warm pool's
    over one card's."""
    from relate_tpu_torch.core import mcmc
    from relate_tpu_torch.core.trees import AncesTree
    from relate_tpu_torch.evaluate import sampling
    from relate_tpu_torch.utils.trace import STAGES, stage

    D, T0 = len(mesh), len(anc.seq)
    cap = mcmc.chain_batch_cap(anc.seq[0].tree.num_nodes)
    seq = [anc.seq[i % T0] for i in range(SAMPLE_PARTS * cap)]
    kw = dict(num_samples=1, num_proposals=PARTS_PROPOSALS)

    def part(k, dev):
        return sampling.sample_branch_lengths(
            AncesTree(N=anc.N, seq=seq[k * cap: (k + 1) * cap],
                      sample_ages=anc.sample_ages), recs, dist, 1.25e-8,
            epochs, rates, seed=seed + 7 * (k * cap + 1), device=dev, **kw)

    def library(**where):
        return sampling.sample_branch_lengths(
            AncesTree(N=anc.N, seq=seq, sample_ages=anc.sample_ages), recs,
            dist, 1.25e-8, epochs, rates, seed=seed, **where, **kw)
    ways = {"one_card": lambda: library(device=mesh.first)}
    if D > 1:
        ways["pool_cold"] = lambda: library(pool=pool)
    ways["pool_warm"] = lambda: library(pool=pool)
    if D > 1:
        ways["one_thread"] = lambda: np.concatenate(
            [part(k, mesh[k % D]) for k in range(SAMPLE_PARTS)], axis=1)
    got, secs, on, part_s = {}, {}, {}, {}
    for w, fn in ways.items():
        with stage(f"sample_parts_{w}", verbose=False, devices=mesh):
            t0 = synced(mesh)
            got[w] = fn()
            secs[w] = round(synced(mesh) - t0, 3)
        on[w] = [m["device"] for m in STAGES[-1].get("mcmc", [])]
        part_s[w] = [m["wall_s"] for m in STAGES[-1].get("mcmc", [])]
        if not np.array_equal(got[w], got["one_card"]):
            fail(f"mesh: sample_branch_lengths' parts ({w}) differ from "
                 "one card's")
    if len(on["pool_warm"]) != SAMPLE_PARTS or on["one_card"] != \
            [str(mesh.first)] * SAMPLE_PARTS:
        fail(f"mesh: sample_branch_lengths' parts ran elsewhere: {on}")
    return dict(parts=SAMPLE_PARTS, chains_a_part=cap,
                nodes=anc.seq[0].tree.num_nodes, workers=[
                    str(d) for d in pool.mesh],
                proposals_a_sample=PARTS_PROPOSALS, s=secs, parts_on=on,
                part_s=part_s,
                pool_warm_over_one_card=round(
                    secs["pool_warm"] / secs["one_card"], 3), equal=True)


def phase_hosts(G, bp, kernels):
    """``--mode All`` on two hosts: two processes of the port's CLI
    (``host_worker``) with ``--num_hosts 2 --host_id k`` on one store, on
    ``G``, ``bp`` (the first ``L_SNPS_HOSTS`` SNPs of the N = 2048 panel);
    host k on ``cuda:k`` where this host has two cards or more, else both
    on ``cuda:0``; host 1 started first (it waits for host 0's plan). Each
    process shrinks the chunk constants (``HOSTS_CHUNKING``, ``--memory
    HOSTS_MEMORY_GB``: two chunks of 2,946 and 1,650 SNPs, one a host). The
    ``.anc``/``.mut`` must equal those of one host with the same constants,
    run first in a process of its own; host 0 finalizes and removes the
    store, host 1 does not finalize. Each process reports its chunks, its
    launches by kernel and its seconds; B1–B4 and B6 must be launched in
    each one that ran a chunk."""
    from relate_tpu_torch.utils import synth

    L, N = G.shape
    t_phase = time.time()
    second = "cuda:1" if torch.cuda.device_count() > 1 else DEV
    with tempfile.TemporaryDirectory(prefix="relate_smoke_hosts_") as tmp:
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        common = ["--mode", "All", "--haps", prefix + ".haps", "--sample",
                  prefix + ".sample", "--map", os.path.join(tmp, "map.txt"),
                  "--memory", str(HOSTS_MEMORY_GB), "--theta", str(THETA),
                  "--seed", "1"]
        one_out, two_out = os.path.join(tmp, "one"), os.path.join(tmp, "two")
        t0 = time.time()
        (one,) = host_processes(tmp, [common + ["-o", one_out, "--device",
                                                DEV]])
        one_s = time.time() - t0
        hosts = ["--num_hosts", "2", "--barrier_timeout",
                 str(HOSTS_TIMEOUT_S), "-o", two_out]
        t0 = time.time()
        h1, h0 = host_processes(tmp, [
            common + hosts + ["--host_id", "1", "--device", second],
            common + hosts + ["--host_id", "0", "--device", DEV]])
        two_s = time.time() - t0
        equal = {ext: same_bytes(one_out + ext, two_out + ext)
                 for ext in (".anc", ".mut")}
        store_left = os.path.exists(two_out + ".tmpdir")
    chunks = one["owned"]
    path_kernels = ("paint_fwd", "paint_bwd", "paint_fwd_capture",
                    "paint_bwd_capture", "merge_scan_large")
    for name, rec in (("one_host", one), ("host0", h0), ("host1", h1)):
        add_launches(kernels, f"hosts_n{N}_{name}", rec["launches"])
    emit("hosts", N=N, L=L, memory_gb=HOSTS_MEMORY_GB,
         chunk_constants=HOSTS_CHUNKING, chunks=len(chunks),
         devices={"host0": DEV, "host1": second},
         one_host=one, host0=h0, host1=h1,
         one_host_wall_s=round(one_s, 3), two_hosts_wall_s=round(two_s, 3),
         bytes_equal=equal, store_removed=not store_left,
         seconds=round(time.time() - t_phase, 1))
    if len(chunks) < 2 or chunks != list(range(len(chunks))):
        fail(f"hosts: the one-host run combined chunks {chunks}; wanted two "
             "or more")
    if h0["owned"] != chunks[0::2] or h1["owned"] != chunks[1::2]:
        fail(f"hosts: host 0 ran chunks {h0['owned']}, host 1 {h1['owned']}")
    if not (h0["finalized"] and one["finalized"]) or h1["finalized"] \
            or store_left:
        fail("hosts: host 0 must finalize and remove the store, host 1 "
             "must not finalize")
    if not all(equal.values()):
        fail(f"hosts: two hosts wrote other bytes than one: {equal}")
    idle = {name: [k for k in path_kernels if rec["launches"][k] <= 0]
            for name, rec in (("host0", h0), ("host1", h1))}
    if any(idle.values()):
        fail(f"hosts: kernels not launched in a host that ran a chunk: "
             f"{idle}")


def host_processes(tmp, argvs):
    """One ``host_worker`` process an argument list, all started together
    (in that order); waits for each within ``HOSTS_TIMEOUT_S`` and returns
    the JSON object each printed last. Stops every process it started; a
    process that fails ends the run, with the end of its output."""
    here = os.path.dirname(os.path.abspath(__file__))
    procs, logs = [], []
    try:
        for argv in argvs:
            log = tempfile.TemporaryFile("w+", dir=tmp)
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c",
                 "import chip_smoke; chip_smoke.host_worker()", *argv],
                cwd=here, stdout=log, stderr=subprocess.STDOUT))
        t_end = time.time() + HOSTS_TIMEOUT_S
        out = []
        for p, log in zip(procs, logs):
            try:
                rc = p.wait(timeout=max(1.0, t_end - time.time()))
            except subprocess.TimeoutExpired:
                rc = None
            log.seek(0)
            text = log.read()
            if rc != 0:
                fail(f"hosts: a host process ended with {rc}: "
                     f"{text[-3000:]}")
            out.append(json.loads(text.strip().splitlines()[-1]))
        return out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()


def host_worker():
    """One process of the hosts phase: the port's CLI on this process's
    arguments, with the chunk constants of ``HOSTS_CHUNKING``; prints as its
    last line one JSON object: the chunks it combined, whether it
    finalized, its launches by kernel and its wall seconds."""
    from relate_tpu_torch.io import chunking
    from relate_tpu_torch.pipeline import cli, relate
    for k, v in HOSTS_CHUNKING.items():
        setattr(chunking, k, v)
    relate.MERGE_DISCARD = HOSTS_CHUNKING["MERGE_DISCARD"]
    owned, finalized = [], []
    combine, finalize = relate.combine_sections, relate.finalize

    def combine_sections(store, c, **kw):
        owned.append(c)
        return combine(store, c, **kw)

    def finalize_once(*a, **kw):
        finalized.append(True)
        return finalize(*a, **kw)
    relate.combine_sections, relate.finalize = combine_sections, finalize_once
    reset_counts()
    t0 = time.time()
    rc = cli.main(sys.argv[1:])
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)
    print(json.dumps(dict(owned=owned, finalized=bool(finalized),
                          launches=read_counts(),
                          wall_s=round(time.time() - t0, 3))), flush=True)
    sys.exit(rc)


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def write_poplabels(path, N):
    """Two groups: the first and the second half of the N/2 diploid
    individuals."""
    with open(path, "w") as f:
        f.write("sample population group sex\n")
        for i in range(N // 2):
            g = "A" if i < N // 4 else "B"
            f.write(f"id{i} P{g} {g} NA\n")


def max_rel(got, want):
    """Largest |got - want| / want where want > 0."""
    nz = want > 0
    return float((np.abs(got - want)[nz] / want[nz]).max()) if nz.any() \
        else 0.0


def coal_stats_card_vs_cpu(what, trees, spans, epochs, group, host_twin):
    """``coalescence_stats`` of the same trees on the card, on the CPU (the
    same level-by-level code on CPU tensors) and, with ``host_twin``,
    through the plain host twin (``use_device=False``: the reference's
    recursion, tree by tree and node by node). Counts (integers times whole
    and half base pairs, exact in float64) must be equal on all of them,
    the opportunity within rtol 1e-5 of the CPU's and 1e-12 of the twin's.
    Returns the card's statistics and a record of the comparison (the
    seconds of each call, the opportunity's largest relative
    differences)."""
    from relate_tpu_torch.evaluate import coalrate
    runs = [("card", dict(device=DEV)), ("cpu", dict(device="cpu"))]
    if host_twin:
        runs.append(("host_twin", dict(use_device=False)))
    out, wall = {}, {}
    for name, kw in runs:
        t0 = time.time()
        out[name] = coalrate.coalescence_stats(trees, spans, epochs, group,
                                               **kw)
        wall[name] = round(time.time() - t0, 3)
    c_d, o_d = out["card"]
    rel = {}
    for name, rtol in (("cpu", 1e-5), ("host_twin", 1e-12)):
        if name not in out:
            continue
        c, o = out[name]
        if not np.array_equal(c_d, c):
            fail(f"coalescent_rate: {what} coalescence counts differ between"
                 f" the card and the {name} by up to {np.abs(c_d - c).max()}")
        if not np.allclose(o_d, o, rtol=rtol, atol=0.0):
            fail(f"coalescent_rate: {what} coalescence opportunity differs "
                 f"between the card and the {name} beyond rtol {rtol}")
        rel[name] = max_rel(o_d, o)
    return c_d, o_d, dict(counts_equal=True, opportunity_max_rel=rel,
                          wall_s=wall)


def check_rates_file(what, path, rates, names, rows=None):
    """The ``.coal`` at ``path`` against ``rates`` (E, G, G) from the
    statistics: its group names, its G * G rows in order, nan where the
    statistics have no opportunity and a rate within rtol 1e-5 (the
    file's six digits) elsewhere, every one finite and >= 0. ``rows``: the
    flat rows read back (None: all)."""
    E, G = rates.shape[0], rates.shape[1]
    n = 0
    with open(path) as f:
        if f.readline().split() != names or \
                len(f.readline().split()) != E:
            fail(f"coalescent_rate: {what} has other group names or epochs")
        for k, line in enumerate(f):
            n += 1
            if rows is not None and k not in rows:
                continue
            parts = line.split()
            want = rates[:, k // G, k % G]
            got = np.asarray([float(x) for x in parts[2:]])
            ok = ~np.isnan(want)
            if [int(parts[0]), int(parts[1])] != [k // G, k % G] or \
                    not np.array_equal(np.isnan(got), ~ok) or not (
                        np.isfinite(got[ok]).all() and (got[ok] >= 0).all()
                        and np.allclose(got[ok], want[ok], rtol=1e-5,
                                        atol=0)):
                fail(f"coalescent_rate: {what} row {k} holds rates that are "
                     "not finite, negative or off the statistics, or nan "
                     "where they have opportunity")
    if n != G * G:
        fail(f"coalescent_rate: {what} has {n} rows, not {G * G}")


def check_lengths(what, anc, T):
    """Every branch length of the ``.anc`` finite and >= 0, T trees."""
    if len(anc.seq) != T:
        fail(f"coalescent_rate: {what} has {len(anc.seq)} trees, not {T}")
    for mt in anc.seq:
        bl = mt.tree.branch_length
        if not (np.isfinite(bl).all() and (bl >= 0).all()
                and bl[:-1].max() > 0):
            fail(f"coalescent_rate: {what}, tree at {mt.pos}: a branch length"
                 " that is not finite or negative, or all zero")


def pair_iteration_cost(prefix, coal_path, group):
    """One pair-prior chain batch on the trees of ``prefix`` under the
    ``.pairwise.coal`` at ``coal_path`` (as ReEstimateBranchLengths sets it
    up, one chain frozen): ``PairRunner``'s CUDA graphs must give the
    chains bit for bit that ``pair_chunk`` gives issuing the same blocks
    kernel by kernel; then ms an iteration of both (CUDA events; the eager
    steps are host-bound, so this is wall time), and the kernels an
    iteration launches with the device's busy share under the graphs
    (``torch.profiler``)."""
    from relate_tpu_torch.core import mcmc
    from relate_tpu_torch.evaluate import coalrate, sampling
    from relate_tpu_torch.pipeline import scripts
    anc, recs, bp, dist = scripts._load_pair(prefix)[:4]
    _, epochs, rates = coalrate.read_coal(coal_path)
    avg_ne, r_norm, e_norm = sampling._normalized_prior(epochs,
                                                         rates[:, 0, 0])
    gr = np.where(np.isfinite(rates) & (rates > 0), rates, 0.0) * avg_ne
    trees = [mt.tree for mt in anc.seq]
    st = mcmc.chain_static(trees, dist, len(recs), avg_ne, 1.25e-8, e_norm,
                           r_norm, DEV, gr, group)
    B, M = st.parent.shape
    tie = mcmc.Draws(7, DEV).uniform(B, M, high=0.99)
    state = mcmc.device_init_state(st.parent, anc.N, tie, st.depth)[0]
    active = torch.ones(B, dtype=torch.bool, device=DEV)
    active[0] = False
    C = mcmc.PAIR_CHUNK
    graphed = mcmc.PairRunner(st, mcmc.Draws(1, DEV))(state, 3 * C + 5,
                                                      True, active)
    d = mcmc.Draws(1, DEV)
    eager = state
    for k in (C, C, C, 5):
        eager = mcmc.pair_chunk(st, eager, d.uniform(k, 3, B), True, active)
    if not all(torch.equal(a, b) for a, b in zip(graphed, eager)):
        fail("coalescent_rate: the pair prior's CUDA graphs gave other "
             "chains than its steps issued one by one")
    runner = mcmc.PairRunner(st, mcmc.Draws(2, DEV))
    n = 10 * C
    ms = time_ms(lambda: runner(state, n, True, active), 3) / n
    ms_eager = time_ms(lambda: mcmc.pair_chunk(
        st, state, d.uniform(C, 3, B), True, active), 2) / C
    prof = profiled(lambda: runner(state, n, True, active))
    return dict(chains=B, nodes=M, graphs_equal_eager=True,
                ms_an_iteration=round(ms, 4),
                ms_an_iteration_eager=round(ms_eager, 4),
                kernels_an_iteration=prof["device_kernels"] / n,
                device_busy_share=prof["device_busy_share"])


def phase_coalescent_rate(prefix, pair_prefix):
    """The CoalescentRate tool (``relate_tpu_torch.pipeline.tools_cli``) on
    the card, on ``run_all``'s output ``prefix``.anc/.mut: EstimatePopulation-
    Size with two groups (``.coal``, ``.pairwise.coal``) and with
    ``--poplabels hap`` (a rate for every haplotype pair, G = N),
    EstimatePopulationSizeEM (``EM_ITERS`` iterations), SampleBranchLengths
    (``--format timeb``, ``SBL_SAMPLES`` samples) and, on ``pair_prefix``
    (the output at N = ``N_PAIR``), ReEstimateBranchLengths under the
    pairwise-group prior of its own EstimatePopulationSize. Checks:
    ``coalescence_stats`` of the trees on the card against the CPU (counts
    equal, opportunity within rtol 1e-5; with two groups also against the
    host twin, rtol 1e-12) and against the ``.coal`` files (the hap file in
    ``HAP_ROWS_CHECKED`` rows); the haplotype pairs' statistics summed
    equal to the two groups'; every rate finite and >= 0 in each epoch with
    opportunity (and nan in none other); every sampled age and re-estimated
    branch length finite and >= 0; the ``.timeb``'s header and records
    against the ``.mut``. The pair prior's ms an iteration at both widths
    (``pair_iteration_cost``). No kernel of the port lies on this path: the
    launch counts must stay 0."""
    from relate_tpu_torch.evaluate import coalrate, sampling
    from relate_tpu_torch.io import ancmut
    from relate_tpu_torch.pipeline import scripts, tools_cli
    from relate_tpu_torch.utils.trace import STAGES

    modes = {}
    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        o = lambda name: os.path.join(tmp, name)  # noqa: E731

        def run(mode, inp, out, *args):
            t0 = time.time()
            rc = tools_cli.main(["CoalescentRate", "--mode", mode, "-i", inp,
                                 "-o", o(out), "--device", DEV, *args])
            torch.cuda.synchronize()
            modes[out] = dict(mode=mode, wall_s=round(time.time() - t0, 3))
            if rc != 0:
                fail(f"coalescent_rate: {mode} returned {rc}")

        anc, recs, bp, dist = scripts._load_pair(prefix)[:4]
        N, T = anc.N, len(anc.seq)
        pl = o("two.poplabels")
        write_poplabels(pl, N)
        reset_counts()
        del STAGES[:]
        run("EstimatePopulationSize", prefix, "eps", "--poplabels", pl)
        run("EstimatePopulationSize", prefix, "eps_hap", "--poplabels", "hap")
        hap_rec = STAGES[-1]
        run("EstimatePopulationSizeEM", prefix, "em", "--num_iter",
            str(EM_ITERS), "--poplabels", pl)
        run("SampleBranchLengths", prefix, "sbl", "--coal", o("eps.coal"),
            "--format", "timeb", "--num_samples", str(SBL_SAMPLES))
        pair_anc = ancmut.read_anc_text(pair_prefix + ".anc")
        pl_pair = o("pair.poplabels")
        write_poplabels(pl_pair, pair_anc.N)
        run("EstimatePopulationSize", pair_prefix, "eps_pair", "--poplabels",
            pl_pair)
        run("ReEstimateBranchLengths", pair_prefix, "re", "--coal",
            o("eps_pair.pairwise.coal"), "--poplabels", pl_pair)
        counts = read_counts()
        stages = list(STAGES)
        group = np.repeat((np.arange(N // 2) >= N // 4).astype(np.int64), 2)
        pair_group = np.repeat((np.arange(pair_anc.N // 2)
                                >= pair_anc.N // 4).astype(np.int64), 2)
        pair_cost = {
            f"N={N}": pair_iteration_cost(prefix, o("eps.pairwise.coal"),
                                          group),
            f"N={pair_anc.N}": pair_iteration_cost(
                pair_prefix, o("eps_pair.pairwise.coal"), pair_group)}

        # the statistics again, on the card, on the CPU and through the
        # host twin, against the files
        trees = [mt.tree for mt in anc.seq]
        spans = coalrate.tree_spans(anc, recs, dist)
        epochs = coalrate.default_epochs()
        c, opp, vs_cpu = coal_stats_card_vs_cpu("two groups", trees, spans,
                                                epochs, group, True)
        c_hap, opp_hap, vs_cpu_hap = coal_stats_card_vs_cpu(
            "haplotype pairs", trees, spans, epochs, np.arange(N), False)
        if not (np.array_equal(c_hap.sum(axis=(1, 2)), c.sum(axis=(1, 2)))
                and np.allclose(opp_hap.sum(axis=(1, 2)),
                                opp.sum(axis=(1, 2)), rtol=1e-12, atol=0)):
            fail("coalescent_rate: the haplotype pairs' statistics do not "
                 "sum to the two groups'")
        whole = coalrate.finalize_rates(c.sum(axis=(1, 2)),
                                        opp.sum(axis=(1, 2)))[:, None, None]
        check_rates_file("eps.coal", o("eps.coal"), whole, ["0"])
        check_rates_file("eps_hap.coal", o("eps_hap.coal"), whole, ["0"])
        check_rates_file("eps.pairwise.coal", o("eps.pairwise.coal"),
                         coalrate.finalize_rates(c, opp), ["A", "B"])
        rows = set(np.linspace(0, N * N - 1, HAP_ROWS_CHECKED).astype(
            int).tolist()) | {N + 1, N * N // 2 + 1}
        check_rates_file("eps_hap.pairwise.coal", o("eps_hap.pairwise.coal"),
                         coalrate.finalize_rates(c_hap, opp_hap),
                         [str(h) for h in range(N)], rows)
        hap_bytes = os.path.getsize(o("eps_hap.pairwise.coal"))
        del c_hap, opp_hap
        _, _, em = coalrate.read_coal(o("em.coal"))
        timeb = sampling.read_timeb(o("sbl.timeb"))
        em_anc = ancmut.read_anc_text(o("em.anc"))
        re_anc = ancmut.read_anc_text(o("re.anc"))
        mut_rows = ancmut.read_mut_final(prefix + ".mut")

    prof = profiled(lambda: coalrate.coalescence_stats(
        trees, spans, epochs, group, device=DEV))
    if not (np.isfinite(em[:, 0, 0]).all() and (em[:, 0, 0] >= 0).all()
            and em[:, 0, 0].max() > 0):
        fail("coalescent_rate: the EM's .coal holds rates that are not "
             "finite or negative, or all zero")
    check_lengths("the EM's .anc", em_anc, T)
    check_lengths("ReEstimateBranchLengths' .anc", re_anc, len(pair_anc.seq))
    mapped = [m for m in mut_rows if len(m["branch"]) <= 1]
    if len(timeb) != len(mapped) or [r["bp"] for r in timeb] != \
            [m["pos"] for m in mapped]:
        fail(f"coalescent_rate: .timeb has {len(timeb)} records; the .mut "
             f"has {len(mapped)} SNPs on at most one branch")
    for r in timeb:
        for k in ("anctimes", "dertimes"):
            a = r[k]
            if a.shape[0] != SBL_SAMPLES or r["N"] != N or not (
                    np.isfinite(a).all() and (a >= 0).all()
                    and (np.diff(a, axis=1) >= 0).all()):
                fail(f"coalescent_rate: .timeb record at {r['bp']}: {k} "
                     f"{a.shape} not {SBL_SAMPLES} sorted finite ages >= 0")
    if any(counts.values()):
        fail(f"coalescent_rate: kernels launched on a path without one: "
             f"{counts}")

    def notes(key):
        return [dict(stage=r["stage"], **m) for r in stages
                for m in r.get(key, [])]
    stats = [m for m in notes("coal_stats") if m["groups"] < N]
    em_iters = [r["wall_s"] for r in stages
                if r["stage"].startswith("em_iter")]
    peak = max(r.get("dev_peak_mb", 0.0) for r in stages if r is not hap_rec)
    chains = notes("mcmc")
    emit("coalescent_rate", N=N, trees=T, N_pair=pair_anc.N,
         trees_pair=len(pair_anc.seq), groups=2, epochs=len(epochs),
         modes=modes, em_iterations_s=em_iters,
         coal_stats_calls=len(stats),
         coal_stats_wall_s=[m["wall_s"] for m in stats],
         coal_stats_batches=[m["batches"] for m in stats],
         coal_stats_levels=max(m["levels"] for m in stats),
         coal_stats_profiled=prof, chains=chains,
         pair_prior_iteration=pair_cost, card_vs_cpu=vs_cpu,
         haplotype_pairs=dict(
             groups=N, coal_stats=hap_rec["coal_stats"],
             peak_device_memory_gb=round(hap_rec["dev_peak_mb"] / 1e3, 3),
             pairwise_coal_bytes=hap_bytes, rows_read_back=len(rows),
             card_vs_cpu=vs_cpu_hap),
         timeb_records=len(timeb), peak_device_memory_gb=round(
             peak / 1e3, 3), launches=counts)


def write_fasta(path, length):
    """A fasta of ``length`` random bases from ``SEED``, 60 a line."""
    rng = np.random.default_rng(SEED)
    seq = np.asarray(list("ACGT"))[rng.integers(0, 4, length)]
    with open(path, "w") as f:
        f.write(">1\n")
        for s in range(0, length, 60):
            f.write("".join(seq[s: s + 60]) + "\n")


def same_files(what, a, b, suffixes):
    for s in suffixes:
        with open(a + s, "rb") as f, open(b + s, "rb") as g:
            if f.read() != g.read():
                fail(f"selection_mutation_rate: {what}: the {s} written on "
                     "the card differs from the one written on the CPU")


def timed(fn):
    """(result, wall ms) of fn() on the card, synchronised."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.time() - t0) * 1e3


def phase_selection_mutation_rate(prefix):
    """The Selection, MutationRate and Extract tools
    (``relate_tpu_torch.pipeline.tools_cli``) on the card, on ``run_all``'s
    output ``prefix``.anc/.mut at N = 2048, with a fasta of random bases
    from ``SEED`` over the panel (its alleles are all A/T, so the contexts
    fall into 16 categories): Selection in its five modes and
    ``scripts.detect_selection``; MutationRate Avg, WithContext,
    ForCategoryForPopForChromosome (half of the individuals) and
    MutationDensity; Extract SubTreesForSubpopulation, AncMutForSubregion
    and RemoveTreesWithFewMutations; Selection again on the subregion.
    Checks: the card against the CPU (``freq_lin_arrays`` equal,
    p-values within 1e-9, the .freq/.lin/.qual/.freqdiff bytes equal, rSDS
    and mutation/opportunity within rtol 1e-12); every defined log10 p-value
    finite and <= 0 (1 where the tail is undefined), freq <= lin in every
    epoch, lin non-increasing back in time, the spread mutations summing to
    the mapped SNPs with age_end > 0, rates finite and >= 0 wherever there
    is opportunity; no kernel of the port launched. Then
    ``log_pvalue_batch`` alone on the card on the phase's tails tiled to
    ``CHROMOSOME_SNPS`` SNPs, a 1 % subset held against the CPU."""
    from relate_tpu_torch.evaluate import coalrate, mutrate, selection
    from relate_tpu_torch.io import haps as hio
    from relate_tpu_torch.pipeline import scripts, tools_cli
    from relate_tpu_torch.utils.trace import STAGES, stage

    modes = {}
    with tempfile.TemporaryDirectory(prefix="relate_smoke_sel_") as tmp:
        o = lambda name: os.path.join(tmp, name)  # noqa: E731

        def run(tool, mode, inp, out, *args, device=DEV):
            t0 = time.time()
            rc = tools_cli.main([tool, "--mode", mode, "-i", inp, "-o",
                                 o(out), "--device", device, *args])
            torch.cuda.synchronize()
            modes[out] = dict(tool=tool, mode=mode, device=device,
                              wall_s=round(time.time() - t0, 3))
            if rc != 0:
                fail(f"selection_mutation_rate: {tool} {mode} returned {rc}")

        anc, recs, bp, dist, rsid, alleles = scripts._load_pair(prefix)
        N, T, L = anc.N, len(anc.seq), len(recs)
        fasta = o("anc.fa")
        write_fasta(fasta, int(bp[-1]) + 2)
        anc_seq = hio.read_fasta(fasta)
        pl = o("two.poplabels")
        write_poplabels(pl, N)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        del STAGES[:]
        for mode in tools_cli.SELECTION_MODES:
            run("Selection", mode, prefix, f"sel_{mode}")
        t0 = time.time()
        with stage("detect_selection", verbose=False):
            scripts.detect_selection(prefix, o("ds"), device=DEV)
        modes["detect_selection"] = dict(wall_s=round(time.time() - t0, 3))
        run("MutationRate", "Avg", prefix, "mr_avg")
        run("MutationRate", "WithContext", prefix, "mr_ctx", "--ancestor",
            fasta)
        run("MutationRate", "ForCategoryForPopForChromosome", prefix,
            "mr_pop", "--ancestor", fasta, "--poplabels", pl,
            "--pop_of_interest", "A")
        run("MutationRate", "MutationDensity", prefix, "mr_den",
            "--sample_id", "5")
        run("Extract", "SubTreesForSubpopulation", prefix, "ex_sub",
            "--poplabels", pl, "--pop_of_interest", "A")
        run("Extract", "AncMutForSubregion", prefix, "ex_reg", "--first_bp",
            str(int(bp[L // 4])), "--last_bp", str(int(bp[L // 2])))
        run("Extract", "RemoveTreesWithFewMutations", prefix, "ex_few")
        run("Selection", "Selection", o("ex_reg"), "sel_reg")
        counts = read_counts()
        stages = list(STAGES)
        peak = max(r.get("dev_peak_mb", 0.0) for r in stages)
        # the same modes on the CPU: the files must hold the same bytes
        for mode, out, sfx in (("Frequency", "sel_Frequency", (".freq",
                                                                ".lin")),
                               ("Quality", "sel_Quality", (".qual",)),
                               ("FreqDiff", "sel_FreqDiff", (".freqdiff",))):
            run("Selection", mode, prefix, out + "_cpu", device="cpu")
            same_files(mode, o(out), o(out + "_cpu"), sfx)
        with open(o("sel_Selection.sele")) as f:
            sele_rows = sum(1 for _ in f) - 1
        sub = scripts._load_pair(o("ex_sub"))[0]
        reg = scripts._load_pair(o("ex_reg"))
        few = scripts._load_pair(o("ex_few"))[0]
        with open(o("sel_reg.sele")) as f:
            sele_reg_rows = sum(1 for _ in f) - 1
        bycat = np.load(o("mr_ctx_bycat.npz"))
        avg = np.load(o("mr_avg_avg.npz"))
        den = np.load(o("mr_den.density.npz"))

    epochs = coalrate.default_epochs()
    if not (sub.N == N // 2 and len(sub.seq) == T and len(reg[1]) ==
            L // 2 - L // 4 + 1 and 0 < len(few.seq) <= T):
        fail("selection_mutation_rate: an Extract output has the wrong "
             f"size: {sub.N} haplotypes, {len(reg[1])} SNPs, "
             f"{len(few.seq)} trees")
    if sele_reg_rows <= 0 or sele_reg_rows >= sele_rows:
        fail(f"selection_mutation_rate: the subregion's .sele has "
             f"{sele_reg_rows} rows, the whole {sele_rows}")

    # compute_freq_lin on both devices
    a, ms_fl = timed(lambda: selection.freq_lin_arrays(anc, recs, epochs,
                                                       DEV))
    t0 = time.time()
    a_cpu = selection.freq_lin_arrays(anc, recs, epochs, "cpu")
    ms_fl_cpu = (time.time() - t0) * 1e3
    for k in a:
        if not np.array_equal(a[k], a_cpu[k]):
            fail(f"selection_mutation_rate: compute_freq_lin's {k} differs "
                 "between the card and the CPU")
    freq, lin = a["freq"], a["lin"]
    if not ((freq <= lin).all() and (np.diff(lin, axis=1) >= 0).all()):
        fail("selection_mutation_rate: a SNP has more carriers than "
             "lineages, or lineages that grow back in time")

    # the tails: the card against the CPU on the same rows
    logF = np.zeros(N + 1)
    logF[1:] = np.cumsum(np.log(np.arange(1, N + 1)))
    k, fk, fN, live = selection.selection_tails(a)
    with stage("pvalues_card", verbose=False):
        pv, ms_pv = timed(lambda: selection.log_pvalue_batch(
            k, fk, N, fN, logF, device=DEV))
    rec_pv = STAGES.pop()["log_pvalue"][0]
    t0 = time.time()
    pv_cpu = selection.log_pvalue_batch(k, fk, N, fN, logF, device="cpu")
    ms_pv_cpu = (time.time() - t0) * 1e3
    defined = (fk >= 2) & (k != -1) & (fN < N) & (fk < k) & (fN > 0)
    pv_err = float(np.abs(pv - pv_cpu).max())
    if not pv_err <= 1e-9:
        fail(f"selection_mutation_rate: p-values differ between the card "
             f"and the CPU by {pv_err}")
    if not (np.isfinite(pv).all() and (pv[defined] <= 0).all()
            and (pv[~defined] == 1).all()):
        fail("selection_mutation_rate: a log10 p-value that is not finite, "
             "above 0, or not 1 where the tail is undefined")

    # SDS and the mutation rate on both devices
    sds_d, ms_sds = timed(lambda: selection.sds(anc, recs, bp, rsid,
                                                device=DEV))
    sds_c = selection.sds(anc, recs, bp, rsid, device="cpu")
    r_d = np.asarray([r["rSDS"] for r in sds_d if r is not None])
    r_c = np.asarray([r["rSDS"] for r in sds_c if r is not None])
    if [r is None for r in sds_d] != [r is None for r in sds_c] or \
            not np.allclose(r_d, r_c, rtol=1e-12, atol=0):
        fail("selection_mutation_rate: rSDS differs between the card and "
             "the CPU beyond rtol 1e-12")
    cats, names = mutrate.categorize_snps(
        bp, [x.split("/")[0] for x in alleles],
        [x.split("/")[1] for x in alleles], anc_seq)
    mr, mr_ms = {}, {}
    for dev in (DEV, "cpu"):
        mr[dev], mr_ms[dev] = timed(lambda: mutrate.avg_mutation_rate(
            anc, recs, dist, epochs, cats, len(names), device=dev))
    for i, what in enumerate(("mutation", "opportunity")):
        if not np.allclose(mr[DEV][i], mr["cpu"][i], rtol=1e-12, atol=0):
            fail(f"selection_mutation_rate: the {what} differs between the "
                 "card and the CPU beyond rtol 1e-12")
        if not np.allclose(bycat[what], mr["cpu"][i], rtol=1e-12, atol=0):
            fail(f"selection_mutation_rate: WithContext's {what} is off the "
                 "CPU's")
    sel = np.asarray([len(m.branch) == 1 and m.age_end > 0 for m in recs])
    mapped, mapped_cat = int(sel.sum()), int((sel & (cats >= 0)).sum())
    if not (abs(avg["mutation"].sum() - mapped) <= 1e-9 * mapped
            and abs(bycat["mutation"].sum() - mapped_cat) <= 1e-9 * mapped):
        fail(f"selection_mutation_rate: the spread mutations sum to "
             f"{avg['mutation'].sum()} and {bycat['mutation'].sum()}, not "
             f"the {mapped} mapped SNPs ({mapped_cat} with a category)")
    for what, m, opp in (("Avg", avg["mutation"], avg["opportunity"]),
                         ("WithContext", bycat["mutation"],
                          bycat["opportunity"])):
        ok = opp > 0
        r = m[ok] / opp[ok]
        if not (np.isfinite(r).all() and (r >= 0).all() and ok.any()):
            fail(f"selection_mutation_rate: {what} has rates that are not "
                 "finite or negative where there is opportunity")
    if not (np.isfinite(den["mutation"]).all() and den["mutation"].sum() > 0):
        fail("selection_mutation_rate: MutationDensity counted nothing")
    if any(counts.values()):
        fail(f"selection_mutation_rate: kernels launched on a path without "
             f"one: {counts}")

    # log_pvalue_batch alone at a chromosome's size
    n_live = int(live.sum())
    reps = -(-CHROMOSOME_SNPS // n_live)
    rows = CHROMOSOME_SNPS * (len(epochs) + 2)
    kk, ffk, ffN = (np.tile(x, reps)[:rows] for x in (k, fk, fN))
    torch.cuda.reset_peak_memory_stats()
    with stage("pvalues_chromosome", verbose=False):
        big, ms_big = timed(lambda: selection.log_pvalue_batch(
            kk, ffk, N, ffN, logF, device=DEV))
    rec_big = STAGES.pop()["log_pvalue"][0]
    peak_big = torch.cuda.max_memory_allocated() / 1e9
    pick = np.arange(0, rows, 100)
    sub_cpu = selection.log_pvalue_batch(kk[pick], ffk[pick], N, ffN[pick],
                                         logF, device="cpu")
    big_err = float(np.abs(big[pick] - sub_cpu).max())
    if not big_err <= 1e-9:
        fail(f"selection_mutation_rate: the chromosome-size tails differ "
             f"from the CPU by {big_err}")
    emit("selection_mutation_rate", N=N, trees=T, snps=L, epochs=len(epochs),
         modes=modes, usable_snps=len(a["snp"]), live_snps=n_live,
         mapped_snps=mapped,
         sele_rows=sele_rows, sele_rows_subregion=sele_reg_rows,
         categories_seen=int((bycat["mutation"].sum(axis=0) > 0).sum()),
         compute_freq_lin_ms_a_tree=dict(card=round(ms_fl / T, 3),
                                         cpu=round(ms_fl_cpu / T, 3)),
         log_pvalue_batch=dict(rows=rec_pv["rows"], chunks=rec_pv["chunks"],
                               cells=rec_pv["cells"], ms_card=round(ms_pv, 3),
                               ms_cpu=round(ms_pv_cpu, 3),
                               max_abs_diff=pv_err),
         log_pvalue_batch_chromosome=dict(
             snps=CHROMOSOME_SNPS, rows=rec_big["rows"],
             chunks=rec_big["chunks"], cells=rec_big["cells"],
             ms_card=round(ms_big, 3),
             peak_device_memory_gb=round(peak_big, 3),
             cpu_subset_rows=len(pick), cpu_subset_max_abs_diff=big_err),
         sds_ms_card=round(ms_sds, 3),
         avg_mutation_rate_ms=dict(card=round(mr_ms[DEV], 3),
                                   cpu=round(mr_ms["cpu"], 3)),
         card_vs_cpu="freq_lin equal; p-values within 1e-9; .freq .lin "
                     ".qual .freqdiff bytes equal; rSDS, mutation, "
                     "opportunity within rtol 1e-12",
         peak_device_memory_gb=round(peak / 1e3, 3), launches=counts)


# ---------------------------------------------------------------------------
# interchange: from a VCF to a tskit .trees, and the viewing tools
# ---------------------------------------------------------------------------

FLIP_SHARE = 0.10              # SNP bases of the ancestor set to the alternative
DROP_SHARE = 0.02              # ... and set to N
MASK_SHARE = 0.05              # bases of the mask set to N


def write_vcf(path, G, bp, ref_derived):
    """The panel as a phased VCF: individual i carries haplotypes 2i and
    2i + 1, chromosome 1, SNP l named snp<l>, ancestral allele A and
    derived allele T. As in a VCF against a reference genome, REF is the
    reference's base, which at the SNPs ``ref_derived`` is the derived
    allele: there REF is T, ALT is A and the genotypes count A."""
    L, N = G.shape
    H = np.where(ref_derived[:, None], 1 - G, G)
    gt = np.empty((L, 2 * N), np.uint8)
    gt[:, 0::4] = H[:, 0::2] + ord("0")
    gt[:, 1::4] = ord("|")
    gt[:, 2::4] = H[:, 1::2] + ord("0")
    gt[:, 3::4] = ord("\t")
    gt[:, -1] = ord("\n")
    with open(path, "wb") as f:
        f.write(("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                 "FILTER\tINFO\tFORMAT\t" + "\t".join(
                     f"id{i}" for i in range(N // 2)) + "\n").encode())
        for l in range(L):
            ref, alt = ("T", "A") if ref_derived[l] else ("A", "T")
            f.write(f"1\t{bp[l]}\tsnp{l}\t{ref}\t{alt}\t.\tPASS\t.\tGT\t"
                    .encode() + gt[l].tobytes())


def write_fasta_text(path, seq):
    with open(path, "w") as f:
        f.write(">1\n")
        for s in range(0, len(seq), 60):
            f.write(seq[s: s + 60] + "\n")


def interchange_fastas(tmp, bp):
    """The VCF's flips, an ancestor fasta and a mask, from SEED over the
    panel's span. At about FLIP_SHARE of the SNPs the VCF's REF is the
    derived allele, so the ancestor's base there (A) is the VCF's ALT and
    the SNP flips back; at about DROP_SHARE the ancestor has N and the SNP
    drops; elsewhere the ancestor holds random bases. Returns the paths and
    the SNPs' (flipped, dropped, masked) flags."""
    rng = np.random.default_rng(SEED + 13)
    length = int(bp[-1]) + 1000
    anc = np.asarray(list("ACGT"))[rng.integers(0, 4, length)]
    u = rng.random(len(bp))
    flip = u < FLIP_SHARE
    drop = (u >= FLIP_SHARE) & (u < FLIP_SHARE + DROP_SHARE)
    anc[bp - 1] = np.where(drop, "N", "A")
    mask = np.where(rng.random(length) < MASK_SHARE, "N", "P")
    paths = (os.path.join(tmp, "ancestor.fa"), os.path.join(tmp, "mask.fa"))
    write_fasta_text(paths[0], "".join(anc))
    write_fasta_text(paths[1], "".join(mask))
    return paths, flip, drop, mask[bp - 1] == "N"


def clade_lengths(tree):
    """{leaf set as bytes: branch length} of a tree's non-root nodes."""
    lm = tree.leaf_matrix()
    return {lm[v].tobytes(): float(tree.branch_length[v])
            for v in range(tree.num_nodes - 1)}


def phase_interchange(G, bp, memory_gb, kernels):
    """The path around ``Relate --mode All`` at N = 2048: the panel as a VCF
    (its REF the derived allele at a tenth of the SNPs) -> FileFormats
    ConvertFromVcf -> ``scripts.prepare_input_files`` (an ancestor fasta
    that flips those SNPs back and drops others, a mask, two groups of
    poplabels), which must give the panel back less the dropped and masked
    SNPs -> ``Relate --mode All`` through the port's CLI on the card
    from the prepared ``.haps.gz``/``.sample``/``.dist``/``.annot`` (the
    native ``.haps`` parser and ``.anc`` writer) -> FileFormats
    ConvertToTreeSequence -> TreeView's four modes -> Extract AncToNewick ->
    FileFormats ConvertFromNewick, and Extract ConvertNewickToTimeb;
    ``pairwise_tmrca`` and ``pearson_distance`` on the card and the CPU.
    The launch counts are set to 0 just before ``--mode All`` and read just
    after it. Every step's wall seconds go on the phase's line."""
    from relate_tpu_torch.core import tree_comparer
    from relate_tpu_torch.io import ancmut, kastore, native
    from relate_tpu_torch.io import haps as hio
    from relate_tpu_torch.pipeline import cli, scripts, tools_cli
    from relate_tpu_torch.utils import synth
    from relate_tpu_torch.utils.trace import STAGES

    L, N = G.shape
    seconds = {}

    def step(name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = round(time.time() - t0, 3)
        return out

    def tool(*argv):
        if tools_cli.main(list(argv)) != 0:
            fail(f"interchange: tools_cli {' '.join(argv[:3])} failed")

    with tempfile.TemporaryDirectory(prefix="relate_smoke_ic_") as tmp:
        def path(name):
            return os.path.join(tmp, name)

        (anc_fa, mask_fa), flip, drop, masked = interchange_fastas(tmp, bp)
        step("write_vcf", lambda: write_vcf(path("panel.vcf"), G, bp, flip))
        step("convert_from_vcf", lambda: tool(
            "FileFormats", "--mode", "ConvertFromVcf", "-i",
            path("panel.vcf"), "-o", path("vcf")))
        back = hio.read_haps(path("vcf.haps"), path("vcf.sample"))
        if not (np.array_equal(back.genotypes,
                               np.where(flip[:, None], 1 - G, G))
                and np.array_equal(back.bp, bp)
                and back.ancestral == np.where(flip, "T", "A").tolist()):
            fail("interchange: ConvertFromVcf did not give the VCF's rows")
        write_poplabels(path("panel.poplabels"), N)
        step("prepare_input_files", lambda: scripts.prepare_input_files(
            path("vcf.haps"), path("vcf.sample"), path("prep"),
            ancestor_path=anc_fa, mask_path=mask_fa,
            poplabels_path=path("panel.poplabels")))
        keep = ~drop & ~masked
        data = {}
        for name, native_ in (("native", True), ("python", False)):
            data[name] = step(f"read_haps_{name}", lambda: hio.read_haps(
                path("prep.haps.gz"), path("prep.sample"),
                use_native=native_))
        a, b = data["native"], data["python"]
        if not (np.array_equal(a.genotypes, b.genotypes)
                and np.array_equal(a.bp, b.bp) and a.rsid == b.rsid
                and a.ancestral == b.ancestral
                and a.alternative == b.alternative and a.chrom == b.chrom):
            fail("interchange: the native and the Python .haps parsers "
                 "disagree")
        # every kept SNP is back at ancestral A, the flipped ones with
        # their genotypes turned back
        kept_rsid = set(a.rsid)
        n_flipped = sum(x == "T" and r in kept_rsid
                        for x, r in zip(back.ancestral, back.rsid))
        counts_snps = dict(snps_in=L, flipped_by_fasta=int(flip.sum()),
                           dropped_by_fasta=int(drop.sum()),
                           masked=int((masked & ~drop).sum()), snps_out=a.L,
                           flipped_out=n_flipped)
        if a.L != int(keep.sum()) or n_flipped != int((flip & keep).sum()) \
                or not np.array_equal(a.bp, bp[keep]) \
                or set(a.ancestral) != {"A"} \
                or not np.array_equal(a.genotypes, G[keep]):
            fail(f"interchange: prepare_input_files kept {a.L} SNPs "
                 f"({n_flipped} flipped); the fastas keep {int(keep.sum())} "
                 f"({int((flip & keep).sum())} flipped): {counts_snps}")
        synth.write_flat_map(path("map.txt"), int(bp[-1]))

        reset_counts()
        del STAGES[:]
        out = path("out")
        step("relate_all", lambda: cli.main([
            "--mode", "All", "--haps", path("prep.haps.gz"), "--sample",
            path("prep.sample"), "--map", path("map.txt"), "--dist",
            path("prep.dist"), "--annot", path("prep.annot"), "--memory",
            str(memory_gb), "--theta", str(THETA), "--seed", "1", "-o", out,
            "--device", DEV]))
        counts = read_counts()
        add_launches(kernels, f"interchange_n{N}", counts)
        missing = [k for k in ("paint_fwd", "paint_bwd", "paint_fwd_capture",
                               "paint_bwd_capture", "merge_scan_large")
                   if counts[k] <= 0]
        if missing or counts["merge_scan"] or counts["merge_scan_inc"]:
            fail(f"interchange: --mode All launched {counts}")
        anc = ancmut.read_anc_text(out + ".anc")
        muts = ancmut.read_mut_final(out + ".mut")
        Lp = a.L
        totals, n_not_mapping = check_final_trees("interchange", anc, muts,
                                                  Lp, N)
        dist = np.diff(a.bp)
        if [m["dist"] for m in muts[:-1]] != dist.tolist() or \
                [m["pos"] for m in muts] != a.bp.tolist():
            fail("interchange: the .mut does not hold the prepared "
                 "positions and .dist")
        with open(path("prep.annot")) as f:
            annot = f.read().splitlines()
        with open(out + ".mut") as f:
            mut_lines = f.read().splitlines()
        if not mut_lines[0].endswith(annot[0]) or any(
                not m.endswith(r) for m, r in zip(mut_lines[1:], annot[1:])):
            fail("interchange: the .mut rows do not end in their annotation")

        step("write_anc_native", lambda: ancmut.write_anc_text(
            path("native.anc"), anc, use_native=True))
        step("write_anc_python", lambda: ancmut.write_anc_text(
            path("python.anc"), anc, use_native=False))
        texts = [open(p, "rb").read() for p in (
            out + ".anc", path("native.anc"), path("python.anc"))]
        if len(set(texts)) != 1:
            fail("interchange: the native and the Python .anc writers "
                 "disagree")

        step("convert_to_tree_sequence", lambda: tool(
            "FileFormats", "--mode", "ConvertToTreeSequence", "-i", out,
            "-o", path("ts")))
        ks = kastore.load(path("ts.trees"))
        T = len(anc.seq)
        nt = ks["nodes/time"]
        ep, ec = ks["edges/parent"], ks["edges/child"]
        order = np.lexsort((ks["edges/left"], ec, ep, nt[ep]))
        mapping = [m for m in muts if len(m["branch"]) == 1]
        sites = ks["sites/position"]
        if bytes(ks["format/name"]) != b"tskit.trees" or \
                ks["format/version"].tolist() != [12, 0] or \
                ks["sequence_length"][0] != float(a.bp[-1]) + 1.0:
            fail("interchange: the .trees header is wrong")
        if len(ep) != T * (2 * N - 2) or not (order == np.arange(len(ep))
                                              ).all():
            fail(f"interchange: {len(ep)} edges for {T} trees, or not in "
                 "tskit order")
        if not (nt[ep] > nt[ec]).all():
            fail("interchange: an edge's parent is not older than its child")
        if len(sites) != len(mapping) or \
                len(ks["mutations/site"]) != len(mapping) or \
                not (np.diff(sites) > 0).all() or \
                not np.array_equal(sites, [m["pos"] for m in mapping]):
            fail(f"interchange: {len(sites)} sites for {len(mapping)} "
                 "mapping SNPs, or not ascending")

        mid = str(int(a.bp[Lp // 2]))
        for mode in ("TreeView", "TreeViewSample", "MutationsOnBranches",
                     "BranchesBelowMutation"):
            step(f"tree_view_{mode}", lambda: tool(
                "TreeView", "--mode", mode, "-i", out, "-o",
                path(f"tv_{mode}"), "--bp_of_interest", mid))
        for mode in ("TreeView", "TreeViewSample"):
            with open(path(f"tv_{mode}.coords")) as f:
                rows = f.read().splitlines()
            if len(rows) != 1 + 2 * N - 1:
                fail(f"interchange: {mode} wrote {len(rows) - 1} rows")
        for mode, suffix in (("MutationsOnBranches", ".muts"),
                             ("BranchesBelowMutation", ".branches")):
            with open(path(f"tv_{mode}{suffix}")) as f:
                if len(f.read().splitlines()) < 2:
                    fail(f"interchange: {mode} wrote no row")

        step("anc_to_newick", lambda: tool(
            "Extract", "--mode", "AncToNewick", "-i", out, "-o", path("nw"),
            "--first_bp", "0", "--last_bp", str(int(a.bp[-1]))))
        with open(path("nw.newick")) as f:
            newick = f.read().splitlines()
        if len(newick) != T:
            fail(f"interchange: AncToNewick wrote {len(newick)} of {T} trees")
        with open(path("pos.newick"), "w") as f:
            for mt, line in zip(anc.seq, newick):
                f.write(f"{mt.pos} {line}\n")
        step("convert_from_newick", lambda: tool(
            "FileFormats", "--mode", "ConvertFromNewick", "-i",
            path("pos.newick"), "-o", path("imported"), "-N", "1"))
        imported = ancmut.read_anc_text(path("imported.anc"))
        t0 = time.time()
        worst = 0.0
        for mt, it in zip(anc.seq, imported.seq):
            if it.pos != mt.pos or \
                    tree_comparer.partition_metric(mt.tree, it.tree) != 0:
                fail(f"interchange: the tree at {mt.pos} did not come back "
                     "from Newick")
            x, y = clade_lengths(mt.tree), clade_lengths(it.tree)
            worst = max(worst, max(abs(x[k] - y[k]) for k in x))
        seconds["newick_checks"] = round(time.time() - t0, 3)
        if len(imported.seq) != T or worst > 5e-6:
            fail(f"interchange: Newick branch lengths off by {worst}")

        one = anc.seq[T // 2].tree
        with open(path("one.newick"), "w") as f:
            f.write((one.to_newick() + "\n") * 5)
        step("convert_newick_to_timeb", lambda: tool(
            "Extract", "--mode", "ConvertNewickToTimeb", "-i",
            path("one"), "-o", path("one")))
        head = np.fromfile(path("one.timeb"), dtype=np.int32, count=3)
        ages = np.fromfile(path("one.timeb"), dtype=np.float32, offset=12)
        # the imported tree numbers its nodes in post-order: compare the
        # ages in order
        want_ages = np.sort(one.coordinates())
        if head.tolist() != [5, 1, 2 * N - 1] or ages.size != 5 * want_ages.size \
                or np.abs(np.sort(ages[: 2 * N - 1]) - want_ages).max() > \
                1e-6 * want_ages[-1] + 1e-4:
            fail(f"interchange: .timeb header {head.tolist()}, or ages off")
        have_zlib_h = os.path.exists("/usr/include/zlib.h")
        lib = native.build()

    other = anc.seq[T // 2 + 1].tree
    tm = {d: step(f"pairwise_tmrca_{d}", lambda: tree_comparer.pairwise_tmrca(
        one, device=d)) for d in (DEV, "cpu")}
    pd = {d: step(f"pearson_distance_{d}",
                  lambda: tree_comparer.pearson_distance(one, other, device=d))
          for d in (DEV, "cpu")}
    if not np.array_equal(tm[DEV], tm["cpu"]) or pd[DEV] != pd["cpu"]:
        fail(f"interchange: pairwise_tmrca or pearson_distance differ "
             f"between the card and the CPU ({pd})")
    if tm[DEV].max() != one.coordinates()[-1]:
        fail("interchange: the oldest pairwise TMRCA is not the root's age")
    emit("interchange", N=N, L=L, snps=counts_snps, wall_s=seconds,
         total_s=round(sum(seconds.values()), 3),
         stages=[{k: r.get(k) for k in ("stage", "wall_s", "dev_peak_mb")}
                 for r in STAGES],
         launches=counts, trees=T, not_mapping=n_not_mapping,
         total_branch_length_generations=dict(
             min=min(totals), median=float(np.median(totals)),
             max=max(totals)),
         edges=int(len(ep)), sites=int(len(sites)),
         newick_branch_length_error_max=worst,
         pearson_distance=pd[DEV], native_library=os.path.basename(lib),
         zlib_h=have_zlib_h)


def check_window_mapping(phase, store, N):
    """PostProcess maps record i of window w with SNP start_w + i. Each
    record on one branch must hold its own SNP's carriers (flipped: the
    non-carriers) within the mapper's 0.03 N mismatches; the share that
    holds them exactly is reported. For windows after the first, the
    records are also held against the SNPs ``start_w`` rows earlier, the
    rows the JAX package's ``post_process_chunk`` maps them with: most
    miss."""
    from relate_tpu_torch.io import ancmut
    ch = store.load_chunk(0)
    G, bounds = ch.G, ch.windows.boundaries
    out = []
    for w in range(len(bounds) - 1):
        start = bounds[w]
        anc = ancmut.read_anc_bin(store.path("chunk_0", f"trees_{w}.anc"))
        muts = ancmut.read_mut_short(store.path("chunk_0", f"muts_{w}.mut"))
        one = [(i, m.tree, m.branch[0], m.flipped)
               for i, m in enumerate(muts) if len(m.branch) == 1]
        if len(muts) != (bounds[w + 1] if w + 2 < len(bounds)
                         else ch.L) - start or not one:
            fail(f"{phase}: window {w} has {len(muts)} records, "
                 f"{len(one)} on one branch")
        rec = np.array(one, dtype=np.int64)
        mism = np.empty(len(rec), dtype=np.int64)
        early = np.empty(len(rec), dtype=np.int64)
        for t in np.unique(rec[:, 1]):
            k = np.nonzero(rec[:, 1] == t)[0]
            leaves = anc.seq[t].tree.leaf_matrix()[rec[k, 2]].astype(bool)
            flip = rec[k, 3].astype(bool)[:, None]
            own = (G[start + rec[k, 0]] == 1) ^ flip
            mism[k] = (leaves != own).sum(axis=1)
            then = (G[rec[k, 0]] == 1) ^ flip
            early[k] = (leaves != then).sum(axis=1)
        row = dict(window=w, start=int(start), records=len(muts),
                   one_branch=len(rec), exact=int((mism == 0).sum()),
                   max_mismatches=int(mism.max()))
        if w > 0:
            row["beyond_against_rows_start_earlier"] = int(
                (early > 0.03 * N).sum())
        out.append(row)
        if row["max_mismatches"] > 0.03 * N:
            fail(f"{phase}: window {w}: a record on one branch misses its "
                 f"own SNP by {row['max_mismatches']} haplotypes")
    return out


def post_process_stats(phase, stages):
    """PostProcess's record, summed over the windows: trees, rearranged
    nodes, sweeps, nodes visited, node batches, fallback node evaluations,
    uploaded rows, and the host ms a tree of
    the product, of the node loop and of the remapping."""
    recs = [m for r in stages for m in r.get("postprocess", [])]
    if not recs:
        fail(f"{phase}: PostProcess left no record")
    tot = {k: sum(r[k] for r in recs) for k in recs[0]}
    trees = max(tot["trees"], 1)
    if tot["nodes_rearranged"] <= 0:
        fail(f"{phase}: PostProcess rearranged no node")
    return dict(
        windows=len(recs), **{k: int(tot[k]) for k in (
            "trees", "nodes_rearranged", "sweeps", "nodes_visited",
            "batches", "fallback_nodes", "uploaded_rows")},
        product_ms_per_tree=round(tot["product_s"] * 1e3 / trees, 3),
        loop_ms_per_tree=round(tot["loop_s"] * 1e3 / trees, 3),
        remap_ms_per_tree=round(tot["remap_s"] * 1e3 / trees, 3))


def phase_optimize(G, bp, memory_gb, kernels):
    """OptimizeParameters at N = 1024 on a MakeChunks store of the panel: a
    2 x 2 grid (theta 1e-3, 1e-2; rho 1, 10) over the first 151 SNPs of
    section 0. The launch counts are set to 0 just before and read just
    after: each grid point runs the stepping stones (B3, B4) and the repaint
    (B1, B2), and every SNP with carriers and non-carriers one tree build
    (B5). (The CLI's mode runs at its default of 2001 SNPs in
    ``cpu_vs_card``, at N = 64: here it would take about a minute.)"""
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth

    L, N = G.shape
    thetas, rhos, max_snps = [1e-3, 1e-2], [1.0, 10.0], OPT_MAX_SNPS
    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        out = os.path.join(tmp, "store")
        relate.make_chunks(prefix + ".haps", prefix + ".sample",
                           os.path.join(tmp, "map.txt"), out,
                           memory_gb=memory_gb, device=DEV)
        store = ArtifactStore(out)
        ch = store.load_chunk(0)
        W = ch.windows.num_windows
        end = min(ch.windows.boundaries[1] - 1, L - 1, max_snps)
        daf = ch.G[:end + 1].sum(axis=1)
        builds = int(((daf > 0) & (daf < N)).sum())
        reset_counts()
        t0 = time.time()
        rows = relate.optimize_parameters(store, 0, thetas=thetas,
                                          rho_scales=rhos, max_snps=max_snps,
                                          seed=1, device=DEV)
        torch.cuda.synchronize()
        seconds = time.time() - t0
        counts = read_counts()
    add_launches(kernels, f"optimize_n{N}", counts)
    emit("optimize", N=N, L=L, windows=W, section_snps=end + 1,
         tree_builds_per_grid_point=builds,
         rows=[dict(theta=t, rho=r, not_mapping_share=v) for t, r, v in rows],
         seconds=round(seconds, 3), seconds_per_grid_point=round(
             seconds / len(rows), 3), launches=counts)
    n = len(rows)
    want = dict(paint_fwd=n, paint_bwd=n, paint_fwd_capture=n * (W - 1),
                paint_bwd_capture=n * (W - 1), merge_scan=n * builds,
                merge_scan_large=0, merge_scan_inc=0)
    if counts != want:
        fail(f"optimize: launches {counts}; wanted {want}")
    if [(t, r) for t, r, _ in rows] != [(t, r) for t in thetas for r in rhos] \
            or not all(0.0 <= v <= 1.0 for _, _, v in rows):
        fail(f"optimize: rows {rows}")


def phase_anc_unknown(G, bp, memory_gb, kernels):
    """MakeChunks -> Paint -> BuildTopology --anc_allele_unknown at N = 1024
    through the stage modes of ``pipeline/cli.py``, with every launch count
    set to 0 just before and read just after: the host topology builder,
    whose every tree build launches the merge scan with clade rows."""
    from relate_tpu_torch.io import ancmut
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import cli
    from relate_tpu_torch.utils import synth
    from relate_tpu_torch.utils.trace import STAGES

    L, N = G.shape
    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        prefix = os.path.join(tmp, "panel")
        synth.write_haps_sample(G, bp, prefix)
        synth.write_flat_map(os.path.join(tmp, "map.txt"), int(bp[-1]))
        out = os.path.join(tmp, "store")
        common = ["-o", out, "--device", DEV]
        reset_counts()
        del STAGES[:]
        for argv in (["--mode", "MakeChunks", "--haps", prefix + ".haps",
                      "--sample", prefix + ".sample", "--map",
                      os.path.join(tmp, "map.txt"), "--memory",
                      str(memory_gb)],
                     ["--mode", "Paint"],
                     ["--mode", "BuildTopology", "--anc_allele_unknown"]):
            if cli.main(argv + common) != 0:
                fail(f"anc_unknown: {' '.join(argv[:2])} failed")
        torch.cuda.synchronize()
        counts = read_counts()
        peak = max(r.get("dev_peak_mb", 0.0) for r in STAGES) * 1e6
        store = ArtifactStore(out)
        ch = store.load_chunk(0)
        bounds = ch.windows.boundaries
        W = len(bounds) - 1
        if ch.N != N or W < 3:
            fail(f"anc_unknown: N = {ch.N}, W = {W}; wanted N = {N}, W >= 3")
        sections, flipped = [], 0
        for w in range(W):
            end = (bounds[w + 1] - 1) if w < W - 1 else ch.L - 1
            sections.append(check_section(store, w, N, end - bounds[w] + 1))
            flipped += sum(m.flipped for m in ancmut.read_mut_short(
                store.path("chunk_0", f"muts_{w}.mut")))
    tree_builds = sum(m["tree_builds"] for r in STAGES
                      for m in r.get("topology", []))
    trees = sum(x["trees"] for x in sections)
    add_launches(kernels, f"anc_unknown_n{N}", counts)
    needed = ("paint_fwd", "paint_bwd", "paint_fwd_capture",
              "paint_bwd_capture", "merge_scan")
    missing = [n for n in needed if counts[n] <= 0]
    emit("anc_unknown", N=N, L=L, windows=W,
         boundaries=[int(b) for b in bounds], memory_gb=memory_gb,
         stages=[{k: r.get(k) for k in ("stage", "wall_s", "cpu_s",
                                         "dev_peak_mb")}
                 for r in STAGES],
         launches=counts, trees=trees, tree_builds=tree_builds,
         sections=sections, flipped=flipped,
         peak_device_memory_gb=round(peak / 1e9, 3))
    if missing:
        fail(f"anc_unknown: kernels never launched: {missing}")
    if counts["merge_scan"] != tree_builds or tree_builds < trees \
            or counts["merge_scan_large"] or counts["merge_scan_inc"]:
        fail(f"anc_unknown: {counts['merge_scan']} merge scans for "
             f"{tree_builds} tree builds and {trees} trees")
    if flipped == 0:
        fail("anc_unknown: no SNP was mapped flipped")


def profiled(fn, named=()):
    """Run ``fn`` under ``torch.profiler``: wall seconds, the device's busy
    seconds and share, the kernels that take most of the device time, and
    the device ms and calls of the kernels whose names hold one of the
    strings ``named``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.time() - t0
    dev_us = lambda e: getattr(e, "self_device_time_total",  # noqa: E731
                               getattr(e, "self_cuda_time_total", 0))
    # Device-side events only (kernels and copies). A PyTorch operator's row
    # carries the time of the kernels it launched as well, so counting both
    # would count that time twice; the runtime's "... Loading" rows are
    # one-off module loads, not work of the card.
    evs = [e for e in prof.key_averages()
           if dev_us(e) > 0 and e.device_type == DeviceType.CUDA
           and not e.key.endswith("Loading")]
    busy = sum(dev_us(e) for e in evs) / 1e6
    top = sorted(evs, key=dev_us, reverse=True)[:8]
    out = dict(
        wall_s_profiled=round(wall, 3), device_busy_s=round(busy, 4),
        device_busy_share=round(busy / wall, 4),
        device_kernels=int(sum(e.count for e in evs)),
        top=[[e.key[:60], round(dev_us(e) / 1e3, 3), e.count] for e in top])
    if named:
        out["named"] = [[e.key[:60], round(dev_us(e) / 1e3, 3), e.count]
                        for e in evs if any(n in e.key for n in named)]
    return out


@contextlib.contextmanager
def host_timers(targets):
    """While active, every call of each ``(owner, attribute)`` in ``targets``
    is counted and timed on the host clock, ended by a device
    synchronisation. Yields {"Owner.attribute": [seconds, calls]}; calls
    made inside another timed call count in both."""
    acc, saved = {}, []
    for owner, attr in targets:
        fn = getattr(owner, attr)
        rec = acc.setdefault(f"{owner.__name__}.{attr}", [0.0, 0])

        def timed(*a, _fn=fn, _rec=rec, **k):
            t0 = time.time()
            try:
                return _fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                _rec[0] += time.time() - t0
                _rec[1] += 1
        saved.append((owner, attr, fn))
        setattr(owner, attr, timed)
    try:
        yield acc
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def paint_split(store):
    """Paint of one chunk (``relate.paint``) on the host clock, with the
    time of the stepping-stone sweeps (``Painter.paint_stepping_stones`` and
    the planner calls inside it) and of the checkpoint writes
    (``np.savez_compressed``); then the same call under ``torch.profiler``
    for the device time of the capture sweeps."""
    from relate_tpu_torch.core import painting
    from relate_tpu_torch.pipeline import relate
    P = painting.Painter
    with host_timers([(P, "paint_stepping_stones"),
                      (P, "window_boundary_sites"), (P, "_prep"),
                      (P, "_rows_of_sites"), (P, "_extended_final_raw"),
                      (np, "savez_compressed")]) as acc:
        torch.cuda.synchronize()
        t0 = time.time()
        relate.paint(store, 0, theta=THETA, device=DEV)
        torch.cuda.synchronize()
        wall = time.time() - t0
    timers = {k: {"s": round(v[0], 3), "calls": v[1]} for k, v in acc.items()}
    stones = acc["Painter.paint_stepping_stones"][0]
    writes = acc["numpy.savez_compressed"][0]
    prof = profiled(lambda: relate.paint(store, 0, theta=THETA, device=DEV),
                    named=("capture_kernel",))
    return dict(wall_s=round(wall, 3), host_timers=timers,
                stepping_stones_share=round(stones / wall, 4),
                checkpoint_writes_share=round(writes / wall, 4),
                rest_s=round(wall - stones - writes, 3), profiled=prof)


def phase_profile(panels):
    """Optional (``--phases profile``): Paint and one section of
    BuildTopology at N = 1024, and one section of BuildTopology,
    FindEquivalentBranches and InferBranchLengths of the chunk at N = 2048,
    under ``torch.profiler``; and Paint at N = 4096 split on the host clock
    into the stepping-stone sweeps and the checkpoint writes, with the
    capture sweeps' device time (``paint_split``)."""
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import relate
    from relate_tpu_torch.utils import synth
    from relate_tpu_torch.utils.trace import STAGES, stage

    rows = {}
    with tempfile.TemporaryDirectory(prefix="relate_smoke_") as tmp:
        stores = {}
        for N in (N_HAP, N_LARGE, N_INC):
            G, bp, memory_gb = panels[N]
            prefix = os.path.join(tmp, f"panel{N}")
            synth.write_haps_sample(G, bp, prefix)
            synth.write_flat_map(prefix + ".map", int(bp[-1]))
            out = os.path.join(tmp, f"store{N}")
            relate.make_chunks(prefix + ".haps", prefix + ".sample",
                               prefix + ".map", out, memory_gb=memory_gb,
                               device=DEV)
            stores[N] = ArtifactStore(out)
        small, large = stores[N_HAP], stores[N_LARGE]
        rows["Paint[N=1024]"] = profiled(
            lambda: relate.paint(small, 0, theta=THETA, device=DEV))
        rows["BuildTopology[1][N=1024]"] = profiled(
            lambda: relate.build_topology(small, 0, seed=1, theta=THETA,
                                          first_section=1, last_section=1,
                                          device=DEV))
        relate.paint(large, 0, theta=THETA, device=DEV)
        relate.build_topology(large, 0, seed=1, theta=THETA, first_section=0,
                              last_section=0, device=DEV)
        rows["BuildTopology[1][N=2048]"] = profiled(
            lambda: relate.build_topology(large, 0, seed=1, theta=THETA,
                                          first_section=1, last_section=1,
                                          device=DEV))
        relate.build_topology(large, 0, seed=1, theta=THETA, first_section=2,
                              device=DEV)
        rows["FindEquivalentBranches[N=2048]"] = profiled(
            lambda: relate.find_equivalent_branches(large, 0, device=DEV))
        def infer():
            with stage("infer_branch_lengths", verbose=False):
                relate.infer_branch_lengths(large, 0, seed=1, device=DEV)
        rows["InferBranchLengths[N=2048]"] = profiled(infer)
        rows["InferBranchLengths[N=2048]"]["mcmc"] = STAGES[-1]["mcmc"]
        rows["Paint[N=4096]"] = paint_split(stores[N_INC])
    emit("profile", note="wall time includes the profiler's overhead; "
         "top = [kernel, device ms, calls]", **rows)


def coal_rate_on_both(tmp, prefix, N):
    """EstimatePopulationSize (two groups) and CoalRateForTree through the
    CLI on the card and on the CPU, from the same ``prefix``.anc/.mut: the
    ``.coal`` and ``.pairwise.coal`` bytes and the per-tree counts must be
    equal; the per-tree opportunity (float64, summed in another order on the
    card) within rtol 1e-9."""
    from relate_tpu_torch.pipeline import tools_cli
    pl = os.path.join(tmp, "two.poplabels")
    write_poplabels(pl, N)
    got = {}
    for dev in (DEV, "cpu"):
        o = os.path.join(tmp, "coal_" + dev)
        for mode, extra in (("EstimatePopulationSize", ["--poplabels", pl]),
                            ("CoalRateForTree", [])):
            if tools_cli.main(["CoalescentRate", "--mode", mode, "-i", prefix,
                               "-o", o, "--device", dev] + extra) != 0:
                fail(f"cpu_vs_card: {mode} failed on {dev}")
        texts = []
        for ext in (".coal", ".pairwise.coal"):
            with open(o + ext) as f:
                texts.append(f.read())
        with np.load(o + ".rates.npz") as z:
            got[dev] = (texts, {k: z[k] for k in z.files})
    (tc, zc), (th, zh) = got[DEV], got["cpu"]
    if tc != th:
        fail("cpu_vs_card: EstimatePopulationSize wrote other .coal bytes on "
             "the card than on the CPU")
    if not (np.array_equal(zc["counts"], zh["counts"])
            and np.array_equal(zc["epochs"], zh["epochs"])
            and np.allclose(zc["opportunity"], zh["opportunity"], rtol=1e-9,
                            atol=0.0)):
        fail("cpu_vs_card: CoalRateForTree's counts or opportunity differ "
             "between the card and the CPU")
    nz = zh["opportunity"] > 0
    return dict(coal_bytes_equal=True, rate_for_tree_counts_equal=True,
                trees=int(zh["counts"].shape[0]),
                rate_for_tree_opportunity_max_rel=float(
                    (np.abs(zc["opportunity"] - zh["opportunity"])[nz]
                     / zh["opportunity"][nz]).max()))


def phase_cpu_vs_card():
    """All seven stages at N = 64 on the card (kernels) and on the CPU
    (plain versions) from the same files, through the entry points that
    ``run_all`` calls, stage by stage so that what each stage wrote can be
    held against the other device's; then the first section again through
    the host topology builder, with an unknown ancestral allele and (in a
    store of its own) with 16 ancient haplotypes; then PostProcess of the
    CPU's first section after FindEquivalentBranches (with the SNPs' own
    positions, and with them spread 400 times wider, where nodes without
    exact support within 10 Mb take the approximate fallback) and
    OptimizeParameters (2 x 2 grid, 101 SNPs; and the CLI's
    ``--mode OptimizeParameters`` at its default on the card against the
    function on the CPU) on both devices from the same files, which must
    give equal trees, records, rows and bytes (integer counts and one tie
    hash on both)."""
    from relate_tpu_torch.io import ancmut
    from relate_tpu_torch.io.chunking import ArtifactStore
    from relate_tpu_torch.pipeline import cli, postprocess, relate
    from relate_tpu_torch.utils import synth, trace

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

            def section_bytes():
                got = []
                for w in range(W):
                    with open(store.path("chunk_0", f"trees_{w}.anc"),
                              "rb") as f:
                        got.append(f.read())
                return got
            trees = [len(ancmut.read_anc_bin(
                store.path("chunk_0", f"trees_{w}.anc")).seq)
                for w in range(W)]
            built = section_bytes()
            relate.find_equivalent_branches(store, 0, device=dev)
            matched = section_bytes()
            if dev == "cpu":
                pp_in = [store.path("chunk_0", f)
                         for f in ("trees_0.anc", "muts_0.mut")]
                for f in pp_in:
                    shutil.copy(f, f + ".feb")
            relate.infer_branch_lengths(store, 0, seed=1, device=dev)
            relate.combine_sections(store, 0)
            final = os.path.join(tmp, "final_" + dev)
            relate.finalize(store, final)
            totals = [float(mt.tree.branch_length.sum())
                      for mt in ancmut.read_anc_text(final + ".anc").seq]

            def host_section_trees(st):
                return len(ancmut.read_anc_bin(
                    st.path("chunk_0", "trees_0.anc")).seq)
            relate.build_topology(store, 0, seed=1, theta=THETA,
                                  ancestral_state=False, first_section=0,
                                  last_section=0, device=dev)
            host = [host_section_trees(store)]
            ages_path = os.path.join(tmp, "ages.txt")
            np.savetxt(ages_path, ancient_ages(N, 16))
            sa = os.path.join(tmp, "store_ages_" + dev)
            relate.make_chunks(prefix + ".haps", prefix + ".sample",
                               os.path.join(tmp, "map.txt"), sa,
                               memory_gb=0.0008, sample_ages_path=ages_path,
                               device=dev)
            ages_store = ArtifactStore(sa)
            relate.paint(ages_store, 0, theta=THETA, device=dev)
            relate.build_topology(ages_store, 0, seed=1, theta=THETA,
                                  first_section=0, last_section=0,
                                  device=dev)
            host.append(host_section_trees(ages_store))
            out[dev] = (W, [{k: z[k] for k in z.files} for z in cps], trees,
                        built, matched, totals, host)
        pp, opt = {}, {}
        cpu_store = ArtifactStore(os.path.join(tmp, "store_cpu"))
        ch = cpu_store.load_chunk(0)
        for dev in (DEV, "cpu"):
            for spread in (1, 400):
                anc = ancmut.read_anc_bin(pp_in[0] + ".feb")
                muts = ancmut.read_mut_short(pp_in[1] + ".feb")
                with trace.stage("post_process", verbose=False):
                    n = postprocess.post_process(anc, muts, ch.G,
                                                 ch.bp * spread, seed=1,
                                                 device=dev)
                (stats,) = trace.STAGES[-1]["postprocess"]
                pp[dev, spread] = (n, stats["fallback_nodes"], [
                    (mt.pos,) + tuple(getattr(mt.tree, f).tobytes() for f in (
                        "parent", "child_left", "child_right",
                        "branch_length", "num_events", "SNP_begin",
                        "SNP_end"))
                    for mt in anc.seq],
                    [(m.tree, m.branch, m.flipped, m.age_begin, m.age_end)
                     for m in muts])
            opt[dev] = relate.optimize_parameters(
                cpu_store, 0, thetas=[1e-3, 1e-2], rho_scales=[1.0, 10.0],
                max_snps=100, seed=1, device=dev)
        grid = os.path.join(tmp, "grid.txt")
        with open(grid, "w") as f:
            f.write("0.01\n10\n")
        if cli.main(["--mode", "OptimizeParameters", "--input", grid, "-o",
                     os.path.join(tmp, "opt"), "--store", cpu_store.outdir,
                     "--seed", "1", "--device", DEV]) != 0:
            fail("cpu_vs_card: the CLI's OptimizeParameters failed")
        relate.write_opt(os.path.join(tmp, "want.opt"),
                         relate.optimize_parameters(
                             cpu_store, 0, thetas=[0.01], rho_scales=[10.0],
                             seed=1, device="cpu"))
        with open(os.path.join(tmp, "opt.opt")) as f:
            cli_opt = f.read()
        with open(os.path.join(tmp, "want.opt")) as f:
            want_opt = f.read()
        coal = coal_rate_on_both(tmp, os.path.join(tmp, "final_cpu"), N)
    for spread in (1, 400):
        (nc, fc, *card), (nh, fh, *host) = pp[DEV, spread], pp["cpu", spread]
        if nc != nh or nc <= 0:
            fail(f"cpu_vs_card: PostProcess (spread {spread}) rearranged {nc} "
                 f"nodes on the card, {nh} on the CPU")
        if fc != fh or (fc > 0) != (spread > 1):
            fail(f"cpu_vs_card: PostProcess (spread {spread}) took the "
                 f"fallback {fc} times on the card, {fh} on the CPU")
        if card != host:
            fail(f"cpu_vs_card: PostProcess (spread {spread}) wrote other "
                 "trees or records on the card than on the CPU")
    if opt[DEV] != opt["cpu"]:
        fail(f"cpu_vs_card: OptimizeParameters gave {opt[DEV]} on the card, "
             f"{opt['cpu']} on the CPU")
    if cli_opt != want_opt:
        fail(f"cpu_vs_card: the CLI wrote {cli_opt!r} on the card, the "
             f"function gives {want_opt!r} on the CPU")
    (Wc, cps_c, trees_c, built_c, matched_c, tot_c, host_c) = out[DEV]
    (Wh, cps_h, trees_h, built_h, matched_h, tot_h, host_h) = out["cpu"]
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
    # float32 sums are taken in another order on the card, and a merge list
    # is discrete, so one rebuild may be accepted on one device and reverted
    # on the other; more than a few is a fault
    for what, a, b in (("", trees_c, trees_h),
                       (" (host builder: unknown ancestral allele, ages)",
                        host_c, host_h)):
        if a != b:
            gap = max(abs(x - y) for x, y in zip(a, b))
            if gap > max(3, 0.05 * max(b)):
                fail(f"cpu_vs_card: tree counts{what} {a} on the card, "
                     f"{b} on the CPU")
    if trees_c != trees_h:
        note = ("differ within the accept/revert noise of summation order "
                "(float32 posterior rows feed a discrete merge list)")
    # the matcher is deterministic and integer-valued: where BuildTopology
    # wrote the same bytes on both devices, so must FindEquivalentBranches
    same_built = built_c == built_h
    if same_built and matched_c != matched_h:
        bad = [w for w in range(Wc) if matched_c[w] != matched_h[w]]
        fail("cpu_vs_card: FindEquivalentBranches wrote other bytes on the "
             f"card than on the CPU in sections {bad}")
    # Branch lengths are posterior means over a finite chain, and the two
    # devices draw other random numbers: tree by tree the total length
    # agrees within the chain's noise. The tolerance is 25 % for the median
    # tree and 100 % for the worst: a tree's total is dominated by its few
    # oldest branches, whose running means are the noisiest, and the worst
    # tree's difference is heavy-tailed (on the CPU, seed against seed, 5 to
    # 13 % for the median tree and 35 to 49 % for the worst of 16 trees of
    # 12 leaves). A fault in an acceptance ratio moves every total.
    length = {}
    if len(tot_c) == len(tot_h):
        rel = np.abs(np.array(tot_c) - np.array(tot_h)) / np.array(tot_h)
        length = dict(median_rel=float(np.median(rel)),
                      max_rel=float(rel.max()))
        if not (length["median_rel"] <= 0.25 and length["max_rel"] <= 1.0):
            fail(f"cpu_vs_card: total branch lengths differ: {length}")
    else:
        rel = abs(np.mean(tot_c) - np.mean(tot_h)) / np.mean(tot_h)
        length = dict(mean_rel=float(rel))
        if not rel <= 0.25:
            fail(f"cpu_vs_card: mean total branch length differs by {rel}")
    emit("cpu_vs_card", N=N, L=int(G.shape[0]), windows=Wc,
         coalescent_rate=coal,
         checkpoint_max_abs_err_normalised=worst, trees_card=trees_c,
         trees_cpu=trees_h, tree_counts=note,
         host_builder_trees_card=host_c, host_builder_trees_cpu=host_h,
         build_topology_bytes_equal=same_built,
         find_equivalent_branches_bytes_equal=matched_c == matched_h,
         total_branch_length=length,
         post_process_rearranged=pp[DEV, 1][0],
         post_process_trees=len(pp[DEV, 1][2]),
         post_process_wide_rearranged=pp[DEV, 400][0],
         post_process_wide_fallback_nodes=pp[DEV, 400][1],
         post_process_equal=True, optimize_rows=opt[DEV],
         optimize_equal=True, optimize_cli_opt=cli_opt.strip(),
         optimize_cli_equal=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases",
                    default="kernels,main_path,golden,run_all,"
                            "coalescent_rate,"
                            "selection_mutation_rate,mesh,hosts,interchange,"
                            "run_all_n4096,"
                            "run_all_ancient,anc_unknown,"
                            "run_all_postprocess,optimize,cpu_vs_card")
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card "
             "and does not fall back to the CPU")
    import relate_tpu_torch  # noqa: F401 - fail before any output without it
    smi_line = phase_device()
    phase_build()
    from relate_tpu_torch.io.chunking import plan_chunks_and_windows
    from relate_tpu_torch.utils.devmem import auto_memory_gb
    # each panel gets the budget the card's memory gives; if it then has
    # fewer than 3 windows, a smaller budget is passed so that both capture
    # kernels have work (a middle window has a forward and a backward
    # checkpoint) and FindEquivalentBranches crosses a window boundary
    memory_auto = auto_memory_gb()
    panels = {}
    uses_panels = {"kernels", "main_path", "run_all", "run_all_n4096",
                   "run_all_ancient", "anc_unknown", "run_all_postprocess",
                   "optimize", "profile", "coalescent_rate",
                   "selection_mutation_rate", "interchange", "mesh",
                   "hosts", "dealing"}
    for N in (N_HAP, N_LARGE, N_INC) if phases & uses_panels else ():
        G, bp = make_panel(N, L_SNPS_INC if N == N_INC else L_SNPS)
        memory_gb = memory_auto
        if len(plan_chunks_and_windows(G, memory_gb)[1][0].boundaries) - 1 < 3:
            memory_gb = SMALLER_MEMORY_GB
        panels[N] = (G, bp, memory_gb)
    emit("inputs", L={N: int(p[0].shape[0]) for N, p in panels.items()},
         seed=SEED,
         memory_gb_from_card=round(memory_auto, 3),
         memory_gb={N: p[2] for N, p in panels.items()})
    kernels = []
    if "inc_edges" in phases:
        phase_inc_edges()
    if "dense_edges" in phases:
        phase_dense_edges()
    if "sweep_edges" in phases:
        phase_sweep_edges()
    if "kernels" in phases:
        kernels = phase_kernels(panels)
        torch.cuda.empty_cache()
    if "main_path" in phases:
        phase_main_path(*panels[N_HAP], kernels)
    if "golden" in phases:
        phase_golden(kernels)
        torch.cuda.empty_cache()
    # run_all's N = 2048 output is the input of the coalescent_rate and
    # selection_mutation_rate phases
    hand = tempfile.TemporaryDirectory(prefix="relate_smoke_coal_")
    handed = os.path.join(hand.name, f"run_all_n{N_LARGE}")
    if phases & {"run_all", "coalescent_rate", "selection_mutation_rate",
                  "mesh", "dealing"}:
        one_card = phase_run_all(*panels[N_LARGE], kernels, "run_all",
                                 "merge_scan_large", hand_over=handed)
        torch.cuda.empty_cache()
    if "coalescent_rate" in phases:
        pair = os.path.join(hand.name, f"run_all_n{N_PAIR}")
        phase_run_all(*make_panel(N_PAIR, L_SNPS_PAIR), PAIR_MEMORY_GB,
                      kernels, f"run_all_n{N_PAIR}", "merge_scan",
                      hand_over=pair)
        phase_coalescent_rate(handed, pair)
        torch.cuda.empty_cache()
    if "selection_mutation_rate" in phases:
        phase_selection_mutation_rate(handed)
        torch.cuda.empty_cache()
    if "mesh" in phases:
        phase_mesh(*panels[N_HAP], *panels[N_LARGE], one_card, handed,
                   kernels)
        torch.cuda.empty_cache()
    if "dealing" in phases:
        phase_dealing(handed)
    hand.cleanup()
    if "hosts" in phases:
        G, bp = panels[N_LARGE][:2]
        phase_hosts(G[:L_SNPS_HOSTS], bp[:L_SNPS_HOSTS], kernels)
    if "interchange" in phases:
        G, bp, memory_gb = panels[N_LARGE]
        phase_interchange(G[:L_SNPS_INTERCHANGE], bp[:L_SNPS_INTERCHANGE],
                          memory_gb, kernels)
        torch.cuda.empty_cache()
    if "run_all_n4096" in phases:
        G, bp, memory_gb = panels[N_INC]
        phase_run_all(G[:L_SNPS_RUN_ALL_INC], bp[:L_SNPS_RUN_ALL_INC],
                      memory_gb, kernels, "run_all_n4096", "merge_scan_inc")
        torch.cuda.empty_cache()
    if "run_all_ancient" in phases:
        G, bp = panels[N_HAP][:2]
        phase_run_all(G[:L_SNPS_ANCIENT], bp[:L_SNPS_ANCIENT],
                      ANCIENT_MEMORY_GB, kernels, "run_all_ancient", None,
                      ages=ancient_ages(N_HAP))
        torch.cuda.empty_cache()
    if "anc_unknown" in phases:
        G, bp = panels[N_HAP][:2]
        phase_anc_unknown(G[:L_SNPS_ANC_UNKNOWN], bp[:L_SNPS_ANC_UNKNOWN],
                          ANC_UNKNOWN_MEMORY_GB, kernels)
        torch.cuda.empty_cache()
    if "run_all_postprocess" in phases:
        G, bp, memory_gb = panels[N_LARGE]
        phase_run_all(G[:L_SNPS_POSTPROCESS], bp[:L_SNPS_POSTPROCESS],
                      memory_gb, kernels, "run_all_postprocess",
                      "merge_scan_large", postprocess=True)
        torch.cuda.empty_cache()
    if "optimize" in phases:
        phase_optimize(*panels[N_HAP], kernels)
        torch.cuda.empty_cache()
    if "cpu_vs_card" in phases:
        phase_cpu_vs_card()
    if "profile" in phases:
        phase_profile(panels)
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
