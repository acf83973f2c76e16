"""Decides ``correct``: the outputs of the timed jobs against the plain
reference (``reference.py``), once the window has closed.

Every job of the window: its ``.anc``/``.mut`` are there, with one row a
SNP. ``MAP_JOBS`` of them, drawn from the seed: every tree's structure and
every SNP's branch, flags and ages against the tree (``map_check``), the
SNPs kept on a tree where a rebuild was due (``reverts_per_ksnp``), and the
mutations the branch lengths predict against the SNPs (``clock_gap``,
the absolute log of their ratio). One of
them, drawn from the seed: the first tree and ``TREES - 1`` more, drawn
from the seed, replayed merge by merge on the reference's distance matrix
at the SNP where the tree was built (``merge_regret``). A tree after the
first is either the first of its section (a plain matrix, no prior) or a
rebuild (the carrier penalty of its SNP and the prior of the tree before
it); the reference does not know the program's sections and takes the
reading that fits better.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import reference as ref


def _rows(path: str) -> int:
    with open(path, "rb") as f:
        return sum(1 for _ in f) - 1


def memory_budget(memory_gb, device) -> float:
    """The window budget of a job: the traffic's, or Relate's default on
    the card, a twentieth of its memory within [0.25, 5] GB."""
    if memory_gb is not None:
        return float(memory_gb)
    total = torch.cuda.mem_get_info(device)[1]
    return max(0.25, min(5.0, total / 1e9 / 20.0))


TREES = 6        # trees of one job replayed merge by merge
MAP_JOBS = 2     # jobs whose every tree and SNP are held against the rules
CONTROL = torch.bfloat16
NO_CLOCK = 1e9   # clock_gap where the lengths predict no finite mutations


def check_jobs(jobs, traffic, cfg: dict, seed: int, device,
               control: bool = False, replay: bool = True) -> dict:
    """``jobs``: [{"index", "out", "ok"}] of the window. Returns the numbers
    compared (and, with ``control``, the control's reading). ``replay``
    False leaves the merge replay out (``trees_replayed`` stays 0)."""
    rng = np.random.default_rng(seed % (1 << 63) + 104729)
    theta = float(cfg["theta"])
    out = dict(jobs_failed=0, tree_faults=0, snp_faults=0,
               merge_regret=0.0, trees_replayed=0, merges_replayed=0,
               reverts_per_ksnp=0.0, clock_gap=NO_CLOCK,
               detail=[], seconds={})
    t0 = time.time()
    done = []
    for j in jobs:
        anc, mut = j["out"] + ".anc", j["out"] + ".mut"
        if not j["ok"] or not (os.path.exists(anc) and os.path.exists(mut)):
            out["jobs_failed"] += 1
            continue
        G, _ = traffic.inputs(j["index"])
        if _rows(mut) != G.shape[0]:
            out["snp_faults"] += abs(_rows(mut) - G.shape[0])
            out["detail"].append(f"job {j['index']}: {_rows(mut)} SNP rows")
            continue
        done.append(j)
    if not done:
        return out
    picks = rng.choice(len(done), size=min(MAP_JOBS, len(done)),
                       replace=False)
    parsed = {}
    kept, mapped, pred, snps = 0, 0, 0.0, 0
    for p in picks:
        j = done[int(p)]
        G, bp = traffic.inputs(j["index"])
        anc = ref.read_anc(j["out"] + ".anc")
        mut = ref.read_mut(j["out"] + ".mut")
        parsed[int(p)] = anc
        tf, sf, kp, det = ref.map_check(G, bp, anc, mut, device)
        out["tree_faults"] += tf
        out["snp_faults"] += sf
        out["detail"] += [f"job {j['index']}: {d}" for d in det]
        kept += kp
        mapped += G.shape[0]
        pr, n = ref.clock(anc[1], bp, float(cfg["mu"]))
        pred += pr
        snps += n
    out["reverts_per_ksnp"] = 1e3 * kept / mapped
    if pred > 0 and np.isfinite(pred):
        out["clock_ratio"] = pred / snps
        out["clock_gap"] = abs(float(np.log(pred / snps)))
    out["seconds"]["map"] = time.time() - t0
    t0 = time.time()
    p = int(picks[0])
    j = done[p]
    G, bp = traffic.inputs(j["index"])
    N, tlist = parsed[p]
    if out["tree_faults"] or not replay:
        return out
    chosen = [0] + sorted(rng.choice(np.arange(1, len(tlist)),
                                     size=min(TREES - 1, len(tlist) - 1),
                                     replace=False).tolist())
    qs = [tlist[t][0] for t in chosen]
    rpos, r = ref.recombination(bp, float(cfg["cm_per_mb"]))
    bounds = ref.window_bounds(G, memory_budget(traffic.memory_gb, device))
    out["windows"] = len(bounds) - 1
    paint = ref.Painting(G, r, theta, qs, bounds, torch.float64, device)
    low = ref.Painting(G, r, theta, qs, bounds, CONTROL, device) \
        if control else None
    out["seconds"]["paint"] = time.time() - t0
    t0 = time.time()
    worst, worst_ctl = 0.0, 0.0
    for t in chosen:
        q = tlist[t][0]
        steps = ref.merges_of(tlist[t][1], N)
        d = ref.distance_matrix(paint, rpos, q)
        dl = ref.distance_matrix(low, rpos, q) if control else None
        hyps = [(d, dl, torch.zeros_like(d, dtype=torch.float32), False)]
        if t > 0:
            prior = ref.clade_prior(tlist[t - 1][1], N, theta, d.device)
            hyps.insert(0, (ref.carrier_penalty(d, G[q], theta),
                            ref.carrier_penalty(dl, G[q], theta)
                            if control else None, prior, True))
        best = None
        for dd, ddl, prior, use_cf in hyps:
            reg, reg_ctl = ref.merge_regret(dd, steps, prior, use_cf, theta,
                                            control=ddl)
            if best is None or reg < best[0]:
                best = (reg, reg_ctl)
            if reg == 0.0:
                break           # no reading can be better
        worst = max(worst, best[0])
        if control:
            worst_ctl = max(worst_ctl, best[1])
        out["trees_replayed"] += 1
        out["merges_replayed"] += len(steps)
    out["seconds"]["replay"] = time.time() - t0
    out["merge_regret"] = worst
    if control:
        out["control_regret"] = worst_ctl
    return out
