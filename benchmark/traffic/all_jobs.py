"""The ``all_jobs`` traffic: ``Relate --mode All`` jobs, back to back.

One client runs one job after the other (a closed loop): each job is one
``run_all`` call on a region of ``job_snps`` SNPs of the configuration's
chromosome, in a fresh directory, with the program's defaults but for the
parameters the configuration states (``Ne``, ``mu``, ``theta``) and, where
the mix names cards, a mesh of that many. Set-up writes ``regions``
distinct regions, the chromosome's first ``regions * job_snps`` SNPs cut
in turn. The chromosome is the configuration's (``panel_seed``), so that
every run has the same work; the run's seed draws the order in which the
jobs take the regions (a window that needs more jobs than regions takes
them again in that order) and the seed each job gives ``run_all``. The
warm-up job runs the first ``warmup_snps`` SNPs once.

``check`` decides ``correct`` for these jobs (``benchmark/check.py``
against the plain reference, with the configuration's ``limits``); a
traffic of another kind brings its own.

The parameters come from the traffic's data file; nothing here is
particular to one cell.
"""
from __future__ import annotations

import os

import numpy as np

from .. import check as bench_check
from .. import panel


class Traffic:
    def __init__(self, cfg: dict, params: dict, seed: int, workdir: str):
        self.cfg = cfg
        self.params = params
        self.job_snps = int(params["job_snps"])
        self.regions = int(params["regions"])
        self.memory_gb = params.get("memory_gb")
        N = int(cfg["haplotypes"])
        L = self.regions * self.job_snps
        if L > int(cfg["chromosome_snps"]):
            raise ValueError(f"{L} SNPs asked of a chromosome of "
                             f"{cfg['chromosome_snps']}")
        spacing = panel.watterson_spacing_bp(N, cfg["Ne"], cfg["mu"])
        self.G, self.bp = panel.coalescent_panel(
            N, L, int(cfg["panel_seed"]), spacing, int(cfg["block"]),
            int(cfg["nni_per_block"]))
        self.seed = seed
        self.order = np.random.default_rng(seed % (1 << 63)).permutation(
            self.regions)
        self.workdir = workdir
        self.files = []
        for r in range(self.regions):
            sl = slice(r * self.job_snps, (r + 1) * self.job_snps)
            self.files.append(panel.write_region(
                os.path.join(workdir, f"region{r}"), self.G[sl], self.bp[sl],
                cfg["cm_per_mb"]))
        w = int(params["warmup_snps"])
        self.warm_files = panel.write_region(
            os.path.join(workdir, "warm"), self.G[:w], self.bp[:w],
            cfg["cm_per_mb"])

    def region(self, job: int) -> int:
        return int(self.order[job % self.regions])

    def inputs(self, job: int):
        """(G (job_snps, N), bp) of the job's region."""
        r = self.region(job)
        sl = slice(r * self.job_snps, (r + 1) * self.job_snps)
        return self.G[sl], self.bp[sl]

    def job_seed(self, job: int) -> int:
        return (self.seed + 7919 * (job + 1)) % (1 << 31)

    def run(self, relate, job: int, out: str, device=None, mesh=None):
        """One job; ``job`` -1 is the warm-up. Returns the SNPs it carried."""
        files = self.warm_files if job < 0 else self.files[self.region(job)]
        relate.run_all(files["haps"], files["sample"], files["map"], out,
                       Ne=float(self.cfg["Ne"]), mu=float(self.cfg["mu"]),
                       theta=float(self.cfg["theta"]),
                       seed=self.job_seed(job), memory_gb=self.memory_gb,
                       verbose=False, device=device, mesh=mesh)
        return int(self.params["warmup_snps"]) if job < 0 else self.job_snps

    def check(self, jobs, device, control: bool = False,
              replay: bool = True) -> dict:
        """The window's jobs against the plain reference: {"checks": {name:
        {"value", "limit"}}, "correct", "notes"} (and "control_regret" with
        ``control``). ``replay`` False leaves the merge replay out, and the
        run is then not correct."""
        chk = bench_check.check_jobs(jobs, self, self.cfg, self.seed, device,
                                     control=control, replay=replay)
        limits = self.cfg["limits"]
        checks = dict(
            jobs_failed=dict(value=chk["jobs_failed"], limit=0),
            tree_faults=dict(value=chk["tree_faults"], limit=0),
            snp_faults=dict(value=chk["snp_faults"], limit=0),
            reverts_per_ksnp=dict(value=chk["reverts_per_ksnp"],
                                  limit=limits["reverts_per_ksnp"]),
            clock_gap=dict(value=chk["clock_gap"],
                           limit=limits["clock_gap"]),
            merge_regret=dict(value=chk["merge_regret"],
                              limit=limits["merge_regret"]))
        correct = (all(c["value"] <= c["limit"] for c in checks.values())
                   and chk["trees_replayed"] > 0)
        notes = chk["detail"][:8] + [
            f"{chk['trees_replayed']} trees of a job of "
            f"{chk.get('windows', 0)} windows, {chk['merges_replayed']} "
            f"merges replayed; predicted over observed mutations "
            f"{chk.get('clock_ratio')}; "
            + ", ".join(f"{k} {v:.1f} s" for k, v in chk["seconds"].items())]
        res = dict(checks=checks, correct=bool(correct), notes=notes)
        if control:
            res["control_regret"] = chk["control_regret"]
        return res
