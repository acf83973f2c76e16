"""Shared arithmetic of the per-layer readers in ``metrics/``.

``ctx["jobs"]`` holds the traced window's jobs that the profiler did not
cover, each with its SNPs, wall seconds and the program's stage records
(``relate_tpu_torch.utils.trace.STAGES``: ``chunk<c>.<stage>`` and
``finalize``). ``ctx["profile"]`` is ``devtrace.summarize`` of the
profiled job.
"""
from __future__ import annotations


def stage_s_per_ksnp(ctx, *suffixes):
    """Seconds of the stage records whose names end in one of ``suffixes``,
    summed over the jobs, per thousand SNPs; None without a job."""
    jobs = ctx["jobs"]
    snps = sum(j["snps"] for j in jobs)
    if not snps:
        return None
    s = sum(r["wall_s"] for j in jobs for r in j["stages"]
            if r["stage"].split(".", 1)[-1] in suffixes)
    return s / snps * 1e3


def kernel_s(ctx, pattern):
    """(device seconds, launches) of the profiled job's kernels whose names
    hold ``pattern``."""
    p = ctx.get("profile")
    if not p:
        return 0.0, 0
    s = sum(v for k, v in p["by_name"].items() if pattern in k)
    n = sum(v for k, v in p["count"].items() if pattern in k)
    return s, n


def idle_share(ctx, card):
    p = ctx.get("profile")
    if not p or p["wall_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy"].get(card, 0.0) / p["wall_s"])
