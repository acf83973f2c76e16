"""Seconds of the program's ``chunk<c>.find_equivalent_branches`` records
per thousand SNPs."""
from benchmark.layers import stage_s_per_ksnp


def read(ctx):
    return stage_s_per_ksnp(ctx, "find_equivalent_branches")
