"""Seconds of the program's ``chunk<c>.paint`` records per thousand SNPs."""
from benchmark.layers import stage_s_per_ksnp


def read(ctx):
    return stage_s_per_ksnp(ctx, "paint")
