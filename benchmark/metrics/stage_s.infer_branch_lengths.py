"""Seconds of the program's ``chunk<c>.infer_branch_lengths`` records per thousand SNPs."""
from benchmark.layers import stage_s_per_ksnp


def read(ctx):
    return stage_s_per_ksnp(ctx, "infer_branch_lengths")
