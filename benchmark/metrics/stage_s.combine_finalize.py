"""Seconds of ``chunk<c>.combine_sections`` and ``finalize`` per thousand
SNPs."""
from benchmark.layers import stage_s_per_ksnp


def read(ctx):
    return stage_s_per_ksnp(ctx, "combine_sections", "finalize")
