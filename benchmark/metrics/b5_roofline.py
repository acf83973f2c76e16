"""B5 (the merge scan with clade rows): its least time at the panel's N
times its launches, over its device time in the profiled job, in %."""
from benchmark import roofline
from benchmark.layers import kernel_s


def read(ctx):
    s, n = kernel_s(ctx, "merge_scan_coop_kernel<true")
    if not n or s <= 0:
        return None
    return 100.0 * n * roofline.merge_scan_b5(int(ctx["cfg"]["haplotypes"])) / s
