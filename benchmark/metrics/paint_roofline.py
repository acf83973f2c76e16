"""The paint sweeps B1-B4 of the profiled job: the sum of their least times
(from each launch's own shapes and steps) over the sum of their device
times, in %."""
from benchmark.devtrace import KERNEL_OF_SWEEP
from benchmark.layers import kernel_s


def read(ctx):
    bounds = ctx.get("sweep_bounds") or []
    if not bounds:
        return None
    dev = sum(kernel_s(ctx, k)[0] for k in KERNEL_OF_SWEEP.values())
    if dev <= 0:
        return None
    return 100.0 * sum(b for _, b in bounds) / dev
