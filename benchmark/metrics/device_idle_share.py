"""Share of the profiled job's wall time in which the card ran no kernel,
copy or set (1 - the union of its intervals / wall), in %."""
from benchmark.layers import idle_share


def read(ctx):
    return idle_share(ctx, 0)
