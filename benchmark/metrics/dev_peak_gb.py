"""The largest peak of device memory of any stage record of the window
(every card of a mesh, the pool workers' included), in GB."""


def read(ctx):
    return ctx["peak_mb"] / 1e3 if ctx["peak_mb"] > 0 else None
