"""Device events (kernels, copies, memsets) of the profiled sub-window over
its boundaries."""


def read(ctx):
    t = ctx["trace"]
    return t["launches"] / t["boundaries"] if t else None
