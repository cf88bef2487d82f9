"""The 90th percentile, over the window's boundaries, of the time from
`step_async` at a boundary to its resolver's return (the queue behind the
other cohort included)."""

import numpy as np


def read(ctx):
    lat = [b.t_resolved - b.t_enqueue[0] for b in ctx["window"]]
    return 1e3 * float(np.percentile(lat, 90)) if lat else None
