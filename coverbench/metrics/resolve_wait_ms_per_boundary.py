"""Host time a boundary blocked in the resolver's device-to-host copies
(the program's counter `d2h_wait_s` under `engine.resolve`: the host clock
around each copy, which waits for the boundary's device work), over the
window's boundaries of a traced run."""

from coverbench.metrics._spans import counter


def read(ctx):
    wait = counter(ctx, "engine.resolve", "d2h_wait_s")
    return None if wait is None else 1e3 * wait
