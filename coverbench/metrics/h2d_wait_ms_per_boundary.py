"""Host time a boundary blocked in host-to-device copies under
`engine.step_async` (the program's counter `h2d_wait_s`: the host clock
around each copy, which waits for its stream), over the window's
boundaries of a traced run."""

from coverbench.metrics._spans import counter


def read(ctx):
    wait = counter(ctx, "engine.step_async", "h2d_wait_s")
    return None if wait is None else 1e3 * wait
