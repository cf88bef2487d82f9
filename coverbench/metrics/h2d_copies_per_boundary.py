"""Host-to-device copies a boundary made under `engine.step_async` (the
program's counter `h2d_copies`, `monitor.to_device`), over the window's
boundaries of a traced run."""

from coverbench.metrics._spans import counter


def read(ctx):
    return counter(ctx, "engine.step_async", "h2d_copies")
