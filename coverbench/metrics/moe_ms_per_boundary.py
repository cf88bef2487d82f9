"""Device time a boundary of the backbone's mixture-of-experts
feed-forwards (router, dispatch, the routed experts' grouped products,
the weighted combine and the shared experts): the profiled sub-window's
device events launched inside the program's span `moe.block`, inside
`pi0.prefix`. Device time goes to the innermost span, so in a cell that
reads this `prefix_ms_per_boundary` is the prefix outside the MoE."""

from coverbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "moe.block")
