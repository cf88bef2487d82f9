"""Device time a boundary of the policy's prefix (the vision tower, the
prompt embeddings and the backbone's prefill): the profiled sub-window's
device events launched inside the program's span `pi0.prefix`."""

from coverbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "pi0.prefix")
