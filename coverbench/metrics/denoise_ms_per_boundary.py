"""Device time a boundary of the policy's Euler steps (the action expert
over every candidate): the profiled sub-window's device events launched
inside the program's span `pi0.denoise`."""

from coverbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "pi0.denoise")
