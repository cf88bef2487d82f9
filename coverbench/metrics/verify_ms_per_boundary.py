"""Device time a boundary of the verifier: the profiled sub-window's
device events launched inside the program's spans `step.verifier_towers`
(the SigLIP2 image and text towers) and `step.verifier_heads` (the
ensemble's heads over every candidate's trajectory)."""

from coverbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "step.verifier_towers", "step.verifier_heads")
