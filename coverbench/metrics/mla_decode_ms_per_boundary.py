"""Device time a boundary of the action expert's latent attention
(absorbed queries, scores over the shared latent prefix and the own
suffix, the joint softmax, the latent output and its up projection): the
profiled sub-window's device events launched inside the program's span
`mla.decode`, inside `pi0.denoise`. Device time goes to the innermost
span, so in a cell that reads this `denoise_ms_per_boundary` is the
denoise outside the attention core."""

from coverbench.metrics._spans import device_ms


def read(ctx):
    return device_ms(ctx, "mla.decode")
