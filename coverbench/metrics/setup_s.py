"""Seconds from the start of the run's process to the window's opening:
imports, loading (or building) the kernels, the weights made from the
seed, the w8a8 quantization, the warm boundaries."""


def read(ctx):
    return ctx["setup_s"]
