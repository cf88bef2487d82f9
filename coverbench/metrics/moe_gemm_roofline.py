"""The routed experts' grouped products' share of their roofline (the
backbone's `MOE` kernel, see _roofline.py)."""

from coverbench.metrics._roofline import roofline


def read(ctx):
    return roofline(ctx, "MOE")
