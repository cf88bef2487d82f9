"""K3's share of its roofline (see _roofline.py)."""

from coverbench.metrics._roofline import roofline


def read(ctx):
    return roofline(ctx, "K3")
