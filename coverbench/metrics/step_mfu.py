"""The whole step's share of the card's peak: the model FLOPs of a chunk
boundary (the yardstick's `analytic_flops`) times the boundaries the
window resolved, over the window's seconds, over the configuration's peak
(bf16 for a bf16 configuration, int8 for a w8a8 one), in percent."""

from coverbench import yardstick


def read(ctx):
    cfg = ctx["config"]
    if ctx["device_name"] not in yardstick.PEAK_FLOPS:
        return None
    flops = yardstick.analytic_flops(cfg, ctx["K"], ctx["N"], ctx["E"])
    rate = len(ctx["window"]) / ctx["window_s"]
    return 100.0 * flops * rate / cfg["peak_flops"]
