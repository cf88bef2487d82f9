"""A hand kernel's share of its roofline over the profiled sub-window: the
least time the card could take for the work the kernel's launches there
had to do (the larger of bytes over the HBM peak and FLOPs over the bf16
peak, from the cell's shapes), over the kernel's time in the trace. Where
the tracer lost some launches, the work is that of the launches it kept.
A kernel that the cell's backbone does not run, or that the trace does
not show, reads nothing."""

from coverbench import yardstick


def roofline(ctx, kernel: str):
    t, work = ctx["trace"], ctx.get("kernel_work")
    if not t or not work:
        return None
    seen, mine = t["by_category"].get(kernel), work.get(kernel)
    if not seen or not seen["launches"] or not mine or not mine[2]:
        return None
    nbytes, flops, launches = mine
    flops_peak = yardstick.PEAK_FLOPS.get(ctx["device_name"])
    hbm = yardstick.PEAK_HBM_BYTES.get(ctx["device_name"])
    if flops_peak is None or hbm is None:
        return None
    kept = min(seen["launches"], launches) / launches
    bound_s = max(nbytes / hbm, flops / flops_peak) * kept
    return 100.0 * bound_s / (seen["us"] / 1e6)
