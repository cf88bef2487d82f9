"""The untraced window's idle share, estimated: 1 - (device busy time a
boundary in the profiled sub-window) x (boundaries the window resolved) /
(the window's seconds), in percent. The sub-window's own idle share is
not a metric: tracing the host's operators slows the host some 3x, so it
measures the profiler; the device's work a boundary is the same in both."""


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    busy = t["busy_s"] / t["boundaries"] * len(ctx["window"])
    return 100.0 * (1.0 - busy / ctx["window_s"])
