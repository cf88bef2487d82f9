"""Host time inside `step_async` at a chunk boundary (tokenizing, the
history ring, enqueueing the verified step), over the window's untraced
boundaries: the total divided by their count."""


def read(ctx):
    times = [b.t_enqueue[1] - b.t_enqueue[0] for b in ctx["window"]]
    return 1e3 * sum(times) / len(times) if times else None
