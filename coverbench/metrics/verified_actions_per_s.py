"""Executed verified actions of all episodes over the window's time: every
resolved chunk boundary in the window yields E x chunk actions; the window
opens and closes on a resolved boundary."""


def read(ctx):
    return len(ctx["window"]) * ctx["E"] * ctx["chunk"] / ctx["window_s"]
