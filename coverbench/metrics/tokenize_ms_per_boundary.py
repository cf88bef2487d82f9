"""Host time a boundary in the engine's tokenizing (the program's span
`engine.tokenize`, host clock), over the window's boundaries of a traced
run (recorded, not profiled)."""

from coverbench.metrics._spans import window_trees


def read(ctx):
    found = window_trees(ctx, "engine.step_async")
    if found is None:
        return None
    records, roots = found
    spans = [r for r in records if r.name == "engine.tokenize"]
    if not spans:
        return None
    return 1e3 * sum(r.t1 - r.t0 for r in spans) / roots
