"""The program's spans and counters (`cover_vla_tpu_torch.utils.monitor`)
as a traced run records them: over the profiled sub-window and the window,
in `ctx["spans"]`, and the sub-window's device time by innermost span, in
`ctx["trace"]["by_span"]`. An untraced run records nothing, and its
readers read nothing."""


def device_ms(ctx, *names):
    """Device ms a boundary of the sub-window's launches made inside the
    spans `names` (innermost on the launching thread); None where the
    trace holds none of them."""
    t = ctx.get("trace")
    rows = [t["by_span"][n] for n in names
            if t and n in t.get("by_span", {})]
    return sum(r["ms_per_step"] for r in rows) if rows else None


def window_trees(ctx, root: str):
    """The records of every span tree rooted at a `root` span that opened
    inside the window, and the number of such roots: (records, roots);
    None where the run recorded none."""
    spans = ctx.get("spans")
    if not spans:
        return None
    by_sid = {r.sid: r for r in spans}

    def root_of(r):
        while r.parent is not None and r.parent in by_sid:
            r = by_sid[r.parent]
        return r

    roots = {r.sid for r in spans if r.parent is None and r.name == root
             and ctx["opened"] <= r.t0 <= ctx["closed"]}
    if not roots:
        return None
    return [r for r in spans if root_of(r).sid in roots], len(roots)


def counter(ctx, root: str, key: str):
    """A counter summed over the window's `root` trees, a boundary."""
    found = window_trees(ctx, root)
    if found is None:
        return None
    records, roots = found
    return sum(r.counts.get(key, 0) for r in records) / roots
