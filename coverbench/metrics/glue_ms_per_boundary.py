"""Device time of the glue a boundary: elementwise, copies and memsets,
reductions, softmax and norms, indexing."""

from coverbench.yardstick import GLUE_CATEGORIES


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    us = sum(t["by_category"].get(c, {}).get("us", 0.0)
             for c in GLUE_CATEGORIES)
    return us / 1e3 / t["boundaries"]
