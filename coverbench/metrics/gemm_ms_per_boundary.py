"""Device time of the GEMM categories (bf16, fp32, int8) a boundary."""

from coverbench.yardstick import GEMM_CATEGORIES


def read(ctx):
    t = ctx["trace"]
    if not t:
        return None
    us = sum(t["by_category"].get(c, {}).get("us", 0.0)
             for c in GEMM_CATEGORIES)
    return us / 1e3 / t["boundaries"]
