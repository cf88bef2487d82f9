"""Reads one torch.profiler chrome trace of the profiled sub-window into
what the per-layer metrics need: device busy time (the union of device
events over every stream), device time and launches by category, the hand
kernels' time and launches, and the breakdown (device operations that
took most time, idle gaps by what the host was doing)."""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

from coverbench import yardstick

def _device_events(trace: dict) -> list:
    dev = [e for e in trace.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("dur")
           and e.get("cat") in yardstick.DEVICE_EVENT_CATS]
    if not dev:
        raise RuntimeError("the trace holds no device event: the profiler "
                           "did not trace the card")
    return dev


def _intervals(dev) -> list:
    return sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                  for e in dev)


def summarize(trace: dict, window_s: float, boundaries: int) -> dict:
    """`trace`: the profiled sub-window's chrome trace (device events, and
    the host's operators, joined to their kernels through `External
    id`)."""
    dev = _device_events(trace)
    ops = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") != "cpu_op" or e.get("ph") != "X":
            continue
        x = e.get("args", {}).get("External id")
        if x is not None and (x not in ops or e["ts"] >= ops[x]["ts"]):
            ops[x] = e          # the innermost operator of an id
    by_cat = defaultdict(lambda: {"us": 0.0, "launches": 0})
    by_name = defaultdict(float)
    for e in dev:
        x = e.get("args", {}).get("External id")
        cat = yardstick.category(e, ops.get(x) if x else None)
        by_cat[cat]["us"] += float(e["dur"])
        by_cat[cat]["launches"] += 1
        by_name[_short(e.get("name", ""))] += float(e["dur"]) / 1e6
    busy_us = yardstick.merged_len(_intervals(dev))
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    cpu_ops = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    return {"window_s": window_s, "busy_s": busy_us / 1e6,
            "boundaries": boundaries, "launches": len(dev),
            "by_category": dict(by_cat),
            "device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": _idle_gaps(_intervals(dev), cpu_ops)}


def _short(name: str) -> str:
    out = "".join(c if c.isalnum() or c in "_:" else "_" for c in name)
    return out[:64]


def _idle_gaps(intervals, cpu_ops) -> list:
    """Gaps between merged device intervals, summed by the innermost CPU
    operator running when each gap began ("no_operator" when none)."""
    merged = []
    for s, e in intervals:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    ops = sorted((float(o["ts"]), float(o["ts"]) + float(o.get("dur", 0)),
                  o.get("name", "")) for o in cpu_ops)
    starts = [o[0] for o in ops]
    by_op = defaultdict(float)
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        gap = nxt - end
        if gap <= 0:
            continue
        i = bisect.bisect_right(starts, end)
        name = "no_operator"
        # the latest-starting operator that covers the gap's start
        for s, e, n in reversed(ops[max(0, i - 64):i]):
            if e >= end:
                name = n
                break
        by_op[name] += gap / 1e6
    return [[n, s] for n, s in sorted(by_op.items(), key=lambda kv: -kv[1])
            [:10]]


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
