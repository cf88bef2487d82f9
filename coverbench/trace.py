"""Reads one torch.profiler chrome trace of the profiled sub-window into
what the per-layer metrics need: device busy time (the union of device
events over every stream), device time and launches by category, the hand
kernels' time and launches, device time and idle time by the program's
innermost span (`by_span`, a frozen copy of `scripts/torch_roofline.py`'s
`by_span` at commit d002048), and the breakdown (device operations that
took most time, idle gaps by what the host was doing, and both by span)."""

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


def _operators(events) -> dict:
    """{External id: the innermost CPU operator of the id (the latest to
    start)}."""
    ops = {}
    for e in events:
        x = e.get("args", {}).get("External id")
        if e.get("cat") == "cpu_op" and x is not None:
            if x not in ops or e["ts"] >= ops[x]["ts"]:
                ops[x] = e
    return ops


def summarize(trace: dict, window_s: float, boundaries: int,
              kernels: dict) -> dict:
    """`trace`: the profiled sub-window's chrome trace (device events, and
    the host's operators, joined to their kernels through `External
    id`); `kernels`: the backbone's hand kernels (`yardstick.category`)."""
    dev = _device_events(trace)
    ops = _operators(trace.get("traceEvents", []))
    by_cat = defaultdict(lambda: {"us": 0.0, "launches": 0})
    by_name = defaultdict(float)
    for e in dev:
        x = e.get("args", {}).get("External id")
        cat = yardstick.category(e, ops.get(x) if x else None, kernels)
        by_cat[cat]["us"] += float(e["dur"])
        by_cat[cat]["launches"] += 1
        by_name[_short(e.get("name", ""))] += float(e["dur"]) / 1e6
    busy_us = yardstick.merged_len(_intervals(dev))
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    cpu_ops = [e for e in trace.get("traceEvents", [])
               if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    spans = by_span(trace, boundaries, kernels)
    secs = {key: sorted(([r["span"], r[key] * boundaries / 1e3]
                         for r in spans), key=lambda x: -x[1])[:10]
            for key in ("ms_per_step", "idle_ms_per_step")}
    return {"window_s": window_s, "busy_s": busy_us / 1e6,
            "boundaries": boundaries, "launches": len(dev),
            "by_category": dict(by_cat),
            "by_span": {r["span"]: r for r in spans},
            "device_ops": [[n, s] for n, s in device_ops],
            "idle_gaps": _idle_gaps(_intervals(dev), cpu_ops),
            "device_by_span": secs["ms_per_step"],
            "idle_gaps_by_span": secs["idle_ms_per_step"]}


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


NO_SPAN = "no_span"


class _Spans:
    """Spans ((start, end, name)) for the innermost one open at a time."""

    def __init__(self, spans):
        # of two spans that start together, the outer first
        self.spans = sorted(spans, key=lambda x: (x[0], -x[1]))
        self.starts = [x[0] for x in self.spans]

    def innermost(self, ts: float) -> str:
        """The latest-starting span that covers `ts`, else "no_span"."""
        for i in range(bisect.bisect_right(self.starts, ts) - 1, -1, -1):
            if self.spans[i][1] >= ts:
                return self.spans[i][2]
        return NO_SPAN


def by_span(trace: dict, steps: int, kernels: dict) -> list:
    """Device time a step by the innermost program span of its launch, by
    category, and the device's idle time a step by the innermost span open
    when each gap began: [{"span", "ms_per_step", "launches_per_step",
    "idle_ms_per_step", "categories": {category: ms a step}}], most device
    time first; [] when the trace holds no span."""
    events = trace.get("traceEvents", [])
    by_tid, launches = {}, {}
    for e in events:
        if e.get("ph") != "X":
            continue
        args = e.get("args", {})
        if e.get("cat") == "user_annotation":
            if e["name"].startswith("ProfilerStep#"):
                continue            # the profiler's schedule, no span
            ts = float(e["ts"])
            by_tid.setdefault(e.get("tid"), []).append(
                (ts, ts + float(e.get("dur", 0)), e["name"]))
        elif e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in args:
            launches[args["correlation"]] = e
    if not by_tid:
        return []
    ops = _operators(events)
    every = _Spans([x for spans in by_tid.values() for x in spans])
    by_tid = {t: _Spans(spans) for t, spans in by_tid.items()}
    rows = {}

    def row(name):
        return rows.setdefault(name, {"us": 0.0, "launches": 0,
                                      "idle_us": 0.0, "categories": {}})

    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in yardstick.DEVICE_EVENT_CATS and e.get("dur")]
    for e in dev:
        args = e.get("args", {})
        op = ops.get(args.get("External id"))
        host = op or launches.get(args.get("correlation"))
        spans = by_tid.get(host.get("tid")) if host is not None else None
        name = (spans.innermost(float(host["ts"])) if spans is not None
                else NO_SPAN)
        r, dur = row(name), float(e["dur"])
        cat = yardstick.category(e, op, kernels)
        r["us"] += dur
        r["launches"] += 1
        r["categories"][cat] = r["categories"].get(cat, 0.0) + dur
    merged = []
    for s, t in sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                       for e in dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        row(every.innermost(end))["idle_us"] += nxt - end
    return [{"span": name, "ms_per_step": r["us"] / steps / 1e3,
             "launches_per_step": r["launches"] / steps,
             "idle_ms_per_step": r["idle_us"] / steps / 1e3,
             "categories": {c: us / steps / 1e3 for c, us in sorted(
                 r["categories"].items(), key=lambda kv: -kv[1])}}
            for name, r in sorted(rows.items(), key=lambda kv: -kv[1]["us"])]


def load(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
