"""Roofline breakdown of the port's torch.profiler trace, the counterpart of
`scripts/roofline.py` (which reads a jax.profiler trace).

Reads the newest chrome trace under the trace directory (`--trace-dir`,
default `$BENCH_TRACE_DIR` or `bench_trace` under the temporary directory:
what `utils.monitor.profile_trace` writes and `bench.trace_device_busy_s`
reads), takes its device events (`cat` kernel, gpu_memcpy, gpu_memset) and
sorts them by kernel name into categories: the three hand kernels K1-K3,
the cuBLAS / cuBLASLt GEMMs (bf16, fp32) and `torch._int_mm`'s int8 GEMM,
elementwise, reduction, softmax / norm, index / gather / scatter, copy /
memset and other. Per category it prints ms a step, the share of the
device-busy time, launches a step, and the achieved TFLOP/s and TB/s
against the card's peaks (`bench.PEAK_FLOPS`, `PEAK_FP32_FLOPS`,
`PEAK_INT8_OPS`, `PEAK_HBM_BYTES`; null for a card not in those tables).
The last line is one JSON object.

- **Busy time.** The shares divide by the union of all device events over
  every stream (`bench.trace_device_busy_s`); a category's ms is the sum
  of its events, so on several streams the sum of the categories can
  exceed the union. Both totals are printed.
- **FLOPs and bytes.** A GEMM's come from the shapes of the CPU operator
  that launched it (`record_shapes=True`: "Input Dims", "Input type"),
  joined to the kernel through `External id`; a `flops` entry on that
  operator is used where the trace carries one (PyTorch 2.11 writes none
  to the chrome trace, even with `with_flops=True`). K1-K3 are launched
  outside any operator: `--record` keeps the tensors of each launch
  (`ops.cuda_attention.work_log`) and stores their work by
  `ops/kernel_work.py` in the trace under `cvlaKernelWork`; where the
  trace lost some of those launches (the device tracer drops a few
  events), the rate takes the work of the launches it holds and the row
  says how many it lost. Copies and memsets carry their bytes. Where
  neither is known the rate is null.
- **By span.** Where the trace holds the program's spans (`utils.monitor
  .span`, recorded under `monitor.recording()` or `profile_trace`: the
  `user_annotation` events), each device event's time goes to the
  innermost span open on the thread that launched it (its operator,
  joined through `External id`, or its runtime call, joined through
  `correlation`; "no_span" where neither lies in a span), by category;
  each gap between device work goes to the innermost span open when it
  began. `--record` records the spans and their transfer counters
  (`h2d_copies`, `h2d_bytes`, `h2d_wait_s`, `d2h_*`; the profiled host
  runs slower, so the waits read high).
- **No device events** (a CPU run) raise: there is no CPU fallback.

    python scripts/torch_roofline.py [--trace-dir DIR] [--steps 4]
    python scripts/torch_roofline.py --record [--config fast]  # on the card

`--record` profiles `--steps` full-width `E16_N16_K1` verified steps
(the bench's inputs and weights, `--config` eager / fast / all_kernel),
after one profiled warm-up step that the trace leaves out, into the
trace directory, then reads them.
"""

from __future__ import annotations

import argparse
import bisect
import glob
import gzip
import json
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# categories in the order printed
CATEGORIES = ("K1", "K2", "K3", "gemm_bf16", "gemm_fp32", "gemm_int8",
              "elementwise", "reduction", "softmax_norm", "index",
              "copy_memset", "other")
# the hand kernels by their wrappers' names (ops/cuda_attention.py)
KERNEL_OF = {"K1": "shared_prefix_gqa", "K2": "mha_dense", "K3": "prefix_gqa"}
# the wgmma bodies' symbols as a trace names them:
#   void (anonymous namespace)::decode_wgmma_kernel<256>(...DecodeParams)
#   void (anonymous namespace)::flash_wgmma_kernel<64, 3, false>(...WgParams)
# (the template's last argument is K3's EXACT flag)
K1_SYMBOL = "decode_wgmma_kernel<"
K23_SYMBOL = "flash_wgmma_kernel<"

GEMM_OPS = {"aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm",
            "aten::mv", "aten::addmv", "aten::dot", "aten::_int_mm"}
GEMM_NAMES = ("nvjet", "gemm", "gemv", "cutlass", "xmma", "splitkreduce",
              "cublas")
INT8_NAMES = ("imma", "i8i8", "s8s8", "int8")
SOFTMAX_NORM_OPS = {"aten::_softmax", "aten::softmax", "aten::_log_softmax",
                    "aten::native_layer_norm", "aten::layer_norm",
                    "aten::rms_norm", "aten::_fused_rms_norm",
                    "aten::group_norm", "aten::native_group_norm"}
SOFTMAX_NORM_NAMES = ("softmax", "layer_norm", "layernorm", "rms_norm",
                      "rmsnorm")
INDEX_OPS = {"aten::index", "aten::index_select", "aten::gather",
             "aten::scatter", "aten::scatter_", "aten::scatter_add_",
             "aten::index_put_", "aten::_index_put_impl_", "aten::embedding",
             "aten::take_along_dim", "aten::masked_select", "aten::nonzero",
             "aten::index_add_", "aten::masked_scatter_"}
INDEX_NAMES = ("index", "gather", "scatter", "embedding", "nonzero")
REDUCTION_OPS = {"aten::sum", "aten::mean", "aten::amax", "aten::amin",
                 "aten::max", "aten::min", "aten::argmax", "aten::argmin",
                 "aten::prod", "aten::any", "aten::all", "aten::norm",
                 "aten::linalg_vector_norm", "aten::cumsum", "aten::var",
                 "aten::std", "aten::logsumexp"}
REDUCTION_NAMES = ("reduce_kernel", "reduce", "cumsum", "scan")
COPY_OPS = {"aten::copy_", "aten::cat", "aten::fill_", "aten::zero_",
            "aten::clone", "aten::contiguous", "aten::_to_copy"}
COPY_NAMES = ("copy_kernel", "catarray", "fillfunctor", "memcpy", "memset")
DTYPE_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8,
               "signed char": 1, "unsigned char": 1, "int": 4,
               "long int": 8, "bool": 1, "short int": 2}
HALF_TYPES = ("c10::BFloat16", "c10::Half")


def trace_path(trace_dir: str) -> str:
    """The newest chrome trace (`*.json` or `*.json.gz`) under `trace_dir`."""
    paths = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(trace_dir, "**", pat), recursive=True)]
    if not paths:
        raise FileNotFoundError(f"no chrome trace under {trace_dir!r}")
    return max(paths, key=os.path.getmtime)


def load_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def gemm_work(op: dict):
    """(FLOPs, bytes) of a GEMM operator from its recorded input shapes
    (each input read once, the result written once), or (None, None)."""
    a = op.get("args", {})
    for key, value in a.items():
        if key.lower() == "flops" and value:
            flops = float(value)
            break
    else:
        flops = None
    dims, types = a.get("Input Dims"), a.get("Input type")
    name = op["name"]
    if not dims or not types:
        return flops, None
    mats = [(d, t) for d, t in zip(dims, types) if isinstance(d, list)
            and len(d) in (1, 2, 3) and t in DTYPE_BYTES]
    if name in ("aten::addmm", "aten::baddbmm", "aten::addmv"):
        mats = mats[1:3]              # the bias / accumulator input first
    else:
        mats = mats[:2]
    if len(mats) != 2:
        return flops, None
    (da, ta), (db, tb) = mats
    if len(da) == 2 and len(db) == 2:            # [M, K] @ [K, N]
        batch, m, k, n = 1, da[0], da[1], db[1]
    elif len(da) == 3 and len(db) == 3:          # [B, M, K] @ [B, K, N]
        batch, m, k, n = da[0], da[1], da[2], db[2]
    elif len(da) == 2 and len(db) == 1:          # [M, K] @ [K]
        batch, m, k, n = 1, da[0], da[1], 1
    elif len(da) == 1 and len(db) == 1:          # dot
        batch, m, k, n = 1, 1, da[0], 1
    else:
        return flops, None
    out_bytes = 4 if name == "aten::_int_mm" else DTYPE_BYTES[ta]
    if flops is None:
        flops = 2.0 * batch * m * k * n
    nbytes = (batch * m * k * DTYPE_BYTES[ta] + batch * k * n * DTYPE_BYTES[tb]
              + batch * m * n * out_bytes)
    return flops, float(nbytes)


def category(ev: dict, op) -> str:
    """The category of a device event; `op` is the CPU operator joined to
    it through `External id` (None for K1-K3, copies without one, ...)."""
    name = ev.get("name", "")
    low = name.lower()
    if ev.get("cat") in ("gpu_memcpy", "gpu_memset"):
        return "copy_memset"
    if K1_SYMBOL in name:
        return "K1"
    if K23_SYMBOL in name:
        args = name[name.index(K23_SYMBOL) + len(K23_SYMBOL):].split(">")[0]
        return "K3" if args.replace(" ", "").endswith(",true") else "K2"
    op_name = op["name"] if op else ""
    if op_name == "aten::_int_mm" or any(s in low for s in INT8_NAMES):
        return "gemm_int8"
    if op_name in GEMM_OPS or any(s in low for s in GEMM_NAMES):
        types = (op or {}).get("args", {}).get("Input type") or []
        if op is not None and types:
            half = any(t in HALF_TYPES for t in types)
        else:
            half = not any(s in low for s in ("f32", "sgemm", "<float"))
        return "gemm_bf16" if half else "gemm_fp32"
    # the launching operator decides where the trace names one, else the
    # kernel's symbol
    for ops_, cat in ((SOFTMAX_NORM_OPS, "softmax_norm"), (INDEX_OPS, "index"),
                      (REDUCTION_OPS, "reduction"), (COPY_OPS, "copy_memset")):
        if op_name in ops_:
            return cat
    for names, cat in ((SOFTMAX_NORM_NAMES, "softmax_norm"),
                       (COPY_NAMES, "copy_memset"),
                       (REDUCTION_NAMES, "reduction"),
                       (("elementwise",), "elementwise"),
                       (INDEX_NAMES, "index")):
        if any(s in low for s in names):
            return cat
    return "other"


def peaks(device: str):
    """{category: peak FLOP/s or None}, peak bytes/s or None."""
    from cover_vla_tpu_torch import bench
    bf16 = bench.PEAK_FLOPS.get(device)
    by_cat = {c: bf16 for c in ("K1", "K2", "K3", "gemm_bf16")}
    by_cat["gemm_fp32"] = bench.PEAK_FP32_FLOPS.get(device)
    by_cat["gemm_int8"] = bench.PEAK_INT8_OPS.get(device)
    return by_cat, bench.PEAK_HBM_BYTES.get(device)


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


def roofline(trace: dict, steps: int) -> dict:
    """The breakdown of one loaded trace over `steps` steps."""
    from cover_vla_tpu_torch.bench import DEVICE_EVENT_CATS, _merged_len
    events = trace.get("traceEvents", [])
    dev_events = [e for e in events if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_EVENT_CATS and e.get("dur")]
    if not dev_events:
        raise RuntimeError("the trace holds no device event (a CPU run, or "
                           "the profiler did not trace the card)")
    ops = _operators(events)
    device = next((d.get("name") for d in trace.get("deviceProperties", [])
                   if d.get("id", 0) == 0), None)
    rows = {c: {"us": 0.0, "launches": 0, "flops": 0.0, "flops_us": 0.0,
                "bytes": 0.0, "bytes_us": 0.0} for c in CATEGORIES}
    work_of = {}                    # operator -> (FLOPs, bytes), counted once
    for e in sorted(dev_events, key=lambda e: e["ts"]):
        x = e.get("args", {}).get("External id")
        op = ops.get(x) if x else None
        cat = category(e, op)
        r = rows[cat]
        dur = float(e["dur"])
        r["us"] += dur
        r["launches"] += 1
        if cat.startswith("gemm") and op is not None:
            first = x not in work_of
            if first:
                work_of[x] = gemm_work(op)
            flops, nbytes = work_of[x]
            # a later kernel of the operator adds its time to the rate's
            if flops is not None:
                r["flops"] += flops if first else 0.0
                r["flops_us"] += dur
            if nbytes is not None:
                r["bytes"] += nbytes if first else 0.0
                r["bytes_us"] += dur
        elif cat == "copy_memset" and "bytes" in e.get("args", {}):
            r["bytes"] += float(e["args"]["bytes"])
            r["bytes_us"] += dur
    work = trace.get("cvlaKernelWork", {})
    for cat, name in KERNEL_OF.items():
        w, r = work.get(name), rows[cat]
        if not w or not r["launches"]:
            continue
        # the device tracer can lose events, never add them: the work of
        # the launches the trace holds, at the record's mean a launch
        if r["launches"] > w["launches"]:
            raise RuntimeError(f"{cat}: {r['launches']} launches in the "
                               f"trace, {w['launches']} in its work record")
        share = r["launches"] / w["launches"]
        r.update(flops=w["flops"] * share, flops_us=r["us"],
                 bytes=w["bytes"] * share, bytes_us=r["us"],
                 lost=w["launches"] - r["launches"])
    busy_us = _merged_len([(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                           for e in dev_events])
    flop_peak, hbm_peak = peaks(device)
    out = []
    for cat in CATEGORIES:
        r = rows[cat]
        if not r["launches"]:
            continue
        tflops = (r["flops"] / (r["flops_us"] * 1e-6) / 1e12
                  if r["flops_us"] else None)
        tbs = (r["bytes"] / (r["bytes_us"] * 1e-6) / 1e12
               if r["bytes_us"] else None)
        fp = flop_peak.get(cat)
        out.append({
            "category": cat, "ms_per_step": r["us"] / steps / 1e3,
            "share_of_busy": r["us"] / busy_us,
            "launches_per_step": r["launches"] / steps,
            "tflops": tflops,
            "peak_tflops": fp / 1e12 if fp else None,
            "flops_frac": tflops * 1e12 / fp if tflops is not None and fp
            else None,
            "tbs": tbs, "peak_tbs": hbm_peak / 1e12 if hbm_peak else None,
            "hbm_frac": tbs * 1e12 / hbm_peak if tbs is not None and hbm_peak
            else None,
            "gflop_per_step": r["flops"] / steps / 1e9 if r["flops_us"]
            else None,
            "gb_per_step": r["bytes"] / steps / 1e9 if r["bytes_us"]
            else None,
            "launches_lost": r.get("lost")})
    total_us = sum(r["us"] for r in rows.values())
    return {"device": device, "steps": steps,
            "device_events": len(dev_events),
            "busy_ms_per_step": busy_us / steps / 1e3,
            "category_sum_ms_per_step": total_us / steps / 1e3,
            "shares_divide_by": "the union of the device events over all "
                                "streams (bench.trace_device_busy_s)",
            "categories": out}


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


def by_span(trace: dict, steps: int) -> list:
    """Device time a step by the innermost program span of its launch, by
    category, and the device's idle time a step by the innermost span open
    when each gap began: [{"span", "ms_per_step", "launches_per_step",
    "idle_ms_per_step", "categories": {category: ms a step}}], most device
    time first; [] when the trace holds no span."""
    from cover_vla_tpu_torch.bench import DEVICE_EVENT_CATS
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
           and e.get("cat") in DEVICE_EVENT_CATS and e.get("dur")]
    for e in dev:
        args = e.get("args", {})
        op = ops.get(args.get("External id"))
        host = op or launches.get(args.get("correlation"))
        spans = by_tid.get(host.get("tid")) if host is not None else None
        name = (spans.innermost(float(host["ts"])) if spans is not None
                else NO_SPAN)
        r, dur, cat = row(name), float(e["dur"]), category(e, op)
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


def print_table(res: dict, path: str) -> None:
    def f(x, fmt):
        return format(x, fmt) if x is not None else "null"
    print(f"# {path}")
    print(f"# {res['device']}: {res['device_events']} device events over "
          f"{res['steps']} steps; busy (union) "
          f"{res['busy_ms_per_step']:.3f} ms a step, category sum "
          f"{res['category_sum_ms_per_step']:.3f} ms a step; shares divide "
          "by the union")
    print(f"{'category':14s} {'ms/step':>9s} {'share':>7s} {'launches':>9s} "
          f"{'TFLOP/s':>8s} {'of peak':>8s} {'TB/s':>7s} {'of HBM':>7s}")
    for r in res["categories"]:
        print(f"{r['category']:14s} {r['ms_per_step']:9.3f} "
              f"{100 * r['share_of_busy']:6.2f}% {r['launches_per_step']:9.1f} "
              f"{f(r['tflops'], '8.2f')} {f(r['flops_frac'], '8.4f')} "
              f"{f(r['tbs'], '7.3f')} {f(r['hbm_frac'], '7.4f')}")
    if res.get("by_span"):
        print(f"{'span':22s} {'ms/step':>9s} {'launches':>9s} "
              f"{'idle ms':>8s} {'h2d':>5s} {'h2d MB':>8s}  categories (ms)")
        counts = res.get("span_counts", {})
        for r in res["by_span"]:
            c = counts.get(r["span"], {})
            print(f"{r['span']:22s} {r['ms_per_step']:9.3f} "
                  f"{r['launches_per_step']:9.1f} "
                  f"{r['idle_ms_per_step']:8.3f} "
                  f"{c.get('h2d_copies', 0):5.1f} "
                  f"{c.get('h2d_bytes', 0) / 1e6:8.3f}  " + ", ".join(
                      f"{k} {v:.3f}" for k, v in r["categories"].items()))


def record(trace_dir: str, steps: int, config: str, device=None) -> None:
    """Profile `steps` full-width E16_N16_K1 verified steps under `config`
    (bench.py's weights and inputs) into `trace_dir`, with the operators'
    shapes, the hand kernels' work and the program's spans and their
    transfer counters."""
    import shutil
    import numpy as np
    import torch
    from cover_vla_tpu_torch import bench
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, Pi0Config, VerifierConfig, fast_pi0_config,
        fast_verifier_config, replace)
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.device import resolve_device
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched)
    from cover_vla_tpu_torch.models import pi0, verifier
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.ops.kernel_work import WORK
    from cover_vla_tpu_torch.utils import monitor
    from torch.profiler import ProfilerActivity, profile, schedule

    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    pcfg, vcfg = Pi0Config(), VerifierConfig()
    ccfg = CoVerConfig(n_samples=16, n_rephrases=1)
    pc, vc = pcfg, vcfg
    if config != "eager":
        pc, vc = fast_pi0_config(pcfg), fast_verifier_config(vcfg)
        if config == "all_kernel":
            pc = replace(pc, attention_impl="cuda")
    pp = pi0.init_pi0(0, pcfg, device=dev)
    vp = verifier.init_verifier(1, vcfg, num_members=3, device=dev)
    e = 16
    inputs = [np.stack([x] * e) for x in bench.episode_inputs(pcfg, vcfg,
                                                               ccfg)]
    hlen = np.full((e,), 6, np.int32)
    step = make_verified_step_batched(pc, vc, ccfg,
                                      DatasetStatistics.from_json(),
                                      device=dev)

    def call(i):
        return step(pp, vp, *inputs, hlen,
                    generator=torch.Generator(device=dev).manual_seed(i))

    call(0)
    torch.cuda.synchronize(dev)
    shutil.rmtree(trace_dir, ignore_errors=True)
    os.makedirs(trace_dir)
    path = os.path.join(trace_dir, "trace.json")
    # one profiled warm-up step first: the device tracer loses the first
    # kernels after it starts
    with monitor.recording(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path),
            record_shapes=True, with_flops=True) as prof:
        call(299)
        torch.cuda.synchronize(dev)
        prof.step()
        monitor.drain()
        ca.work_log = []
        try:
            outs = [call(300 + i) for i in range(steps)]
            torch.cuda.synchronize(dev)
            log = ca.work_log
        finally:
            ca.work_log = None
        prof.step()
    del outs
    counts = {}
    for r in monitor.drain():
        c = counts.setdefault(r.name, {})
        for k, v in r.counts.items():
            c[k] = c.get(k, 0) + v
    work = {}
    for name, args in log:
        nbytes, flops = WORK[name](args)
        w = work.setdefault(name, {"launches": 0, "flops": 0.0, "bytes": 0.0})
        w["launches"] += 1
        w["flops"] += flops
        w["bytes"] += nbytes
    trace = load_trace(path)
    trace["cvlaKernelWork"] = work
    trace["cvlaSpanCounts"] = counts
    trace["cvlaRecord"] = {"cell": "E16_N16_K1", "config": config,
                           "steps": steps}
    with open(path, "w") as f:
        json.dump(trace, f)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trace-dir", default=os.environ.get(
        "BENCH_TRACE_DIR", os.path.join(tempfile.gettempdir(), "bench_trace")))
    ap.add_argument("--steps", type=int, default=4,
                    help="steps recorded in the trace (the bench and "
                         "--record profile 4)")
    ap.add_argument("--record", action="store_true",
                    help="first profile --steps full-width E16_N16_K1 "
                         "steps into --trace-dir")
    ap.add_argument("--config", default="fast",
                    choices=("eager", "fast", "all_kernel"),
                    help="attention config of --record")
    ap.add_argument("--device", default=None,
                    help="torch device of --record (CUDA unless 'cpu')")
    args = ap.parse_args(argv)
    if args.record:
        record(args.trace_dir, args.steps, args.config, args.device)
    path = trace_path(args.trace_dir)
    trace = load_trace(path)
    res = roofline(trace, args.steps)
    res["by_span"] = by_span(trace, args.steps)
    res["span_counts"] = {
        name: {k: v / args.steps for k, v in c.items()}
        for name, c in trace.get("cvlaSpanCounts", {}).items()}
    res["trace"] = path
    print_table(res, path)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
