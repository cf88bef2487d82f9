"""The benchmark of the PyTorch/CUDA port, one run of one cell:

    python3 coverbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's cards. Prints
the cell's metrics as ONE JSON object, the last line of its standard
output: its end-to-end metrics with `--trace 0`, its per-layer metrics
with `--trace 1`. Every number the comparison with the reference held
against its limit is printed last on standard error and comes last in
the JSON line, under `compared`.

The cell, its configuration, its traffic mix and its metrics are found by
name: BENCHMARK.json names the cell's configuration file and traffic mix
(`coverbench/traffic/<traffic>.json`); `coverbench/workloads/<cell>.json`
holds the cell's limits; `coverbench/metrics/<metric>.py` reads each
metric. The readings the limits were set from, and the controls, come
from `coverbench/readings.py`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# every build and kernel cache at a fixed place inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"

# top-level module names that may not be loaded in the measured process:
# the JAX package, JAX itself and its companions
FORBIDDEN = ("jax", "jaxlib", "flax", "ml_dtypes", "cover_vla_tpu")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is forbidden, compared whole
    (the port's `cover_vla_tpu_torch` begins with `cover_vla_tpu`)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def metric_readers(names) -> dict:
    """{metric: read(ctx)} from `coverbench/metrics/<metric>.py`."""
    return {n: importlib.import_module(f"coverbench.metrics.{n}").read
            for n in names}


def result_line(out) -> dict:
    """The run's last line: the keys the benchmark's contract names, with every number
    compared and its limit last."""
    line = {"correct": out.correct, "attempted": out.attempted,
            "failed": out.failed, "metrics": out.metrics,
            "device": out.device}
    if out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["compared"] = {n: {"value": v, "limit": lim}
                        for n, (v, lim) in out.compared.items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from coverbench import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"coverbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    names = [m["name"] for m in (cell.per_layer if args.trace
                                 else cell.end_to_end)]
    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda:0", T_START, metric_readers=metric_readers(names))
    bad = forbidden_modules()
    if bad:
        print(f"coverbench: the measured process loaded {', '.join(bad)}",
              file=sys.stderr)
        return 3
    line = result_line(out)
    print(f"memory_peak_bytes {out.device['memory_peak_bytes']} "
          f"(torch.cuda.max_memory_allocated); the comparison took "
          f"{out.check_s:.1f} s", file=sys.stderr)
    print(out.timeline, file=sys.stderr)
    print(f"vote compared in {sum(a['vote_compared'] for a in out.answers)} "
          f"of {len(out.answers)} answers", file=sys.stderr)
    for a in out.answers:
        print("answer " + json.dumps({k: v for k, v in a.items()
                                      if k != "detail"}), file=sys.stderr)
    for n, c in line["compared"].items():
        print(f"compared {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
