"""The readings that a cell's correctness limits are set from: the
numbers the comparison gives for sound runs of the program over many
seeds, and for the cell's control over a few, in one process (set-up is
paid once for the kernels; weights and traffic are made anew from each
seed):

    python3 coverbench/readings.py --workload <cell> --seeds 1,2,3 \
        --control program_w8a8 --control-seeds 4,5,6 [--seconds 6]

One JSON line a run on standard output. The control of a bf16
configuration is the program on its own int8 w8a8 route
(`program_w8a8`); that of a w8a8 configuration is the reference on the
int4 grid in the program's place (`reference_int4`). The int8 route
rounds the verifier's scores no more than bf16 does, so the bf16 cells'
`score_gap` takes its upper reading from `reference_int4` too. The
benchmark's own runs never run a control.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control", choices=("program_w8a8", "reference_int4"))
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)

    import torch
    from coverbench import harness
    from coverbench.run import metric_readers

    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    readers = metric_readers(["verified_actions_per_s", "setup_s"])
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), args.control) for s in args.control_seeds.split(",")
             if s]
    for seed, control in runs:
        out = harness.run(cell, seed, args.seconds, False, "cuda:0",
                          time.perf_counter(), control=control,
                          metric_readers=readers)
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "kind": control or "sound", "correct": out.correct,
            "compared": {n: v for n, (v, _) in out.compared.items()},
            "answers": out.answers,
            "actions_per_s": out.metrics["verified_actions_per_s"]["value"],
            "peak": out.device["memory_peak_bytes"],
            "vote_compared": sum(a["vote_compared"] for a in out.answers),
            "timeline": out.timeline, "check_s": out.check_s}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
