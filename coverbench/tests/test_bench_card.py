"""On the card: one short run of a cell through the command, its last
line read as a consumer of the benchmark reads it. Skips without a CUDA device."""

import json
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
def test_short_run_on_card(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell runs the port's kernels")
    proc = subprocess.run(
        [sys.executable, "coverbench/run.py", "--workload",
         "pi0_cover_bf16.E64_N80_K1", "--seed", str(2 ** 31 + 77),
         "--seconds", "3", "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "compared"
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert {"step_mfu", "k1_roofline"} <= set(line["metrics"])
    else:
        assert set(line["metrics"]) == {"verified_actions_per_s", "setup_s"}
