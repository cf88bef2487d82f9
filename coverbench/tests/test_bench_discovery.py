"""BENCHMARK.json against the contract, and everything a cell needs
found by name."""

import json
import os
import re

import pytest

from coverbench import backbones, harness
from coverbench.run import metric_readers, result_line
from coverbench.harness import RunOutput

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
# the metrics of the program's spans and counters: (unit, source, layer)
SPAN_METRICS = {
    "prefix_ms_per_boundary": ("ms", "device_trace", "step"),
    "denoise_ms_per_boundary": ("ms", "device_trace", "step"),
    "verify_ms_per_boundary": ("ms", "device_trace", "step"),
    "tokenize_ms_per_boundary": ("ms", "program_span", "engine"),
    "h2d_copies_per_boundary": ("count", "program_counter", "engine"),
    "h2d_wait_ms_per_boundary": ("ms", "program_counter", "engine"),
    "resolve_wait_ms_per_boundary": ("ms", "program_counter", "engine"),
}


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_contract_keys_and_names():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["coverbench"] and \
        b["command"] == ["python3", "coverbench/run.py"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in b["end_to_end"]} == {
        "verified_actions_per_s", "setup_s"}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] == "verified_actions_per_s"
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    per_layer = {m["name"]: m for m in b["per_layer"]}
    for name, (unit, source, layer) in SPAN_METRICS.items():
        m = per_layer[name]
        assert (m["unit"], m["source"], m["layer"], m["better"]) == (
            unit, source, layer, "lower")
        assert "workloads" not in m        # read in every cell
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    # a backbone's own kernel is read only in the cells whose backbone
    # runs it, so that a cell of another backbone owes no reading of it
    kernels = {}
    for w in b["workloads"]:
        cfg = harness.load_cell(w["name"]).config
        kernels[w["name"]] = set(backbones.load(cfg).KERNELS)
    for m in b["per_layer"]:
        kernel = m["name"].upper().removesuffix("_ROOFLINE")
        if any(kernel in ks for ks in kernels.values()):
            assert set(m["workloads"]) <= {
                w for w, ks in kernels.items() if kernel in ks}
    for c in b["configs"]:
        assert c["reduced"] == [] and c["file"].startswith("coverbench/")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 65536


@pytest.mark.parametrize("workload", [w["name"] for w in bench()["workloads"]])
def test_cell_found_by_name(workload):
    cell = harness.load_cell(workload)
    assert cell.traffic["episodes_per_cohort"] >= 1
    assert set(cell.limits) >= {"action_rms", "pick_mismatch",
                                "decode_mismatch", "vote_mismatch",
                                "engine_mismatch", "flip_margin", "sample"}
    # every number compared lies between its readings, nearer the upper
    for n, r in cell.limits["readings"].items():
        if not isinstance(r, dict):
            continue                # a note: "source", "flip_margin"
        if n in cell.limits:
            lo, hi = max(r["sound"]), min(r["control"])
            assert hi >= 3 * lo and lo < cell.limits[n] < hi
        elif isinstance(r, dict):
            assert "not_compared" in r
    readers = metric_readers([m["name"] for m in cell.end_to_end
                              + cell.per_layer])
    assert all(callable(r) for r in readers.values())
    assert backbones.load(cell.config).__name__ == \
        "coverbench.backbones." + cell.config["backbone"]
    pcfg, vcfg, ccfg, members = harness.port_configs(cell.config,
                                                     cell.traffic)
    assert pcfg.attention_impl == "cuda" and pcfg.decode_attn_impl == "cuda"
    assert vcfg.vision.attn_impl == "cuda" and members == 3
    assert ccfg.n_samples * ccfg.n_rephrases == \
        cell.traffic["n_samples"] * cell.traffic["n_rephrases"]


def test_a_metric_is_a_file():
    """A per-layer metric is added by adding its reader file."""
    here = os.path.join(ROOT, "coverbench", "metrics")
    for m in bench()["end_to_end"] + bench()["per_layer"]:
        assert os.path.exists(os.path.join(here, m["name"] + ".py"))


def test_result_line_keys():
    out = RunOutput(
        correct=True, attempted=64, failed=0,
        metrics={"verified_actions_per_s": {"value": 1.5,
                                            "unit": "actions/s"}},
        device={"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                "count": 1, "memory_peak_bytes": 123, "busy_s": 0.5,
                "window_s": 0.6},
        compared={"score_gap": (0.001, 0.01)},
        breakdown={"device_ops": [["k", 0.1]], "idle_gaps": [["x", 0.1]]})
    line = result_line(out)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "breakdown", "compared"]
    assert line["compared"]["score_gap"] == {"value": 0.001, "limit": 0.01}
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    json.dumps(line)
