"""The port's benchmark (`cover_vla_tpu_torch/bench.py`) against the JAX
package's repo-root `bench.py`: the JSON line's keys, the analytic FLOP
count, the interval union, the peak table, the trace reader, and one run
end to end on tiny configs on the CPU.

`bench.py` is loaded by path; it imports jax only inside `main`."""

import ast
import importlib.util
import json
import math
import os

import numpy as np
import pytest

from cover_vla_tpu import configs as jconfigs

from cover_vla_tpu_torch import bench, configs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_BENCH_PATH = os.path.join(ROOT, "bench.py")


@pytest.fixture(scope="module")
def jbench():
    spec = importlib.util.spec_from_file_location("jax_bench", JAX_BENCH_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_json_keys():
    """The keys of the dict literal in bench.py's final json.dumps."""
    with open(JAX_BENCH_PATH) as f:
        tree = ast.parse(f.read())
    dumps = [node for node in ast.walk(tree)
             if isinstance(node, ast.Call)
             and isinstance(node.func, ast.Attribute)
             and node.func.attr == "dumps" and node.args
             and isinstance(node.args[0], ast.Dict)]
    assert len(dumps) == 1
    return [k.value for k in dumps[0].args[0].keys]


def test_json_keys_are_the_jax_benchs():
    assert list(bench.JSON_KEYS) == _jax_json_keys()


CONFIGS = {"full": ((jconfigs.Pi0Config(), jconfigs.VerifierConfig()),
                    (configs.Pi0Config(), configs.VerifierConfig())),
           "tiny": ((jconfigs.tiny_pi0_config(),
                     jconfigs.tiny_verifier_config()),
                    (configs.tiny_pi0_config(), configs.tiny_verifier_config()))}


@pytest.mark.parametrize("size", ["full", "tiny"])
@pytest.mark.parametrize("episodes", [1, 16])
@pytest.mark.parametrize("n,k", [(16, 1), (5, 8)])
def test_analytic_flops_equal(jbench, size, episodes, n, k):
    (jp, jv), (tp, tv) = CONFIGS[size]
    want = jbench._analytic_flops(
        jp, jv, jconfigs.CoVerConfig(n_samples=n, n_rephrases=k), episodes)
    got = bench._analytic_flops(
        tp, tv, configs.CoVerConfig(n_samples=n, n_rephrases=k), episodes)
    assert got == want and got > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merged_len_equal(jbench, seed):
    rng = np.random.default_rng(seed)
    starts = rng.uniform(0, 100, 40)
    ivals = [(float(s), float(s + d))
             for s, d in zip(starts, rng.exponential(5, 40))]
    ivals += ivals[:5] + [(3.0, 3.0)]          # repeats and an empty one
    assert bench._merged_len(ivals) == jbench._merged_len(ivals)
    assert bench._merged_len([]) == jbench._merged_len([]) == 0.0
    assert bench._merged_len([(0, 2), (1, 3), (5, 6)]) == 4


def test_peak_table():
    assert bench.PEAK_FLOPS == {"NVIDIA H100 80GB HBM3": 989e12,
                                "NVIDIA H100 PCIe": 756e12}
    # no default: an unknown card (or the CPU) has no MFU
    assert bench.PEAK_FLOPS.get("NVIDIA A100-SXM4-80GB") is None


def test_trace_reader_unions_every_device_lane(tmp_path):
    """Kernels on two streams that overlap, a copy and a memset on a third
    lane, and host events that must not count; timestamps in us."""
    def x(cat, ts, dur, pid=0, tid=7):
        return {"ph": "X", "cat": cat, "name": cat, "pid": pid, "tid": tid,
                "ts": ts, "dur": dur}
    events = [
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "GPU 0"}},
        x("kernel", 100.0, 50.0, tid=7),          # [100, 150]
        x("kernel", 120.0, 60.0, tid=13),         # [120, 180] overlaps
        x("kernel", 300.0, 10.0, tid=13),         # [300, 310]
        x("gpu_memcpy", 175.0, 20.0, tid=21),     # [175, 195]
        x("gpu_memset", 400.0, 5.0, tid=21),      # [400, 405]
        x("kernel", 500.0, 0.0, tid=7),           # zero length
        x("cpu_op", 0.0, 1000.0, pid=4242, tid=1),
        x("cuda_runtime", 90.0, 500.0, pid=4242, tid=1),
        {"ph": "i", "cat": "kernel", "name": "marker", "pid": 0, "tid": 7,
         "ts": 600.0},
    ]
    d = tmp_path / "trace"
    d.mkdir()
    (d / "older.json").write_text(json.dumps({"traceEvents": []}))
    os.utime(d / "older.json", (1, 1))
    (d / "trace.json").write_text(json.dumps({"traceEvents": events}))
    busy = bench.trace_device_busy_s(str(d))
    assert busy == pytest.approx((95 + 10 + 5) / 1e6, abs=1e-12)
    # a host-only trace (the CPU) has no device time
    (d / "trace.json").write_text(json.dumps({"traceEvents": events[-3:]}))
    assert bench.trace_device_busy_s(str(d)) is None
    assert bench.trace_device_busy_s(str(tmp_path / "missing")) is None


def test_run_bench_tiny_end_to_end(tmp_path, monkeypatch, capsys):
    """The whole program at tiny size on the CPU: one JSON line with
    exactly the keys, finite positive rates and latencies, the analytic
    count, and no device metric (the CPU has no peak and no device
    events)."""
    monkeypatch.setenv("BENCH_TRACE_DIR", str(tmp_path / "trace"))
    pcfg, vcfg = configs.tiny_pi0_config(), configs.tiny_verifier_config()
    ccfg = configs.CoVerConfig(n_samples=2, n_rephrases=1)
    ccfg58 = configs.CoVerConfig(n_samples=2, n_rephrases=2)
    ret = bench.run_bench(pcfg, vcfg, ccfg, ccfg58, episodes=2, repeats=1,
                          device="cpu", n_pipe=2, n_prof=1)
    captured = capsys.readouterr()
    lines = [l for l in captured.out.splitlines() if l.strip()]
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert tuple(out) == bench.JSON_KEYS and out == ret
    for key in ("value", "vs_baseline", "p50_batched_step_ms",
                "pipelined_step_ms", "pipelined_actions_per_sec",
                "p50_single_step_ms", "single_episode_actions_per_sec",
                "ref_protocol_5x8_p50_ms", "ref_protocol_5x8_actions_per_sec",
                "max_throughput_actions_per_sec", "int8_actions_per_sec",
                "compile_s", "xla_reported_tflops_per_step"):
        assert math.isfinite(out[key]) and out[key] > 0, key
    assert out["model_tflops_per_step"] == \
        bench._analytic_flops(pcfg, vcfg, ccfg, 2) / 1e12
    assert out["value"] == out["pipelined_actions_per_sec"]
    assert out["vs_baseline"] == out["value"] / 10.0
    assert (out["parallel_episodes"], out["candidates_per_episode"],
            out["chunk_size"], out["repeats"],
            out["p50_batched_n_samples"]) == (2, 2, pcfg.chunk_size, 1, 15)
    assert out["mfu"] is None and out["mfu_profiled"] is None
    assert "no bf16 peak known for cpu" in captured.err
    assert out["profiled_device_ms"] is None
    assert out["device"] == "cpu"
    assert out["pipelined_spread"] == out["int8_spread"] == 0.0


def test_main_runs_the_full_width_program(monkeypatch):
    """`main` parses its own argv (`--repeats`, nothing else) and runs the
    JAX bench's configuration."""
    seen = []
    monkeypatch.setattr(bench, "run_bench",
                        lambda *a, **kw: seen.append((a, kw)) or {})
    bench.main([], device="cpu")
    bench.main(["--repeats", "0"], device="cpu")
    (pcfg, vcfg, ccfg, ccfg58), kw = seen[0]
    assert (pcfg, vcfg) == (configs.Pi0Config(), configs.VerifierConfig())
    assert (ccfg.n_samples, ccfg.n_rephrases) == (16, 1)
    assert (ccfg58.n_samples, ccfg58.n_rephrases) == (5, 8)
    assert kw == {"episodes": 16, "repeats": 3, "device": "cpu"}
    assert seen[1][1]["repeats"] == 1
    with pytest.raises(SystemExit):
        bench.main(["--role", "bench"], device="cpu")
