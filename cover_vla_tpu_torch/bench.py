"""Benchmark of the port: verified actions per second on one CUDA device.

    python -m cover_vla_tpu_torch.bench [--repeats N]
    python -m cover_vla_tpu_torch.run --role bench

Runs the full-width CoVer pipeline (π0: PaliGemma-3B + Gemma-300M expert +
SigLIP so400m; the SigLIP2 ViT-L/16-384 verifier with 3 ensemble members;
random weights from seeds 0 and 1) at N=16 candidates per episode, raw
uint8 frames and prompts in, selected execution-format action chunks out,
one `make_verified_step_batched` call per control step. The program is the
JAX package's repo-root `bench.py`, measured the same way:

  * the single-episode step's p50 (`make_verified_step`);
  * E=16 lockstep episodes: the blocking p50 over 15 x repeats samples
    with its IQR, the pipelined step (10 steps enqueued, one synchronise)
    that gives the headline, and the device time of 4 profiled pipelined
    steps;
  * the reference protocol, 5 samples x 8 rephrases, one episode;
  * the max-throughput configs (`fast_pi0_config` / `fast_verifier_config`:
    the decode and tower kernels) and the int8 w8a8 route
    (`ops.quant.quantize_pi0_policy` / `quantize_verifier`) through them,
    pipelined.

Each call draws its noise from `torch.Generator(device).manual_seed(i)`
with the JAX calls' key seeds, and counts as done at
`torch.cuda.synchronize(device)`. Prints ONE JSON line with the keys of
`JSON_KEYS`, unrounded; `vs_baseline` is against BASELINE.json's north
star of 10 verified actions/s at N=16. In the port:

  * `mfu` is the analytic model FLOPs of one E-episode step over the
    pipelined step time over the card's dense bf16 peak (`PEAK_FLOPS`,
    keyed by `torch.cuda.get_device_name`); `mfu_profiled` divides by the
    profiled device time instead. Both are null for a device not in the
    table.
  * `profiled_device_ms` is the union of the device intervals (kernels,
    copies, memsets) over all streams in the chrome trace that
    `utils.monitor.profile_trace` writes to `$BENCH_TRACE_DIR` (default
    `bench_trace` under the temporary directory), per step; null on the
    CPU, which has no device events.
  * `xla_reported_tflops_per_step` is what
    `torch.utils.flop_counter.FlopCounterMode` counts over one
    default-config E step: a diagnostic that sees only PyTorch operators,
    not the hand-written kernels.
  * `compile_s` is the seconds of the first single, E-episode and 5x8
    calls. The port compiles nothing at run time, so it is their first-call
    cost.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

import numpy as np

# the keys of the JSON line, in the order printed (the JAX bench.py's keys)
JSON_KEYS = (
    "metric", "value", "unit", "vs_baseline", "parallel_episodes",
    "candidates_per_episode", "chunk_size", "repeats", "pipelined_spread",
    "ref_protocol_spread", "max_throughput_spread", "p50_batched_step_ms",
    "p50_batched_iqr_rel", "p50_batched_n_samples", "pipelined_step_ms",
    "pipelined_actions_per_sec", "p50_single_step_ms",
    "single_episode_actions_per_sec", "mfu", "profiled_device_ms",
    "mfu_profiled", "model_tflops_per_step", "xla_reported_tflops_per_step",
    "ref_protocol_5x8_p50_ms", "ref_protocol_5x8_actions_per_sec",
    "max_throughput_actions_per_sec", "int8_actions_per_sec", "int8_spread",
    "compile_s", "device")

# dense bf16 tensor-core peak FLOP/s by CUDA device name (NVIDIA's data
# sheets, no sparsity): the MFU denominator
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,     # SXM
    "NVIDIA H100 PCIe": 756e12,
}

# chrome-trace categories of work on the device
DEVICE_EVENT_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

BASELINE_ACTIONS_PER_SEC = 10.0


def _merged_len(intervals) -> float:
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def trace_device_busy_s(trace_dir: str) -> Optional[float]:
    """Device-busy seconds in the newest torch.profiler chrome trace under
    `trace_dir`: the union of the complete events of the device categories
    over every device and stream (timestamps in us), or None when the
    trace holds no device event."""
    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"),
                             recursive=True), key=os.path.getmtime)
    if not paths:
        return None
    with open(paths[-1]) as f:
        events = json.load(f).get("traceEvents", [])
    intervals = [(float(ev["ts"]), float(ev["ts"]) + float(ev["dur"]))
                 for ev in events
                 if ev.get("ph") == "X" and ev.get("cat") in DEVICE_EVENT_CATS
                 and ev.get("dur")]
    return _merged_len(intervals) / 1e6 if intervals else None


def _gemma_matmul_params(cfg) -> float:
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    return cfg.depth * (cfg.width * qd + 2 * cfg.width * kvd
                        + qd * cfg.width + 3 * cfg.width * cfg.mlp_dim)


def _vit_matmul_params(cfg) -> float:
    return cfg.depth * (4 * cfg.width ** 2 + 2 * cfg.width * cfg.mlp_dim)


def _analytic_flops(pcfg, vcfg, ccfg, episodes: int) -> float:
    """Model FLOPs of ONE verified step (2 flops/MAC), per episode batch.

    Counts the dominant matmuls: policy vision tower, K prompt prefills
    through PaliGemma, the Euler-loop expert decode over N candidates
    (attending the cached prefix), attention score/value products, and the
    verifier backbone + vmapped ensemble heads.
    """
    K, N = ccfg.n_rephrases, ccfg.n_samples
    P = pcfg.prefix_len
    S = pcfg.suffix_len
    qd_pg = pcfg.paligemma.num_heads * pcfg.paligemma.head_dim
    qd_ex = pcfg.expert.num_heads * pcfg.expert.head_dim

    vision = 2 * _vit_matmul_params(pcfg.vision) * pcfg.vision.num_patches
    prefill = 2 * _gemma_matmul_params(pcfg.paligemma) * K * P
    prefill += 2 * 2 * pcfg.paligemma.depth * K * P * P * qd_pg  # qk + pv
    dec_tokens = pcfg.num_denoise_steps * K * N * S
    decode = 2 * _gemma_matmul_params(pcfg.expert) * dec_tokens
    decode += 2 * 2 * pcfg.expert.depth * dec_tokens * (P + S) * qd_ex

    v_patches = vcfg.vision.num_patches
    verifier = 2 * _vit_matmul_params(vcfg.vision) * v_patches
    verifier += 2 * 2 * vcfg.vision.depth * v_patches ** 2 * vcfg.vision.width
    verifier += 2 * _vit_matmul_params(vcfg.text) * vcfg.text.context_length
    return episodes * (vision + prefill + decode + verifier)


def _spread(vals) -> float:
    """Relative spread (max - min) / median of the repeat medians."""
    m = float(np.median(vals))
    return (max(vals) - min(vals)) / m if m > 0 else 0.0


def run_bench(pcfg, vcfg, ccfg, ccfg58, episodes: int, repeats: int,
              device, n_pipe: int = 10, n_prof: int = 4) -> dict:
    """The benchmark on `device` at the given configs: `ccfg` for the
    single-episode and E-episode steps, `ccfg58` for the reference
    protocol. Prints the JSON line and returns its dict."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from cover_vla_tpu_torch.configs import (
        fast_pi0_config, fast_verifier_config)
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.device import resolve_device
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step, make_verified_step_batched)
    from cover_vla_tpu_torch.models import pi0, verifier
    from cover_vla_tpu_torch.ops import quant
    from cover_vla_tpu_torch.utils.monitor import profile_trace

    dev = resolve_device(device)
    on_cuda = dev.type == "cuda"
    E = episodes
    stats = DatasetStatistics.from_json()

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    def gen(i):
        return torch.Generator(device=dev).manual_seed(i)

    def timeit(call, n=10):
        lat = []
        for i in range(n):
            t0 = time.perf_counter()
            call(i)
            sync()
            lat.append(time.perf_counter() - t0)
        return np.asarray(lat)

    t0 = time.perf_counter()
    policy_params = pi0.init_pi0(0, pcfg, device=dev)
    verifier_params = verifier.init_verifier(1, vcfg, num_members=3,
                                             device=dev)
    sync()
    print(f"# init {time.perf_counter() - t0:.1f}s on {dev}", file=sys.stderr)

    # the JAX bench's inputs, drawn in its order; token ids stay inside a
    # small config's vocabulary (the full-width vocabularies exceed 1000)
    rng = np.random.default_rng(0)
    k, t = ccfg.n_rephrases, pcfg.tokenizer_max_length
    raw1 = rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)
    prop1 = rng.uniform(-0.1, 0.1, 7).astype(np.float32)
    lt1 = rng.integers(0, min(1000, pcfg.paligemma.vocab_size),
                       (k, t)).astype(np.int32)
    lm1 = np.zeros((k, t), bool)
    lm1[:, :12] = True
    vt1 = rng.integers(0, min(1000, vcfg.text.vocab_size),
                       vcfg.text.context_length).astype(np.int32)
    hist1 = np.zeros((ccfg.max_history, 7), np.float32)

    # ---- single episode ---------------------------------------------------
    step1 = make_verified_step(pcfg, vcfg, ccfg, stats, device=dev)

    def call1(i):
        return step1(policy_params, verifier_params, raw1, prop1, lt1, lm1,
                     vt1, hist1, np.int32(6), generator=gen(i))

    t0 = time.perf_counter()
    call1(0)
    sync()
    first1_s = time.perf_counter() - t0
    p50_single = float(np.median([float(np.median(timeit(call1)))
                                  for _ in range(repeats)]))

    # ---- E lockstep episodes ---------------------------------------------
    stepE = make_verified_step_batched(pcfg, vcfg, ccfg, stats, device=dev)
    rawE, propE = np.stack([raw1] * E), np.stack([prop1] * E)
    ltE, lmE = np.stack([lt1] * E), np.stack([lm1] * E)
    vtE, histE = np.stack([vt1] * E), np.stack([hist1] * E)
    hlenE = np.full((E,), 6, np.int32)

    def batched_call(step, pp, vp):
        def call(i):
            return step(pp, vp, rawE, propE, ltE, lmE, vtE, histE, hlenE,
                        generator=gen(i))
        return call

    def pipelined(call, seed0):
        """Seconds per step of n_pipe steps enqueued back to back, then
        one synchronise, once per repeat (seeds seed0 + 50 r + i)."""
        per_step = []
        for r in range(repeats):
            t0 = time.perf_counter()
            outs = [call(seed0 + 50 * r + i) for i in range(n_pipe)]
            sync()
            per_step.append((time.perf_counter() - t0) / n_pipe)
            del outs
        return per_step

    callE = batched_call(stepE, policy_params, verifier_params)
    t0 = time.perf_counter()
    callE(0)
    sync()
    firstE_s = time.perf_counter() - t0
    batched_samples = np.concatenate([timeit(callE, n=15)
                                      for _ in range(repeats)])
    p50_batched = float(np.median(batched_samples))
    q25, q75 = np.percentile(batched_samples, [25, 75])

    pipelined_r = pipelined(callE, 100)
    pipelined_step_s = float(np.median(pipelined_r))

    trace_dir = os.environ.get(
        "BENCH_TRACE_DIR", os.path.join(tempfile.gettempdir(), "bench_trace"))
    shutil.rmtree(trace_dir, ignore_errors=True)
    with profile_trace(trace_dir):
        outs = [callE(300 + i) for i in range(n_prof)]
        sync()
    del outs
    busy_s = trace_device_busy_s(trace_dir)
    if on_cuda and busy_s is None:
        raise RuntimeError(f"the profile in {trace_dir} holds no device "
                           "event: the profiler did not trace the card")
    profiled_device_s = busy_s / n_prof if busy_s is not None else None

    with FlopCounterMode(display=False) as counter:
        callE(0)
        sync()
    counted_flops = counter.get_total_flops()
    flopsE = _analytic_flops(pcfg, vcfg, ccfg, E)
    device_name = torch.cuda.get_device_name(dev) if on_cuda else ""
    peak = PEAK_FLOPS.get(device_name)
    if peak is None:
        print(f"# no bf16 peak known for {dev} {device_name!r}: mfu and "
              "mfu_profiled are null", file=sys.stderr)

    # ---- reference protocol: 5 samples x 8 rephrases (README.md:136) ----
    step58 = make_verified_step(pcfg, vcfg, ccfg58, stats, device=dev)
    k8 = ccfg58.n_rephrases
    lt8 = np.broadcast_to(lt1[:1], (k8, t)).astype(np.int32).copy()
    lm8 = np.broadcast_to(lm1[:1], (k8, t)).copy()

    def call58(i):
        return step58(policy_params, verifier_params, raw1, prop1, lt8, lm8,
                      vt1, hist1, np.int32(6), generator=gen(i))

    t0 = time.perf_counter()
    call58(0)
    sync()
    first58_s = time.perf_counter() - t0
    p50_58_r = [float(np.median(timeit(call58, n=6))) for _ in range(repeats)]
    p50_58 = float(np.median(p50_58_r))

    # ---- max throughput: the decode and tower kernels, pipelined ---------
    stepM = make_verified_step_batched(fast_pi0_config(pcfg),
                                       fast_verifier_config(vcfg), ccfg,
                                       stats, device=dev)
    callM = batched_call(stepM, policy_params, verifier_params)
    callM(0)
    sync()
    max_r = pipelined(callM, 200)
    max_step_s = float(np.median(max_r))

    # ---- int8 (w8a8) serving route through the max-throughput step -------
    qpolicy_params = quant.quantize_pi0_policy(policy_params)
    qverifier_params = quant.quantize_verifier(verifier_params)
    callQ = batched_call(stepM, qpolicy_params, qverifier_params)
    callQ(0)
    sync()
    int8_r = pipelined(callQ, 250)
    int8_step_s = float(np.median(int8_r))

    chunk = pcfg.chunk_size
    actions_per_sec = E * chunk / pipelined_step_s
    out = {
        "metric": "verified_actions_per_sec_chip_N16",
        "value": actions_per_sec,
        "unit": "actions/s",
        "vs_baseline": actions_per_sec / BASELINE_ACTIONS_PER_SEC,
        "parallel_episodes": E,
        "candidates_per_episode": ccfg.batch_size,
        "chunk_size": chunk,
        "repeats": repeats,
        "pipelined_spread": _spread(pipelined_r),
        "ref_protocol_spread": _spread(p50_58_r),
        "max_throughput_spread": _spread(max_r),
        "p50_batched_step_ms": p50_batched * 1e3,
        "p50_batched_iqr_rel": float((q75 - q25) / max(p50_batched, 1e-9)),
        "p50_batched_n_samples": int(len(batched_samples)),
        "pipelined_step_ms": pipelined_step_s * 1e3,
        "pipelined_actions_per_sec": actions_per_sec,
        "p50_single_step_ms": p50_single * 1e3,
        "single_episode_actions_per_sec": chunk / p50_single,
        "mfu": flopsE / pipelined_step_s / peak if peak else None,
        "profiled_device_ms": profiled_device_s * 1e3
        if profiled_device_s else None,
        "mfu_profiled": flopsE / profiled_device_s / peak
        if peak and profiled_device_s else None,
        "model_tflops_per_step": flopsE / 1e12,
        "xla_reported_tflops_per_step": counted_flops / 1e12,
        "ref_protocol_5x8_p50_ms": p50_58 * 1e3,
        "ref_protocol_5x8_actions_per_sec": chunk / p50_58,
        "max_throughput_actions_per_sec": E * chunk / max_step_s,
        "int8_actions_per_sec": E * chunk / int8_step_s,
        "int8_spread": _spread(int8_r),
        "compile_s": first1_s + firstE_s + first58_s,
        "device": f"{dev} {device_name}" if on_cuda else str(dev),
    }
    print(json.dumps(out), flush=True)
    return out


def main(argv=None, device=None) -> dict:
    """Parse `argv` (`sys.argv[1:]` when None) and run the benchmark at
    full width on `device` (the first CUDA device unless given)."""
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, Pi0Config, VerifierConfig)

    ap = argparse.ArgumentParser(prog="python -m cover_vla_tpu_torch.bench")
    ap.add_argument("--repeats", type=int, default=3,
                    help="measurement repeats; the JSON carries the median "
                         "and the relative spread (max-min)/median of the "
                         "repeats' medians")
    args = ap.parse_args(argv)
    return run_bench(Pi0Config(), VerifierConfig(),
                     # N=16 candidates under the current instruction
                     # (BASELINE.json config 3/4)
                     CoVerConfig(n_samples=16, n_rephrases=1),
                     CoVerConfig(n_samples=5, n_rephrases=8),
                     episodes=16, repeats=max(1, args.repeats),
                     device=device)


if __name__ == "__main__":
    main()
