#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure ends the run with a nonzero exit and no result line):
  1. device: card name and power limit, TF32 off, kernels built from
     cover_vla_tpu_torch/csrc with nvcc (sm_90a);
  2. kernels: each CUDA kernel against its plain PyTorch twin on the card
     in bf16 at the main path's shapes, at ragged ones and at the edges of
     the kernels' row and key tiles (K1 also at its key-split boundaries,
     S = 1 and 32, G = 1, the padded head dims, and with query rows that
     attend no key; the verification-scaling experiment's shapes at head
     dim 16; max abs error <= 2e-2; the prefill
     kernel's fp32 result <= 1e-4), timed beside the twin and one PyTorch
     library call: per call in a stream of enqueued calls, per call inside
     a replayed CUDA graph (device time without the host), and the host
     time of one enqueue;
  3. small reference: the port's eager step, and a lockstep evaluation of
     two fake-env episodes, on tiny configs with fp32 weights, on the card
     against the same on the CPU;
  4. the verified step at full width: pi0 (PaliGemma-3B + Gemma-300M
     expert + SigLIP so400m) and the SigLIP2 ViT-L/16-384 verifier with 3
     members, random weights from a seed, through
     make_verified_step_batched under the fast configs (decode and tower
     kernels), the all-kernel configs (the prefill kernel too) and the
     eager configs: E=16 episodes x N=16 candidates, and the reference
     5x8 protocol at E=1. Launch counts, output checks, kernel-vs-eager
     agreement, step times;
  5. closed-loop evaluation at full width under the all-kernel configs,
     5x8 protocol over the fake environment: evaluate_suite_batched with 4
     lockstep episodes, the same pipelined over two cohorts, one
     CoVerEvaluator episode through CoVerEngine, and the injected-score
     mode against the fused step;
  6. serving at full width: the int8 route card vs CPU (weight and
     activation grids bit-equal, torch._int_mm's int32 accumulators equal
     to the exact CPU product, also at 1, 8, 16 and 17 rows), the
     activation-quant and rescale kernels bit-equal to their plain twins
     at the benchmark cells' shapes and timed beside their bound and the
     twins, and the w8a8 product timed against the bf16 GEMM in both
     weight layouts; the int8_full verified step (w8a8 policy and
     verifier backbone) in both cells under the fast and all-kernel
     configs, in turns with bf16 fast: launch counts (the quant kernels'
     too), every output bit-equal to the step's with the eager quant
     chain, every candidate and score within the JAX package's int8 bounds, step
     times, a profile; pi0-FAST (PaliGemma 2B + so400m) greedy
     generation of 64 tokens at B = 1 and 4, deterministic and invariant
     to padded prompt ids, prefill and per-token times; four served policies (the
     factory's int8 pi0 and pi0-FAST, an int8 pi0 under the fast config,
     the int8_full CoVer engine) answering infer x3, reset, infer through
     the server's verb dispatch, and one localhost websocket round trip
     when websockets and msgpack import;
  7. checkpoints and the entry point at full width: phase 4's random π0
     written as a lerobot-layout .safetensors (the converter's layout
     inverted, this script's own writer) and loaded back through
     loaders.load_policy_params cold (read, convert, cache write, card)
     and from its .torchcache twice (page cache dropped, then warm): every
     leaf bit-equal, each stage's seconds, GB/s from the disk and to the
     card, host peak RSS, card peak; the verifier heads through a merged
     .pt and back with the served backbone, bit-equal; the loaded trees
     through the all-kernel E1_N5_K8 step, candidates, scores and pick
     bit-equal to the in-memory trees' (launches 180/75/18); and
     run.build_server in cover mode from those files (refused without
     allow_hash_tokenizer, and with a heads-only .pt as its first
     verifier), answering infer x3, reset, switch_model to a second π0 (a
     blob directory), infer, switch_model to verifier:<heads .pt>, infer:
     the switched trees bit-equal, request p50, switch seconds;
  8. training: the tiny π0 (fp32) through 3 partitioned adamw_8bit steps
     and 3 full adamw steps with grad_accum 2 on the card against the same
     on the CPU (loss, grad norm, every leaf, the int8 grids); a random
     full-width π0, expert-only with remat at B = 32, 6 steps of
     adamw_8bit then 6 of adamw (step time, card peak, losses, trainable
     count against its reckoning, frozen leaves bit-equal), and one step
     of the whole tree under adamw; run.main --role train at full width
     over two npz trajectories (4 steps with validation and checkpoints,
     then resumed to 6: the restored state bit-equal to the saved one,
     metrics.jsonl keys, the files deleted); validate_pi0 on the trained
     weights under the all-kernel config (launches 180/27/18 a call) and
     the eager one (chunks within 1e-2, the same accuracies).
  9. verifier and π0-FAST training: the tiny verifier (fp32, 3 members)
     through 3 ensemble steps and one step of each ranking objective, and
     the tiny π0-FAST's token_ce_loss with its gradient norm, card vs CPU;
     the frozen-backbone ensemble step at full width (SigLIP2 ViT-L/16-384
     and text towers, 3 members, B = 32) under the eager and the kernel
     config in turns (step times, card peak, device-busy share, trainable
     count, K2 48 launches a step; features, metrics and members kernel vs
     eager; the backbone bit-equal); validation metrics and the retrieval
     harness (32 probes, pool 20) eager vs kernel; the whole verifier
     trained (refused under the kernel config) and the ranking, listwise
     and regression steps; run.main --role train_verifier over a written
     bridge JSON with best/, the merged ensemble and a resume; π0-FAST
     (PaliGemma-2B + so400m, the whole tree, B = 8) under AdamW and 8-bit
     AdamW; run.main --role train_pi0fast over a raw-image RLDS shard with
     a resume, the restored states bit-equal.
 10. multi-process, at world size 1 over NCCL (one card; a FileStore
     rendezvous) on a ('dp', 'fsdp') = (1, 1) mesh: make_verified_step_sharded
     at E16_N16_K1 and E1_N5_K8 under the fast and all-kernel configs,
     every field bit-equal to the batched step (the noise given, and
     drawn from one seed), launches 180/75/18 (0 prefill launches under
     fast), p50 in turns with the batched step; the FSDP expert-only π0
     step (8-bit AdamW, B = 32) in turns with the unsharded step from the
     same seed's state, 6 steps bit-equal (losses, grad norms, every
     parameter and int8 grid entry), step times, card peaks and the
     collectives' device time from a profile; the DDP verifier ensemble
     step (kernel config, B = 32) in turns with the unsharded one, K2 48
     launches a step, metrics and members bit-equal; one FSDP π0-FAST step
     (whole tree, 8-bit AdamW, B = 8) bit-equal to the unsharded one;
     `python -m torch.distributed.run --standalone --nproc_per_node 1 -m
     cover_vla_tpu_torch.run --role train` at full width for 3 steps and a
     resume, the re-saved state byte-equal to the saved one; and the
     2-process gloo parity of the tiny π0's FSDP steps on the machine's
     CPU (this script run as `--gloo-rank`), within the CPU tests' bounds.
 11. the bench role: `run.main(["--role", "bench"])` in process at its
     defaults (cover_vla_tpu_torch/bench.py: the single-episode step,
     E=16 lockstep episodes blocking, pipelined and profiled, the 5x8
     protocol, the max-throughput and the int8 steps, 3 repeats), its one
     JSON line held to the JAX bench's keys, finite positive rates and
     latencies, the analytic FLOP count, 0 < mfu <= 1, a profiled device
     time no longer than the pipelined step, and the decode and tower
     kernels launched 180 and 75 times in each max-throughput and int8
     step (the prefill kernel never).
 12. the verification-scaling experiment's committed trained trees
     (experiments/verification_scaling, read through
     convert.from_jax.load_pickle without ml_dtypes) at the experiment's
     widths (head dim 16): lockstep cohorts of 16 fake-env episodes, 60
     env steps, verifier N=16 K=1 and N=5 K=8, each under eager, fast and
     all_kernel with the same host noise (successes per config, launches
     10 / 7 / 2 a verified step under all_kernel); eager's inputs replayed
     through the kernel configs (every candidate within 1e-2, scores
     within 2.5e-2, picks equal wherever eager's decision gap exceeds
     twice the step's largest score difference, and at least one such
     pick) and, with fp32 trees, through eager on the CPU (1e-4).
 13. the experiment's training stages (scripts/torch_verification_scaling.py)
     at its widths: one rankdata cohort of 10 episodes with the committed
     policy, eager driving and the fast propose step (K1, 10 launches a
     chunk boundary) on the same inputs and noise (trajectories and
     candidates within 1e-2, each candidate's quality within its chunk
     pair's Lipschitz bound where both reach the same grasp state); three
     steps each of train_policy, pretrain_backbone and train_verifier on
     the card and on the CPU from the same fp32 state and batches (losses
     within 1e-5, parameters within 1e-4 and all but 1e-2 of them within
     1e-5, key biases within twice the steps' summed learning rates); the
     verifier's frozen-backbone step
     under fast (K2, 5 launches a step, losses within 2e-2 of eager's);
     and each stage's step time at its batch.
 14. the experiment's last stages, its OOD diagnostics and the roofline
     (scripts/torch_verification_scaling.py, torch_ood_diagnostics.py,
     torch_roofline.py): `calibrate`'s prototype of 512 ID frames under
     eager and fast on the card and eager on the CPU (card vs CPU within
     1e-4, fast vs eager within 2e-2); a 10-episode verifier N=16 cohort
     (fast) on the OOD task farthest from the prototype under the ID p05
     and p50 thresholds (deferred picks counted, more than 0 at p50, each
     one candidate 0), and at -inf the calibrated tree's cohort bit-equal
     to the uncalibrated tree's; `lang` on 64 grounded slates and `regret`
     on one cohort's slates (proposed under fast), scored under eager and
     fast: scores within 2.5e-2, picks equal wherever eager's top-two gap
     exceeds twice the largest score difference, the other flips counted;
     `probe` of the pretrained tower (256 frames, 100 Adam steps); and the
     roofline of phase 11's bench trace (eager steps: no hand kernel) and
     of 1 recorded fast E16_N16_K1 step (K1 180, K2 75 launches a step
     by the wrappers' record, the trace holding at least 98% of them),
     each category sum within 2% of bench.trace_device_busy_s and no
     share above 100%.
Each phase prints its wall time. The last two lines are the card's `nvidia-smi` name/power line and
{"ok": true, "device": {...}}; the line before them is the kernel table.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor cores
KERNEL_TOL = 2e-2
# K3 keeps its probabilities in fp32: its fp32 result must agree with the
# twin's far more closely than a bf16-rounded p would (checked both ways)
K3_FP32_TOL = 1e-4
# Kernel configs vs eager actions at full width. The JAX package's own
# fast-vs-exact bound is rtol 0.1 / atol 0.05
# (tests/test_pallas_attention.py:169-171). On the H100 the largest
# deviation over all candidates was 2.3e-3 (E=16 x N=16) and 1.6e-3 (5x8),
# so the bound is tightened to 1e-2 absolute, a 4x margin; a flipped
# gripper sign (deviation 2) fails either bound. The configs' scores
# deviated by at most 1.1e-2 (bf16 tower attention); the score bound is a
# fixed 2.5e-2, about 2.3x that, and it also bounds the eager score gap
# across which a kernel config may pick another candidate.
FAST_RTOL, FAST_ATOL = 0.0, 1e-2
SCORE_ATOL = 2.5e-2
STEP_REPEATS = 2            # in-turns rounds of the step p50s


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------


def time_ms(torch, fn, arg_sets, iters: int) -> float:
    """Mean device ms per call over `iters` calls cycling through
    `arg_sets` (several input copies, so L2 does not hold them all)."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, arg_sets, launches: int = 20, replays: int = 5) -> float:
    """Mean device ms per call with the host out of the way: `launches`
    calls, cycling through `arg_sets`, are captured in one CUDA graph that
    is replayed `replays` times between two events."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(launches):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_enqueue_us(torch, fn, args, calls: int = 200) -> float:
    """Host microseconds one call takes to enqueue its work (no
    synchronisation inside the timed window)."""
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def wgmma_spills(compiler_log: str) -> dict:
    """{"<padded head dim>,<warpgroups a block>,<1 for K3's fp32-p
    instance>" or "decode,<padded head dim>": (bytes of spill stores, of
    spill loads)} for every flash_wgmma_kernel and decode_wgmma_kernel
    instance in nvcc's -Xptxas -v report."""
    out, key = {}, None
    for line in compiler_log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"flash_wgmma_kernelILi(\d+)ELi(\d+)ELb([01])E", line)
            d = re.search(r"decode_wgmma_kernelILi(\d+)E", line)
            key = (f"{m.group(1)},{m.group(2)},{m.group(3)}" if m
                   else f"decode,{d.group(1)}" if d else None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and key is not None:
            out[key] = (int(m.group(1)), int(m.group(2)))
            key = None
    return out


def n_copies(bytes_per_set: int) -> int:
    return max(1, min(8, math.ceil(100e6 / bytes_per_set)))


# ---------------------------------------------------------------------------
# phase 2: kernels
# ---------------------------------------------------------------------------


def k1_inputs(torch, gen, dev, b, n, s, hq, hkv, d, p, n_valid,
              empty_rows=False):
    """The action expert's suffix mask (the state token attends itself, the
    actions the state and each other); `empty_rows`: in the last batch row
    no prefix key is real and the state token attends nothing, so those
    query rows have no attended key."""
    bf = torch.bfloat16

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf)

    pad = torch.zeros((b, p), dtype=torch.bool, device=dev)
    for i in range(b):
        pad[i, :n_valid[i % len(n_valid)]] = True
    i, j = torch.arange(s, device=dev)[:, None], torch.arange(s, device=dev)
    smask = ((j == 0) | ((i >= 1) & (j >= 1))).expand(b, s, s).contiguous()
    if empty_rows:
        pad[-1] = False
        smask[-1, 0] = False
    return (rnd(b, n, s, hq, d), rnd(b, n, s, hkv, d), rnd(b, n, s, hkv, d),
            rnd(b, p, hkv, d), rnd(b, p, hkv, d), pad, smask)


def k1_library(torch, F, args):
    """Yardstick: SDPA over [prefix expanded over N | own suffix] with a
    boolean mask. Returns (fn, its inputs, seconds to build them)."""
    q, ks, vs, kp, vp, pad, smask = args
    b, n, s, hq, d = q.shape
    p, hkv = kp.shape[1], kp.shape[2]

    def build():
        k = torch.cat([kp[:, None].expand(b, n, p, hkv, d), ks], dim=2)
        v = torch.cat([vp[:, None].expand(b, n, p, hkv, d), vs], dim=2)
        k = k.reshape(b * n, p + s, hkv, 1, d).expand(
            b * n, p + s, hkv, hq // hkv, d).reshape(b * n, p + s, hq, d)
        v = v.reshape(b * n, p + s, hkv, 1, d).expand(
            b * n, p + s, hkv, hq // hkv, d).reshape(b * n, p + s, hq, d)
        mask = torch.cat([pad[:, None, :].expand(b, s, p), smask], dim=2)
        mask = mask[:, None, None].expand(b, n, 1, s, p + s).reshape(
            b * n, 1, s, p + s)
        return (q.reshape(b * n, s, hq, d).transpose(1, 2),
                k.transpose(1, 2), v.transpose(1, 2), mask)

    built = build()
    expand_ms = time_ms(torch, build, [()], 5)

    def fn(qq, kk, vv, mm):
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mm)
    return fn, built, expand_ms


def k2_inputs(torch, gen, dev, b, s, h, d):
    def rnd():
        return torch.randn((b, s, h, d), generator=gen, device=dev).to(
            torch.bfloat16)
    return rnd(), rnd(), rnd()


def k3_inputs(torch, gen, dev, b, sq, skv, hq, hkv, d, n_valid,
              causal=False):
    """Prefill-style inputs: key j of batch row i is real when
    j < n_valid[i], or lo <= j < hi where n_valid[i] is a (lo, hi) window;
    with sq == skv the same holds for the query rows, so
    mask = pad[:, None, :] & pad[:, :, None] and padding rows are fully
    masked. `causal` also masks the keys after the query's position (the
    last query sits on the last key), so that with a window every real row
    meets whole tiles of masked keys ahead of its first real key."""
    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    pad = torch.zeros((b, skv), dtype=torch.bool, device=dev)
    for i in range(b):
        valid = n_valid[i % len(n_valid)]
        lo, hi = valid if isinstance(valid, tuple) else (0, valid)
        pad[i, lo:hi] = True
    qpad = pad if sq == skv else torch.ones((b, sq), dtype=torch.bool,
                                            device=dev)
    mask = pad[:, None, :] & qpad[:, :, None]
    if causal:
        pos = torch.arange(skv, device=dev)
        mask = mask & (pos[None, :] <= pos[-sq:, None])
    mask = mask.contiguous()
    return rnd(b, sq, hq, d), rnd(b, skv, hkv, d), rnd(b, skv, hkv, d), mask


def k3_library(torch, F, args):
    """Yardstick: SDPA with the bool mask over K/V expanded to the query
    heads. Returns (fn, its inputs, ms to build them)."""
    q, k, v, mask = args
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]

    def build():
        def heads(x):
            return x[:, :, :, None].expand(b, skv, hkv, hq // hkv, d).reshape(
                b, skv, hq, d).transpose(1, 2).contiguous()
        return q.transpose(1, 2).contiguous(), heads(k), heads(v), mask[:, None]

    built = build()
    expand_ms = time_ms(torch, build, [()], 5)
    return (lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
        qq, kk, vv, attn_mask=mm)), built, expand_ms


def k3_fp32_check(torch, name, ca, args, separates=True):
    """K3's fp32 result against the twin's, and beside it what rounding p
    to bf16 (K1/K2's rounding point, which K3 must not have) would cost;
    with `separates` that cost must lie above the bound."""
    from cover_vla_tpu_torch.ops.attention import BIG_NEG
    q, k, v, mask = args
    f32 = torch.float32
    got = ca.prefix_gqa(*args, out_dtype=f32)
    ref = ca.prefix_gqa_plain(*args, out_dtype=f32)
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    sc = torch.einsum("bqhgd,bkhd->bhgqk",
                      q.float().reshape(b, sq, hkv, hq // hkv, d), k.float())
    sc = torch.where(mask[:, None, None], sc * d ** -0.5, BIG_NEG)
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    p_bf = p.to(torch.bfloat16).float()
    rounded = (torch.einsum("bhgqk,bkhd->bqhgd", p_bf, v.float())
               / p_bf.sum(-1).permute(0, 3, 1, 2)[..., None]).reshape(ref.shape)
    torch.cuda.synchronize()
    err = (got - ref).abs().max().item()
    err_rounded = (rounded - ref).abs().max().item()
    if not math.isfinite(err) or err > K3_FP32_TOL:
        raise AssertionError(f"{name} fp32: max abs error {err} > {K3_FP32_TOL}")
    if separates and err_rounded <= K3_FP32_TOL:
        raise AssertionError(
            f"{name} fp32: a bf16-rounded p deviates only {err_rounded}, "
            f"so the bound {K3_FP32_TOL} does not separate the two")
    log(f"kernel {name} fp32 result: max_abs_err={err:.3e} (bound "
        f"{K3_FP32_TOL:.0e}); the same product with p rounded to bf16 "
        f"deviates {err_rounded:.3e}")


def check_and_time(torch, card, name, design, kernel, twin, inputs_fn,
                   work_fn, library_fn, iters):
    """Compare kernel vs twin on one shape; time kernel, twin, library."""
    from cover_vla_tpu_torch.ops.kernel_work import nbytes
    args = inputs_fn()
    got, ref = kernel(*args), twin(*args)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    if not math.isfinite(err) or err > KERNEL_TOL:
        raise AssertionError(f"{name}: max abs error {err} > {KERNEL_TOL}")
    sets = [args] + [inputs_fn() for _ in range(n_copies(nbytes(*args)) - 1)]
    ms = time_ms(torch, kernel, sets, iters)
    plain_ms = time_ms(torch, twin, sets[:2], max(3, iters // 10))
    lib_fn, lib_args, expand_ms = library_fn(args)
    library_ms = time_ms(torch, lib_fn, [lib_args], iters)
    device_ms = graph_ms(torch, kernel, sets)
    library_device_ms = graph_ms(torch, lib_fn, [lib_args])
    host_us = host_enqueue_us(torch, kernel, args)
    bytes_, flops = work_fn(args)
    bound_ms = max(bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOPS) * 1e3
    bound_by = ("bytes" if bytes_ / HBM_BYTES_PER_S >= flops / BF16_FLOPS
                else "operations")
    extra = f" (+{expand_ms:.4f} ms to build its inputs)" if expand_ms else ""
    log(f"kernel {name} design={design}: max_abs_err={err:.3e} "
        f"kernel={ms:.4f} ms (in a graph {device_ms:.4f} ms, host enqueue "
        f"{host_us:.1f} us) plain={plain_ms:.4f} ms library={library_ms:.4f} "
        f"ms (in a graph {library_device_ms:.4f} ms){extra} "
        f"bound={bound_ms:.4f} ms ({bound_by}; {bytes_ / 1e6:.2f} MB, "
        f"{flops / 1e9:.3f} GFLOP) | {card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
                device_ms=device_ms, library_device_ms=library_device_ms,
                host_us=host_us)


def kernel_phase(torch, card, dev):
    import torch.nn.functional as F
    from cover_vla_tpu_torch.ops.kernel_work import k1_work, k2_work, k3_work
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.ops.attention import gqa_attention

    gen = torch.Generator(device=dev).manual_seed(0)
    k2_lib = (lambda a: (
        lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
        tuple(x.transpose(1, 2).contiguous() for x in a), 0.0))
    # prefix of the bench's prompts: 256 image tokens + 12 of 72 language
    # tokens valid (the rest padded)
    # (cohort: the episode path's 4 lockstep episodes x 8 rephrases)
    k1_main = dict(bench=(16, 16, 5, 8, 1, 256, 328, [268]),
                   protocol=(8, 5, 5, 8, 1, 256, 328, [268]),
                   cohort=(32, 5, 5, 8, 1, 256, 328, [268]))
    k1_extra = dict(ragged=(3, 7, 5, 8, 2, 256, 77, [77, 40, 1]))
    # K1's design edges: rows one under, at and one over the 64-row
    # warpgroup and the 128-row block (S = G = 1); P one under, at and one
    # over the 64-key tile and the split boundaries (one batch row splits
    # 383-385 keys into 3 or 4 parts, 1500 into 6, 2000 into 8), and
    # under one tile; S = 1 and 32; a
    # warpgroup over 3-4 candidates; G = 1 with Hkv = 2; the padded head
    # dims; query rows with no attended key (`empty`)
    k1_edges = {f"edge_{tag}": shape for tag, shape in dict(
        rows63=(2, 63, 1, 1, 1, 256, 70, [70, 46]),
        rows64=(2, 64, 1, 1, 1, 256, 70, [70, 46]),
        rows65=(2, 65, 1, 1, 1, 256, 70, [70, 46]),
        rows127=(2, 127, 1, 1, 1, 256, 70, [70, 46]),
        rows128=(2, 128, 1, 1, 1, 256, 70, [70, 46]),
        rows129=(2, 129, 1, 1, 1, 256, 70, [70, 46]),
        p40=(2, 3, 5, 8, 1, 256, 40, [40, 26]),
        p63=(2, 3, 5, 8, 1, 256, 63, [63, 42]),
        p64=(2, 3, 5, 8, 1, 256, 64, [64, 42]),
        p65=(2, 3, 5, 8, 1, 256, 65, [65, 43]),
        p127=(2, 3, 5, 8, 1, 256, 127, [127, 84]),
        p128=(2, 3, 5, 8, 1, 256, 128, [128, 85]),
        p129=(2, 3, 5, 8, 1, 256, 129, [129, 86]),
        p383=(1, 5, 5, 8, 1, 256, 383, [383]),
        p384=(1, 5, 5, 8, 1, 256, 384, [384]),
        p385=(1, 5, 5, 8, 1, 256, 385, [385]),
        p1500=(1, 5, 5, 8, 1, 256, 1500, [1400]),
        p2000=(1, 5, 5, 8, 1, 256, 2000, [1900]),
        s1=(2, 9, 1, 8, 1, 256, 100, [100, 66]),
        s32=(2, 3, 32, 2, 1, 256, 100, [100, 66]),
        three_cands=(2, 7, 3, 8, 1, 256, 150, [150, 100]),
        g1_hkv2=(2, 6, 5, 2, 2, 256, 90, [90, 60]),
        d64=(2, 4, 5, 8, 1, 64, 130, [130, 86]),
        d72=(2, 4, 5, 8, 1, 72, 130, [130, 86]),
        d128=(2, 4, 5, 8, 1, 128, 130, [130, 86]),
        d256=(2, 4, 5, 8, 1, 256, 130, [130, 86]),
        d16=(2, 4, 5, 8, 1, 16, 130, [130, 86]),
        d16_rows129_p65=(2, 129, 1, 4, 1, 16, 65, [65, 40])).items()}
    # the verification-scaling experiment's decode (head dim 16, 4 query
    # heads over 1 KV head, P = 64 image + 8 prompt tokens, S = 5): its
    # phase-12 cohorts (16 episodes, N=16 K=1 and N=5 K=8) and its grid's
    # (10 episodes, N up to 80)
    k1_edges.update({f"vs_{tag}": shape for tag, shape in dict(
        n16=(16, 16, 5, 4, 1, 16, 72, [72, 70, 69]),
        n5_k8=(128, 5, 5, 4, 1, 16, 72, [72, 70, 69]),
        grid_n80=(10, 80, 5, 4, 1, 16, 72, [72, 69])).items()})
    k1_edges.update({f"{tag}_empty": (*shape, True) for tag, shape in
                     {**k1_main, **k1_edges}.items()})
    # per control step at E=16: so400m 27 layers, ViT-L 24, text 24
    k2_main = dict(so400m=((16, 256, 16, 72), 27),
                   vit_l16_384=((16, 576, 16, 64), 24),
                   text=((16, 64, 16, 64), 24))
    # the towers at the episode path's 4 lockstep episodes
    k2_cohort = {f"{tag}_cohort": (4, *shape[1:])
                 for tag, (shape, _) in k2_main.items()}
    k2_extra = dict(ragged_s300=(2, 300, 4, 64), ragged_s37=(3, 37, 2, 72))
    # one under, at and one over the 64-key tile, the 64-row warpgroup tile
    # and the 128-row block of the wgmma kernel; the ViT-L grid plus a
    # class token; the other padded head dims
    k2_edges = {f"edge_s{s}_d{d}": (2, s, 3, d)
                for s, d in ((1, 64), (63, 64), (64, 72), (65, 64), (127, 72),
                             (128, 64), (129, 72), (577, 64), (129, 16),
                             (65, 32), (130, 128), (193, 256))}
    # the experiment's towers at head dim 16: the policy's 64 image tokens,
    # the verifier's 256 patches and its 16 text tokens (16 episodes)
    k2_edges.update(vs_policy_vision=(16, 64, 4, 16),
                    vs_verifier_vision=(16, 256, 4, 16),
                    vs_text=(16, 16, 4, 16))

    # prefill of the bench's prompts (B = E*K = 16), of the 5x8 protocol
    # (B = 8) and of the episode path's cohort (B = 4*8 = 32): 328 prefix
    # tokens, 268 of them real
    k3_main = dict(bench=(16, 328, 328, 8, 1, 256, [268]),
                   protocol=(8, 328, 328, 8, 1, 256, [268]),
                   cohort=(32, 328, 328, 8, 1, 256, [268]))
    # leading_masked: windows of real keys under a causal mask, so one or
    # two whole 64-key tiles of masked keys come before a row's first
    # real key and the running maximum has to wipe what they collected
    k3_extra = dict(ragged=(2, 200, 200, 8, 2, 128, [163, 200]),
                    one_query=(3, 1, 77, 8, 1, 256, [77, 40, 1]),
                    d16=(2, 64, 64, 4, 1, 16, [56, 9]),
                    leading_masked=(3, 200, 200, 8, 2, 128,
                                    [(40, 163), (100, 200), (0, 200)], True),
                    leading_masked_d256=(2, 5, 328, 8, 1, 256,
                                         [(70, 268), (33, 328)], True))
    # the wgmma kernel's tile edges (64 keys, 128 rows = 16 positions of 8
    # heads): Sq and Skv one under, at and one over; `mixed_block*`: real
    # and padding positions inside one 16-position block (60 of 129 and 100
    # of 200 real), so a block holds attended and all-masked rows at once;
    # Skv not a multiple of 8 takes the byte-wise mask copy
    k3_edges = dict(edge_63=(2, 63, 63, 8, 1, 256, [63, 50]),
                    edge_64=(2, 64, 64, 8, 1, 256, [64, 17]),
                    edge_65=(2, 65, 65, 8, 1, 256, [65, 64]),
                    edge_127=(2, 127, 127, 8, 1, 256, [127, 1]),
                    edge_128=(2, 128, 128, 8, 1, 256, [128, 65]),
                    edge_129=(2, 129, 129, 8, 1, 256, [129, 128]),
                    mixed_block=(2, 129, 129, 8, 1, 256, [60, 129]),
                    mixed_block_causal=(2, 200, 200, 8, 2, 128,
                                        [(30, 100), (0, 155)], True),
                    sq17_skv130=(2, 17, 130, 8, 1, 256, [130, 66]),
                    g1_d72=(2, 77, 77, 3, 3, 72, [60, 77]),
                    # the experiment's prefill: 72 prefix tokens, head
                    # dim 16, 4 query heads over 1 KV head, at 16 and
                    # 16 x 8 prompts
                    vs_n16=(16, 72, 72, 4, 1, 16, [72, 70, 69]),
                    vs_n5_k8=(128, 72, 72, 4, 1, 16, [72, 70, 69]))

    results = {"shared_prefix_gqa": {}, "mha_dense": {}, "prefix_gqa": {}}
    designs = ca.kernel_designs
    for tag, shape in {**k1_main, **k1_extra, **k1_edges}.items():
        b, n, s, hq, hkv, d, p = shape[:7]
        plan = ca.decode_plan(b * hkv, n * s * (hq // hkv), p,
                              torch.cuda.get_device_properties(dev).multi_processor_count)
        results["shared_prefix_gqa"][tag] = check_and_time(
            torch, card, f"shared_prefix_gqa[{tag}] (split {plan.split}, "
            f"{plan.blocks} blocks, {plan.waves:.2f} waves)",
            designs["shared_prefix_gqa"], ca.shared_prefix_gqa,
            ca.shared_prefix_gqa_plain,
            lambda shape=shape: k1_inputs(torch, gen, dev, *shape),
            k1_work, lambda a: k1_library(torch, F, a),
            iters=10 if tag in k1_edges else 50)
    for tag, shape in {**{k: v[0] for k, v in k2_main.items()},
                       **k2_cohort, **k2_extra, **k2_edges}.items():
        results["mha_dense"][tag] = check_and_time(
            torch, card, f"mha_dense[{tag}]", designs["mha_dense"],
            ca.mha_dense, ca.mha_dense_plain,
            lambda shape=shape: k2_inputs(torch, gen, dev, *shape),
            k2_work, k2_lib, iters=20 if tag in k2_edges else 50)
    for tag, shape in {**k3_main, **k3_extra, **k3_edges}.items():
        results["prefix_gqa"][tag] = check_and_time(
            torch, card, f"prefix_gqa[{tag}]", designs["prefix_gqa"],
            ca.prefix_gqa, ca.prefix_gqa_plain,
            lambda shape=shape: k3_inputs(torch, gen, dev, *shape),
            k3_work, lambda a: k3_library(torch, F, a),
            iters=20 if tag in k3_edges else 50)
        if (tag in k3_main or tag in k3_edges
                or tag.startswith("leading_masked")):
            k3_fp32_check(torch, f"prefix_gqa[{tag}]", ca,
                          k3_inputs(torch, gen, dev, *shape),
                          separates=tag in k3_main)
        if tag in k3_main:
            # what the prefill runs without K3: the eager masked GQA
            args = [k3_inputs(torch, gen, dev, *shape) for _ in range(2)]
            log(f"kernel prefix_gqa[{tag}]: eager gqa_attention on the same "
                f"inputs {time_ms(torch, gqa_attention, args, 20):.4f} ms "
                f"| {card}")
    # main-path launches per control step at E=16, per shape
    per_step = {"shared_prefix_gqa": {"bench": 180},
                "mha_dense": {k: v[1] for k, v in k2_main.items()},
                "prefix_gqa": {"bench": 18}}
    return results, per_step, designs


# ---------------------------------------------------------------------------
# phases 3-4: the verified step
# ---------------------------------------------------------------------------


def episode_inputs(pcfg, vcfg, ccfg, e: int, seed: int):
    """bench.py-style episodes: random frames, 12 valid prompt tokens."""
    rng = np.random.default_rng(seed)
    k, t = ccfg.n_rephrases, pcfg.tokenizer_max_length
    raw = rng.integers(0, 255, (e, 256, 256, 3), dtype=np.uint8)
    proprio = rng.uniform(-0.1, 0.1, (e, 7)).astype(np.float32)
    lt = rng.integers(0, min(1000, pcfg.paligemma.vocab_size),
                      (e, k, t)).astype(np.int32)
    lm = np.zeros((e, k, t), bool)
    lm[:, :, :12] = True
    vt = rng.integers(0, min(1000, vcfg.text.vocab_size),
                      (e, vcfg.text.context_length)).astype(np.int32)
    hist = rng.uniform(-0.05, 0.05, (e, ccfg.max_history, 7)).astype(np.float32)
    hlen = np.full((e,), ccfg.max_history, np.int32)
    noise = rng.standard_normal(
        (e, k, ccfg.n_samples, pcfg.chunk_size, pcfg.max_action_dim)
    ).astype(np.float32) * ccfg.noise_std
    return (raw, proprio, lt, lm, vt, hist, hlen), noise


def check_result(torch, res, e, k, n, chunk):
    assert res.exec_chunk.shape == (e, chunk, 7), res.exec_chunk.shape
    assert res.verifier_chunk.shape == (e, chunk, 7)
    assert res.scores.shape == (e, k * n)
    for name in ("exec_chunk", "verifier_chunk", "scores", "max_score",
                 "raw_gripper"):
        assert torch.isfinite(getattr(res, name)).all(), name
    w = res.winner_idx
    assert ((w >= 0) & (w < k * n)).all()
    assert torch.equal(res.winner_group, w // n)
    assert set(res.exec_chunk[..., 6].unique().tolist()) <= {-1.0, 1.0}
    assert set(res.verifier_chunk[..., 6].unique().tolist()) <= {0.0, 1.0}


def recording_env_class():
    """FakeWidowXEnv that keeps the actions it was stepped with."""
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv

    class RecordingEnv(FakeWidowXEnv):
        def reset(self, seed=None):
            self.actions = []
            return super().reset(seed=seed)

        def step(self, action):
            self.actions.append(np.array(action, np.float64))
            return super().step(action)
    return RecordingEnv


def small_reference_phase(torch, dev):
    """Tiny configs, fp32 weights, eager path: card vs CPU."""
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, tiny_pi0_config, tiny_verifier_config)
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched)
    from cover_vla_tpu_torch.models import pi0, verifier
    from cover_vla_tpu_torch.models.params import ParamTree

    RecordingEnv = recording_env_class()
    pcfg, vcfg = tiny_pi0_config(), tiny_verifier_config()
    ccfg = CoVerConfig(n_samples=2, n_rephrases=2)
    stats = DatasetStatistics.from_json()

    def fp32(tree, device):
        return {k: fp32(tree[k], device) if isinstance(tree[k], ParamTree)
                else tree[k].detach().float().to(device) for k in tree}

    pp = pi0.init_pi0(0, pcfg, device="cpu")
    vp = verifier.init_verifier(1, vcfg, 2, device="cpu")
    inputs, noise = episode_inputs(pcfg, vcfg, ccfg, 2, seed=1)
    out = {}
    for d in ("cpu", dev):
        step = make_verified_step_batched(pcfg, vcfg, ccfg, stats, device=d)
        out[str(d)] = step(ParamTree(fp32(pp, d)), ParamTree(fp32(vp, d)),
                           *inputs, noise=noise)
    cpu, card = out["cpu"], out[str(dev)]
    for name in ("winner_idx", "winner_group", "used_stage2", "deferred"):
        assert torch.equal(getattr(cpu, name), getattr(card, name).cpu()), name
    dev_max = max((getattr(card, name).cpu() - getattr(cpu, name)).abs().max().item()
                  for name in ("exec_chunk", "verifier_chunk", "scores"))
    assert dev_max <= 1e-4, dev_max
    log(f"small reference: card vs CPU, tiny fp32 eager step, "
        f"max float deviation {dev_max:.3e} (bound 1e-4), discrete outputs equal")

    # the same for a lockstep evaluation: 2 fake-env episodes, 8 ticks,
    # the same noise handed to both devices' step functions
    from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
    from cover_vla_tpu_torch.engine import BatchedCoVerEngine, evaluate_batched
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    from cover_vla_tpu_torch.eval.rephrase import load_rephrases

    ticks = 8
    noises = np.random.default_rng(2).standard_normal(
        (ticks // pcfg.chunk_size, 2, 2, 2, pcfg.chunk_size,
         pcfg.max_action_dim)).astype(np.float32)
    runs = {}
    for d in ("cpu", dev):
        step = make_verified_step_batched(pcfg, vcfg, ccfg, stats, device=d)
        it = iter(noises)
        engine = BatchedCoVerEngine(
            ParamTree(fp32(pp, d)), ParamTree(fp32(vp, d)), pcfg, vcfg, ccfg,
            num_episodes=2, stats=stats, rephrases=load_rephrases(),
            policy_tokenizer=HashTokenizer(pcfg.paligemma.vocab_size),
            verifier_tokenizer=HashTokenizer(vcfg.text.vocab_size,
                                             add_bos=False),
            device=d,
            step_fn=lambda *a, generator=None, _s=step, _it=it: _s(
                *a, noise=next(_it)))
        envs = [RecordingEnv("widowx_carrot_on_plate", max_steps=ticks)
                for _ in range(2)]
        out = evaluate_batched(engine, envs, BridgeSimplerAdapter(stats=stats),
                               max_steps=ticks, seeds=[0, 1])
        runs[str(d)] = (out, np.stack([np.stack(e.actions) for e in envs]))
    (out_c, act_c), (out_g, act_g) = runs["cpu"], runs[str(dev)]
    for key in ("success", "steps", "selected_instructions"):
        assert out_c[key] == out_g[key], (key, out_c[key], out_g[key])
    ev_dev = float(np.abs(act_c - act_g).max())
    assert act_g.shape == (2, ticks, 7) and ev_dev <= 1e-4, ev_dev
    log(f"small reference: card vs CPU, evaluate_batched over the fake env "
        f"(2 episodes x {ticks} ticks), max action deviation {ev_dev:.3e} "
        f"(bound 1e-4), success/steps/selected_instructions equal")


def profile_step(torch, card, cell, run, label="fast"):
    """Device busy time of one step (union of the device intervals of its
    kernels and copies, from torch.profiler) against its wall time, the
    device time of its GEMMs (cuBLAS/cuBLASLt kernels, bf16 and int8), and
    the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us, end_us, by_name = 0.0, -math.inf, {}
    for e in sorted(events, key=lambda e: e.time_range.start):
        start, stop = e.time_range.start, e.time_range.end
        busy_us += max(0.0, stop - max(start, end_us))
        end_us = max(end_us, stop)
        total, count = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (total + stop - start, count + 1)
    gemm = [(t, c) for name, (t, c) in by_name.items()
            if re.search(r"gemm|nvjet|cutlass|xmma|s8s8|imma", name, re.I)]
    gemm_ms = sum(t for t, _ in gemm) / 1e3
    log(f"profile {cell} {label}: wall {wall_ms:.2f} ms, device busy "
        f"{busy_us / 1e3:.2f} ms (idle share {1 - busy_us / 1e3 / wall_ms:.3f}), "
        f"{len(events)} device ops, GEMMs {gemm_ms:.3f} ms in "
        f"{sum(c for _, c in gemm)} launches | {card}")
    for name, (t_us, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  {t_us / 1e3:9.3f} ms  {count:6d}x  {name[:90]}")
    nccl = [(t, c) for name, (t, c) in by_name.items()
            if re.search(r"nccl", name, re.I)]
    return dict(wall_ms=wall_ms, busy_ms=busy_us / 1e3, ops=len(events),
                gemm_ms=gemm_ms, nccl_ms=sum(t for t, _ in nccl) / 1e3,
                nccl_launches=sum(c for _, c in nccl))


def init_full_width(torch, dev, pcfg, vcfg):
    from cover_vla_tpu_torch.models import pi0, verifier
    t0 = time.perf_counter()
    pp = pi0.init_pi0(0, pcfg, device=dev)
    vp = verifier.init_verifier(1, vcfg, num_members=3, device=dev)
    torch.cuda.synchronize()
    n_params = (sum(p.numel() for p in pp.parameters()),
                sum(p.numel() for p in vp.parameters()))
    log(f"full width: random weights, policy {n_params[0] / 1e9:.3f}B + "
        f"verifier {n_params[1] / 1e9:.3f}B params, init "
        f"{time.perf_counter() - t0:.1f}s")
    return pp, vp


def kernel_configs(pcfg, vcfg):
    """{name: (Pi0Config, VerifierConfig)}: fast (decode and tower
    kernels), all_kernel (the prefill kernel too), eager."""
    from cover_vla_tpu_torch.configs import (
        fast_pi0_config, fast_verifier_config, replace)
    fast_v = fast_verifier_config(vcfg)
    return {"fast": (fast_pi0_config(pcfg), fast_v),
            "all_kernel": (replace(fast_pi0_config(pcfg),
                                   attention_impl="cuda"), fast_v),
            "eager": (pcfg, vcfg)}


def launches_per_step(pcfg, vcfg):
    """Kernel launches of one verified step under the all-kernel configs:
    K1 once per expert layer per Euler step, K2 once per layer of the
    three towers, K3 once per prefill layer (180, 75 and 18 at full
    width)."""
    return {"shared_prefix_gqa": pcfg.expert.depth * pcfg.num_denoise_steps,
            "mha_dense": (pcfg.vision.depth + vcfg.vision.depth
                          + vcfg.text.depth),
            "prefix_gqa": pcfg.paligemma.depth}


def compare_with_eager(torch, name, f, fc, x, xc):
    """A kernel config's step result `f` and candidates `fc` against the
    eager config's `x`, `xc`.

    Every one of the K*N candidates of every episode must agree (the
    policy half, independent of which candidate is picked) and the scores
    must agree within SCORE_ATOL. With random weights the candidates'
    scores lie close together (eager top-2 gaps down to 1e-4 against score
    deviations of 1e-2 between the configs), so a pick may differ, but only
    between candidates whose eager scores lie within the fixed SCORE_ATOL
    of each other; executed chunks must agree wherever the picks do. (The
    fast config was once held to eager's winner on every episode; that
    rested on one E=16 episode whose eager top-2 gap is 2.1e-3, and the
    decode kernel's rounding order moves its pick across it.)"""
    cand_dev = (fc.exec_chunks[..., :6] - xc.exec_chunks[..., :6]
                ).abs().max().item()
    grip_dev = (fc.raw_grippers - xc.raw_grippers).abs().max().item()
    score_dev = (f.scores - x.scores).abs().max().item()
    same = f.winner_idx == x.winner_idx
    agree = same.float().mean().item()
    if cand_dev > FAST_ATOL or grip_dev > 2 * FAST_ATOL:
        raise AssertionError(f"{name}: candidates deviate {cand_dev} "
                             f"(raw gripper {grip_dev}) from eager")
    if score_dev > SCORE_ATOL:
        raise AssertionError(f"{name}: scores deviate {score_dev} from eager "
                             f"(bound {SCORE_ATOL})")
    rows = torch.arange(len(same), device=same.device)
    gap = (x.scores[rows, x.winner_idx.long()]
           - x.scores[rows, f.winner_idx.long()])[~same]
    if (gap.abs() > SCORE_ATOL).any():
        raise AssertionError(f"{name}: picks differ from eager across score "
                             f"gaps {gap.tolist()} (bound {SCORE_ATOL})")
    torch.testing.assert_close(f.exec_chunk[same], x.exec_chunk[same],
                               rtol=FAST_RTOL, atol=FAST_ATOL)
    act_dev = ((f.exec_chunk[same] - x.exec_chunk[same]).abs().max().item()
               if same.any() else 0.0)
    log(f"{name} vs eager: all candidates max |action| dev {cand_dev:.3e}, "
        f"raw gripper dev {grip_dev:.3e}, max |score| dev {score_dev:.3e} "
        f"(bound {SCORE_ATOL}), winner agreement {agree:.3f} ({len(same)} "
        f"episodes; eager score gaps of the differing picks "
        f"{[f'{g:.1e}' for g in gap.tolist()]}), executed chunks of the "
        f"agreeing episodes dev {act_dev:.3e}")


def main_path_phase(torch, card, dev, pcfg, vcfg, pp, vp, cells):
    """Drive make_verified_step_batched for each cell {name: (E, CoVerConfig)}
    under the fast, all-kernel and eager configs. Returns the launch counts
    of the first cell's counted all-kernel step."""
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import (
        make_propose_step_batched, make_verified_step_batched)
    from cover_vla_tpu_torch.ops import cuda_attention as ca

    expected = {"all_kernel": launches_per_step(pcfg, vcfg)}
    expected["fast"] = {**expected["all_kernel"], "prefix_gqa": 0}
    stats = DatasetStatistics.from_json()
    attn = kernel_configs(pcfg, vcfg)
    launches = None
    first_cell = next(iter(cells))
    for cell, (e, ccfg) in cells.items():
        inputs, noise_np = episode_inputs(pcfg, vcfg, ccfg, e, seed=0)
        noise = torch.from_numpy(noise_np).to(dev)
        steps = {a: make_verified_step_batched(pc, vc, ccfg, stats, device=dev)
                 for a, (pc, vc) in attn.items()}
        # one counted run of the step per cell and kernel config
        res = {}
        for a in ("fast", "all_kernel"):
            ca.reset_launch_counts()
            res[a] = steps[a](pp, vp, *inputs, noise=noise)
            torch.cuda.synchronize()
            counts = dict(ca.launch_counts)
            if counts != expected[a]:
                raise AssertionError(f"{cell} {a}: launch counts {counts}, "
                                     f"expected {expected[a]} per step")
        if launches is None:
            launches = counts
        res["eager"] = steps["eager"](pp, vp, *inputs, noise=noise)
        torch.cuda.synchronize()
        for r in res.values():
            check_result(torch, r, e, ccfg.n_rephrases, ccfg.n_samples,
                         pcfg.chunk_size)
        raw, proprio, lt, lm, _, hist, hlen = inputs
        cands = {a: make_propose_step_batched(pc, vc, ccfg, stats, device=dev)(
            pp, raw, proprio, lt, lm, hist, hlen, noise=noise)
            for a, (pc, vc) in attn.items()}
        x, xc = res["eager"], cands["eager"]
        for a in ("fast", "all_kernel"):
            compare_with_eager(torch, f"{cell}: launches {expected[a]}; {a}",
                               res[a], cands[a], x, xc)
        if cell == first_cell:
            profile_step(torch, card, cell, lambda: steps["fast"](
                pp, vp, *inputs, noise=noise))
        times = {a: [] for a in steps}
        for _ in range(STEP_REPEATS):       # the three configs in turns
            for a, step in steps.items():
                t0 = time.perf_counter()
                step(pp, vp, *inputs, noise=noise)
                torch.cuda.synchronize()
                times[a].append(time.perf_counter() - t0)
        for a in steps:
            p50 = float(np.median(times[a]))
            log(f"step {cell} {a}: p50 {p50 * 1e3:.2f} ms "
                f"(min {min(times[a]) * 1e3:.2f}), verified actions/s "
                f"{e * pcfg.chunk_size / p50:.2f}, peak mem "
                f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | {card}")
    return launches


def verifier_scores(torch, dev, vcfg, vparams, raw, vtoks, traj):
    """The fused step's stage 6 alone: [E, C] scores of trajectories
    [E, C, T, 7] under the instruction tokens, for raw frames [E, H, W, 3]."""
    from cover_vla_tpu_torch.engine.verified_step import _verifier_image
    from cover_vla_tpu_torch.models import verifier
    with torch.no_grad():
        vimg = _verifier_image(torch.as_tensor(raw, device=dev),
                               vcfg.vision.image_size)
        feats = verifier.extract_features(
            vparams, vcfg, vimg, torch.as_tensor(vtoks, device=dev).long())
        fused_it, fused_ac = verifier.ensemble_embed(
            vparams, vcfg, feats, traj.reshape(-1, *traj.shape[2:]))
        return torch.einsum("ed,ecd->ec", fused_it, fused_ac.reshape(
            traj.shape[0], traj.shape[1], -1))


def episode_phase(torch, card, dev, pcfg, vcfg, pp, vp):
    """Closed-loop evaluation at full width under the all-kernel configs:
    the reference 5x8 protocol over the fake environment, 12 ticks = 3
    verified steps per episode."""
    from cover_vla_tpu_torch.configs import CoVerConfig, replace
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
    from cover_vla_tpu_torch.engine import BatchedCoVerEngine, CoVerEngine
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    from cover_vla_tpu_torch.eval.evaluator import (
        CoVerEvaluator, EvalConfig, evaluate_suite_batched)
    from cover_vla_tpu_torch.eval.fake_env import get_image_from_obs_dict
    from cover_vla_tpu_torch.eval.rephrase import load_rephrases
    from cover_vla_tpu_torch.ops import cuda_attention as ca

    RecordingEnv = recording_env_class()
    pc, vc = kernel_configs(pcfg, vcfg)["all_kernel"]
    ccfg = CoVerConfig(n_samples=5, n_rephrases=8)
    stats = DatasetStatistics.from_json()
    rephrases = load_rephrases()
    per_step = launches_per_step(pcfg, vcfg)
    chunk, n_par, ticks = pcfg.chunk_size, 4, 12
    task = "widowx_carrot_on_plate"
    toks = dict(policy_tokenizer=HashTokenizer(pcfg.paligemma.vocab_size),
                verifier_tokenizer=HashTokenizer(vcfg.text.vocab_size,
                                                 add_bos=False))

    def counted(name, verified_steps, fn):
        """Run fn with the launch counts reset; check them against
        `verified_steps` steps of the all-kernel path."""
        ca.reset_launch_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ca.launch_counts)
        want = {k: v * verified_steps for k, v in per_step.items()}
        if counts != want:
            raise AssertionError(f"{name}: launch counts {counts}, expected "
                                 f"{want} ({verified_steps} verified steps)")
        return out, wall, counts

    def check_actions(name, envs, n_ticks):
        acts = np.stack([np.stack(env.actions) for env in envs])
        assert acts.shape == (len(envs), n_ticks, 7), (name, acts.shape)
        assert np.isfinite(acts).all(), name
        assert set(np.unique(acts[..., 6])) <= {-1.0, 1.0}, name

    def report(name, wall, n_ticks, n_actions, counts):
        log(f"episodes {name}: wall {wall:.2f} s, {n_ticks / wall:.2f} "
            f"ticks/s, {n_actions / wall:.2f} verified actions/s, launches "
            f"{counts} | {card}")

    # (a) suite evaluation, one cohort of 4 lockstep episodes --------------
    def run_suite(trials, pipelined):
        envs = []

        def env_fn(t):
            envs.append(RecordingEnv(t))
            return envs[-1]
        cfg = EvalConfig(task_suite="simpler_carrot_on_plate",
                         num_trials_per_task=trials, max_steps=ticks)
        out = evaluate_suite_batched(
            pp, vp, pc, vc, ccfg, cfg, n_parallel=n_par, env_fn=env_fn,
            stats=stats, rephrases=rephrases, pipelined=pipelined, seed=0,
            device=dev, **toks)
        return out, envs

    for name, trials, pipelined in (("batched", n_par, False),
                                    ("pipelined", 2 * n_par, True)):
        cohorts = trials // n_par
        (out, envs), wall, counts = counted(
            name, cohorts * ticks // chunk,
            lambda: run_suite(trials, pipelined))
        summary = out["summary"]
        per_task = summary["per_task"][task]
        assert summary["total_episodes"] == per_task["episodes"] == trials
        assert 0.0 <= summary["overall_success_rate"] <= 1.0
        assert [ep["num_steps"] for ep in per_task["per_episode"]] == \
            [ticks] * trials
        assert all(len(ep["selected_instructions"]) == ticks // chunk
                   for ep in per_task["per_episode"])
        check_actions(name, envs, ticks)
        report(f"{name} ({trials} episodes, {cohorts} cohort(s) of {n_par})",
               wall, cohorts * ticks, trials * ticks, counts)
        if not pipelined:
            first = per_task["per_episode"]
        else:
            # cohort A shares its engine seed and env seeds with (a)
            same = [a["selected_instructions"] == b["selected_instructions"]
                    for a, b in zip(first, per_task["per_episode"])]
            log(f"episodes pipelined: cohort A repeats the batched run's "
                f"selected instructions in {sum(same)}/{len(same)} episodes")

    # (b) one episode through CoVerEvaluator / CoVerEngine ------------------
    engine = CoVerEngine(pp, vp, pc, vc, ccfg, stats=stats,
                         rephrases=rephrases, seed=0, device=dev, **toks)
    envs = []

    def env_fn(t):
        envs.append(RecordingEnv(t))
        return envs[-1]
    evaluator = CoVerEvaluator(
        engine, EvalConfig(task_suite="simpler_carrot_on_plate",
                           num_trials_per_task=1, max_steps=ticks),
        env_fn=env_fn, stats=stats)
    out, wall, counts = counted("single", ticks // chunk, evaluator.evaluate)
    ep = out["episodes"][0]
    assert out["summary"]["total_episodes"] == 1 and ep.num_steps == ticks
    assert len(ep.verifier_scores) == ticks // chunk
    assert np.isfinite(ep.verifier_scores).all()
    check_actions("single", envs, ticks)
    report("single (CoVerEvaluator, 1 episode)", wall, ticks, ticks, counts)

    # (c) injected-score selection with the verifier's own scores must
    # execute the fused step's chunk; and how long step_async holds the
    # host before it returns ------------------------------------------------
    envs = [RecordingEnv(task) for _ in range(n_par)]
    obs = [env.reset(seed=i)[0] for i, env in enumerate(envs)]
    tasks = [env.get_language_instruction() for env in envs]
    adapter = BridgeSimplerAdapter(stats=stats)
    imgs = np.stack([get_image_from_obs_dict(env, o)
                     for env, o in zip(envs, obs)])
    props = np.stack([adapter.preprocess_proprio({"agent": o["agent"]})
                      for o in obs]).astype(np.float32)

    def make_engine(selection, score_fn=None):
        eng = BatchedCoVerEngine(
            pp, vp, pc, vc, replace(ccfg, selection=selection),
            num_episodes=n_par, stats=stats, rephrases=rephrases, seed=3,
            score_fn=score_fn, device=dev, **toks)
        eng.reset(tasks)
        return eng

    vtoks, _ = toks["verifier_tokenizer"].encode_batch(
        tasks, vc.text.context_length)

    def injected_scores(exec_chunks, proposal):
        """The fused step's stage 6: scores of all candidates under the
        current instruction, [E, K*N]."""
        return verifier_scores(torch, dev, vc, vp, imgs, vtoks,
                               proposal.trajectories).cpu().numpy()

    fused = make_engine("verifier")
    t0 = time.perf_counter()
    resolve = fused.step_async(imgs, props)
    t1 = time.perf_counter()
    first_action = resolve()
    t2 = time.perf_counter()
    log(f"episodes step_async (E={n_par}, 5x8): returned after "
        f"{(t1 - t0) * 1e3:.2f} ms of host work, resolver waited "
        f"{(t2 - t1) * 1e3:.2f} ms | {card}")
    chunks = {"fused": [first_action] + [fused.step(imgs, props)
                                         for _ in range(chunk - 1)]}
    injected = make_engine("injected", injected_scores)
    (acts, wall, counts) = counted(
        "injected", 1,
        lambda: [injected.step(imgs, props) for _ in range(chunk)])
    chunks["injected"] = acts
    inj_dev = float(np.abs(np.stack(chunks["injected"])
                           - np.stack(chunks["fused"])).max())
    assert injected.selected_instructions == fused.selected_instructions
    assert inj_dev <= 1e-6, inj_dev
    log(f"episodes injected: propose + verifier scores + select executes the "
        f"fused step's chunk (max deviation {inj_dev:.1e}, E={n_par}), "
        f"launches {counts}")


# ---------------------------------------------------------------------------
# phase 6: serving (int8 w8a8, pi0-FAST, the policy wrappers, the server)
# ---------------------------------------------------------------------------

# the JAX package's own int8-vs-bf16 bounds (tests/test_quant.py:97, :132):
# max |d action| / RMS(bf16 actions), max |d score| / bf16 score span
INT8_ACTION_REL = 0.15
INT8_SCORE_REL = 0.25
INT8_TOPS = 1979e12           # H100 SXM dense int8 tensor cores


# the cells' shapes of the w8a8 route's glue: (tag, rows, K or N, bias):
# the 5x8 prefill (256 prompts x 328 tokens), the N=80 Euler steps (64 x 80
# candidates x 5 tokens), so400m over 64 images (x 256 patches) and ViT-L
# over 64 frames (x 576 patches), the towers' with their bias
QUANT_SHAPES = (("prefill", 83968, 2048, False), ("prefill", 83968, 16384, False),
                ("euler", 25600, 1024, False), ("euler", 25600, 4096, False),
                ("so400m", 16384, 1152, True), ("so400m", 16384, 4304, True),
                ("vit_l", 36864, 1024, True), ("vit_l", 36864, 4096, True))


def quant_kernels(torch, card, dev):
    """csrc/quant.cu's act_quant and rescale at the cells' shapes: bit-equal
    to their plain twins run on the same card tensors (bf16 in and out, the
    rescale with the towers' bias), one launch a call, timed in a stream and
    in a graph beside their bound and the twin's time in a stream."""
    from cover_vla_tpu_torch.ops import quant
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(18)
    out = {}
    for tag, m, k, with_bias in QUANT_SHAPES:
        x = torch.randn((m, k), generator=gen, device=dev).to(bf) * 3
        quant.reset_launch_counts()
        xq, xs = quant.quant_act(x)
        if quant.launch_counts != {"act_quant": 1, "rescale": 0}:
            raise AssertionError(f"act_quant {m}x{k}: {quant.launch_counts}")
        pq, ps = quant.quant_act_plain(x)
        if not (torch.equal(xq, pq) and torch.equal(xs, ps)):
            raise AssertionError(f"act_quant {m}x{k}: kernel != plain twin")
        del pq, ps
        # accumulators past 2^24, where the int -> float conversion rounds
        acc = torch.randint(-2 ** 26, 2 ** 26, (m, k), generator=gen,
                            device=dev, dtype=torch.int32)
        ws = torch.rand((1, k), generator=gen, device=dev) * 1e-3
        bias = (torch.randn(k, generator=gen, device=dev).to(bf)
                if with_bias else None)
        got = quant.rescale(acc, xs, ws, bf, bias)
        if quant.launch_counts["rescale"] != 1:
            raise AssertionError(f"rescale {m}x{k}: {quant.launch_counts}")
        if not torch.equal(got, quant.rescale_plain(acc, xs, ws, bf, bias)):
            raise AssertionError(f"rescale {m}x{k}: kernel != plain twin")
        del got
        q_bytes = m * k * (2 + 1) + m * 4
        r_bytes = m * k * (4 + 2) + m * 4 + k * 4 + (k * 2 if with_bias else 0)
        launches = 20 if m * k < 1e8 else 5
        t = dict(
            act_quant=time_ms(torch, quant.quant_act, [(x,)], launches),
            act_quant_graph=graph_ms(torch, quant.quant_act, [(x,)], launches),
            act_quant_plain=time_ms(torch, quant.quant_act_plain, [(x,)], 3),
            act_quant_bound=q_bytes / HBM_BYTES_PER_S * 1e3,
            rescale=time_ms(torch, quant.rescale, [(acc, xs, ws, bf, bias)],
                            launches),
            rescale_graph=graph_ms(torch, quant.rescale,
                                   [(acc, xs, ws, bf, bias)], launches),
            rescale_plain=time_ms(torch, quant.rescale_plain,
                                  [(acc, xs, ws, bf, bias)], 3),
            rescale_bound=r_bytes / HBM_BYTES_PER_S * 1e3)
        out[f"{tag} {m}x{k}"] = t
        log(f"quant kernels {tag} {m}x{k}{' +bias' if with_bias else ''}: "
            f"bit-equal to the twins; act_quant {t['act_quant']:.4f} ms "
            f"stream / {t['act_quant_graph']:.4f} ms graph, bound "
            f"{t['act_quant_bound']:.4f} ms "
            f"({100 * t['act_quant_bound'] / t['act_quant_graph']:.1f}%), "
            f"eager twin {t['act_quant_plain']:.4f} ms; rescale "
            f"{t['rescale']:.4f} / {t['rescale_graph']:.4f} ms, bound "
            f"{t['rescale_bound']:.4f} ms "
            f"({100 * t['rescale_bound'] / t['rescale_graph']:.1f}%), eager "
            f"twin {t['rescale_plain']:.4f} ms | {card}")
        del x, xq, xs, acc, ws, bias
        torch.cuda.empty_cache()
    # the host's side: microseconds to enqueue one call at a decode shape
    x = torch.randn((200, 2048), generator=gen, device=dev).to(bf)
    xq, xs = quant.quant_act(x)
    acc = torch.randint(-2 ** 20, 2 ** 20, (200, 2048), generator=gen,
                        device=dev, dtype=torch.int32)
    ws = torch.rand((1, 2048), generator=gen, device=dev)
    host = {name: host_enqueue_us(torch, fn, args) for name, fn, args in (
        ("act_quant", quant.quant_act, (x,)),
        ("act_quant_plain", quant.quant_act_plain, (x,)),
        ("rescale", quant.rescale, (acc, xs, ws)),
        ("rescale_plain", quant.rescale_plain, (acc, xs, ws)))}
    out["host_us_200x2048"] = host
    log(f"quant kernels, host us to enqueue a 200x2048 call: "
        + ", ".join(f"{k} {v:.1f}" for k, v in host.items()))
    log(json.dumps({"quant_kernels": out}))
    return out


def int8_exactness(torch, card, dev, pp, vp):
    """The int8 route card vs CPU: grids bit-equal, `_int_mm`'s int32
    accumulators equal to the exact CPU product at the main path's shapes
    and at the padded row counts; the quant and rescale kernels against
    their plain twins at the cells' shapes (`quant_kernels`); `_int_mm`
    timed against the bf16 GEMM of the same shape, for both weight
    layouts."""
    from cover_vla_tpu_torch.ops import quant
    bf = torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(6)
    pg, ex = pp["paligemma"]["layers"], pp["expert"]["layers"]
    fc1 = vp["backbone"]["vision"]["blocks"]["mlp"]["fc1"]["kernel"]
    for name, w in (("paligemma q[0] 2048x2048", pg["q"][0]),
                    ("ViT-L fc1[0] 1024x4096", fc1[0])):
        q_card, s_card = quant.quantize_weight(w)
        q_cpu, s_cpu = quant.quantize_weight(w.cpu())
        if not (torch.equal(q_card.cpu(), q_cpu)
                and torch.equal(s_card.cpu(), s_cpu)):
            raise AssertionError(f"int8 grid of {name}: card != CPU")
    x = torch.randn((5248, 2048), generator=gen, device=dev).to(bf) * 3
    xq, xs = quant.quant_act(x)
    xq_cpu, xs_cpu = quant.quant_act(x.cpu())
    if not (torch.equal(xq.cpu(), xq_cpu) and torch.equal(xs.cpu(), xs_cpu)):
        raise AssertionError("activation quant: card != CPU")
    log("int8 grids: paligemma q[0], ViT-L fc1[0] and a 5248x2048 bf16 "
        "activation quantized on the card (the act_quant kernel) and on the "
        "CPU: int8 tensors and fp32 scales bit-equal")
    kernels = quant_kernels(torch, card, dev)

    weights = {"pg_q": quant.quantize_weight(pg["q"][0]),
               "ex_gate": quant.quantize_weight(ex["gate"][0]),
               "ex_down": quant.quantize_weight(ex["down"][0])}
    # rows: E16's prefill (16 x 328) and decode (16 x 16 x 5) rows, and
    # row counts under, at and over _int_mm's minimum of 17
    acc_shapes = [("prefill E16", 5248, "pg_q"), ("expert gate E16", 1280,
                                                  "ex_gate"),
                  ("expert down E16", 1280, "ex_down")] + [
        (f"M={m}", m, "pg_q") for m in (1, 8, 16, 17)]
    for tag, m, wname in acc_shapes:
        wq, _ = weights[wname]
        a = torch.randn((m, wq.shape[0]), generator=gen, device=dev).to(bf)
        aq, _ = quant.quant_act(a)
        quant.reset_int_mm_calls()
        got = quant.int8_accumulate(aq, wq)
        if quant.int_mm_calls["int_mm"] != 1:
            raise AssertionError(f"{tag}: _int_mm was not called")
        ref = quant.int8_accumulate(aq.cpu(), wq.cpu())
        if not torch.equal(got.cpu(), ref):
            raise AssertionError(f"int8 accumulators {tag}: card != CPU "
                                 f"(max diff {(got.cpu() - ref).abs().max()})")
    log(f"int8 accumulators: _int_mm (cuBLASLt, int32) equals the exact CPU "
        f"product at {', '.join(f'{t} ({m}x{weights[w][0].shape[0]}x'f'{weights[w][0].shape[1]})' for t, m, w in acc_shapes)}")

    # (m, k, n): E16 prefill q and gate, E16 decode gate/down, ViT-L fc1 at
    # E16 (16 x 576 rows), the 5x8 protocol's decode gate (8 x 5 x 5 rows)
    timing = dict(prefill_q=(5248, 2048, 2048), prefill_gate=(5248, 2048, 16384),
                  expert_gate=(1280, 1024, 4096), expert_down=(1280, 4096, 1024),
                  vit_l_fc1=(9216, 1024, 4096), protocol_expert_gate=(200, 1024, 4096))
    out = {}
    for tag, (m, k, n) in timing.items():
        a8 = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                           dtype=torch.int8)
        b_col = torch.randint(-127, 128, (n, k), generator=gen, device=dev,
                              dtype=torch.int8).t()
        b_row = b_col.contiguous()
        abf = torch.randn((m, k), generator=gen, device=dev).to(bf)
        wbf = torch.randn((k, n), generator=gen, device=dev).to(bf)
        wq, ws = quant.quantize_weight(wbf)
        launches = 20 if m * n < 2e7 else 5
        col = graph_ms(torch, torch._int_mm, [(a8, b_col)], launches)
        row = graph_ms(torch, torch._int_mm, [(a8, b_row)], launches)
        mm = graph_ms(torch, torch.matmul, [(abf, wbf)], launches)
        w8a8 = graph_ms(torch, lambda x: quant.int8_matmul(
            *quant.quant_act(x), wq, ws), [(abf,)], launches)
        ops = 2.0 * m * k * n
        bound8 = max((m * k + k * n + 4 * m * n) / HBM_BYTES_PER_S,
                     ops / INT8_TOPS) * 1e3
        bound16 = max(2 * (m * k + k * n + m * n) / HBM_BYTES_PER_S,
                      ops / BF16_FLOPS) * 1e3
        out[tag] = dict(int_mm_col=col, int_mm_row=row, bf16=mm, w8a8=w8a8)
        log(f"int8 GEMM {tag} {m}x{k}x{n} (in a graph): _int_mm column-major "
            f"B {col:.4f} ms, row-major B {row:.4f} ms, bf16 matmul "
            f"{mm:.4f} ms, whole w8a8 product (activation quant + _int_mm + "
            f"rescale) {w8a8:.4f} ms; bounds int8 {bound8:.4f} / bf16 "
            f"{bound16:.4f} ms | {card}")
    return out, kernels


def normalized_actions(torch, cands, stats):
    """The policy's normalised outputs [..., 7] recovered from a
    ProposeResult (the verifier-format body inverts the bound
    denormalisation; the gripper is its raw output)."""
    dev = cands.verifier_chunks.device
    p01 = torch.as_tensor(stats.action.p01[:6], dtype=torch.float32, device=dev)
    p99 = torch.as_tensor(stats.action.p99[:6], dtype=torch.float32, device=dev)
    body = 2 * (cands.verifier_chunks[..., :6] - p01) / (p99 - p01) - 1
    return torch.cat([body, cands.raw_grippers], dim=-1)


def int8_step_phase(torch, card, dev, pcfg, vcfg, pp, vp, cells):
    """The int8_full verified step (w8a8 policy and verifier backbone) at
    full width under the fast and all-kernel configs, in turns with bf16
    fast: launch counts, every candidate and score against bf16 fast
    within the JAX package's int8 bounds, step times and a profile."""
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import (
        make_propose_step_batched, make_verified_step_batched)
    from unittest import mock

    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.ops import quant

    t0 = time.perf_counter()
    qpp, qvp = quant.quantize_pi0_policy(pp), quant.quantize_verifier(vp)
    torch.cuda.synchronize()
    int8_gb = sum(p.numel() for p in (*qpp.parameters(), *qvp.parameters())
                  if p.dtype == torch.int8) / 1e9
    log(f"int8_full: quantize_pi0_policy + quantize_verifier {time.perf_counter() - t0:.1f}s, "
        f"{int8_gb:.3f} GB of int8 weights")
    stats = DatasetStatistics.from_json()
    attn = kernel_configs(pcfg, vcfg)
    expected = {"all_kernel": launches_per_step(pcfg, vcfg)}
    expected["fast"] = {**expected["all_kernel"], "prefix_gqa": 0}
    # w8a8 products a step: 7 a Gemma layer pass, 6 a ViT layer
    gemma_passes = (pcfg.paligemma.depth
                    + pcfg.expert.depth * pcfg.num_denoise_steps)
    vit_blocks = pcfg.vision.depth + vcfg.vision.depth
    int_mm_per_step = 7 * gemma_passes + 6 * vit_blocks
    # one act_quant a quantized input (4 a Gemma layer pass or ViT block),
    # one rescale a product
    quant_per_step = {"act_quant": 4 * (gemma_passes + vit_blocks),
                      "rescale": int_mm_per_step}
    first_cell = next(iter(cells))
    profiles = {}
    for cell, (e, ccfg) in cells.items():
        inputs, noise_np = episode_inputs(pcfg, vcfg, ccfg, e, seed=0)
        noise = torch.from_numpy(noise_np).to(dev)
        fns = {a: make_verified_step_batched(*attn[a], ccfg, stats, device=dev)
               for a in ("fast", "all_kernel")}
        runs = {"bf16 fast": (fns["fast"], pp, vp),
                "int8_full fast": (fns["fast"], qpp, qvp),
                "int8_full all_kernel": (fns["all_kernel"], qpp, qvp)}
        res = {}
        for name, (fn, p, v) in runs.items():
            ca.reset_launch_counts()
            quant.reset_int_mm_calls()
            quant.reset_launch_counts()
            res[name] = fn(p, v, *inputs, noise=noise)
            torch.cuda.synchronize()
            counts, n_int = dict(ca.launch_counts), quant.int_mm_calls["int_mm"]
            n_quant = dict(quant.launch_counts)
            want = expected[name.split()[-1]]
            int8 = name.startswith("int8")
            want_int = int_mm_per_step if int8 else 0
            want_quant = {q: n if int8 else 0
                          for q, n in quant_per_step.items()}
            if counts != want or n_int != want_int or n_quant != want_quant:
                raise AssertionError(f"{cell} {name}: launches {counts}, "
                                     f"_int_mm {n_int}, {n_quant}; expected "
                                     f"{want}, {want_int}, {want_quant}")
            check_result(torch, res[name], e, ccfg.n_rephrases,
                         ccfg.n_samples, pcfg.chunk_size)
            log(f"{cell} {name}: launches {counts}, _int_mm calls {n_int}, "
                f"quant kernels {n_quant}")
        # the int8_full step again, and with the eager chain (the plain
        # twins on the card) in place of the quant kernels: bit-equal
        # wherever the step itself repeats bit for bit
        fn, p, v = runs["int8_full fast"]
        again = fn(p, v, *inputs, noise=noise)
        with mock.patch.object(quant, "quant_act", quant.quant_act_plain), \
                mock.patch.object(quant, "rescale", quant.rescale_plain):
            eager = fn(p, v, *inputs, noise=noise)
        kernel = res["int8_full fast"]
        repeats = all(torch.equal(getattr(again, f), getattr(kernel, f))
                      for f in kernel._fields)
        differ = [f for f in kernel._fields
                  if not torch.equal(getattr(eager, f), getattr(kernel, f))]
        if repeats and differ:
            raise AssertionError(f"{cell} int8_full fast: the quant kernels "
                                 f"and the eager chain differ in {differ}")
        log(f"{cell} int8_full fast: the step repeats bit for bit: {repeats}; "
            f"with the eager quant chain instead of the kernels, outputs "
            f"that differ: {differ or 'none'}")
        del again, eager
        raw, proprio, lt, lm, vt, hist, hlen = inputs
        propose = make_propose_step_batched(*attn["fast"], ccfg, stats,
                                            device=dev)
        c_bf = propose(pp, raw, proprio, lt, lm, hist, hlen, noise=noise)
        c_q = propose(qpp, raw, proprio, lt, lm, hist, hlen, noise=noise)
        a_bf = normalized_actions(torch, c_bf, stats)
        a_q = normalized_actions(torch, c_q, stats)
        act_rel = ((a_q - a_bf).abs().max()
                   / a_bf.pow(2).mean().sqrt()).item()
        # the verifier alone, as the JAX bound defines it: the int8 and the
        # bf16 backbone score the same (bf16 policy's) candidates
        vc = attn["fast"][1]
        s_bf = verifier_scores(torch, dev, vc, vp, raw, vt, c_bf.trajectories)
        s_q = verifier_scores(torch, dev, vc, qvp, raw, vt, c_bf.trajectories)
        ver_rel = ((s_q - s_bf).abs().max() / (s_bf.max() - s_bf.min())).item()
        ver_ep = ((s_q - s_bf).abs().amax(1)
                  / (s_bf.amax(1) - s_bf.amin(1))).max().item()
        if not (act_rel < INT8_ACTION_REL and ver_rel < INT8_SCORE_REL):
            raise AssertionError(
                f"{cell} int8 vs bf16: policy action rel {act_rel}, "
                f"verifier score rel {ver_rel} (bounds {INT8_ACTION_REL}, "
                f"{INT8_SCORE_REL})")
        log(f"{cell} int8 vs bf16 (JAX int8 bounds): policy, all "
            f"{a_bf.shape[0] * a_bf.shape[1]} candidates, max |d action| / "
            f"RMS {act_rel:.4f} (bound {INT8_ACTION_REL}); verifier backbone "
            f"on the same candidates, max |d score| / score span "
            f"{ver_rel:.4f} (bound {INT8_SCORE_REL}; worst episode's own "
            f"span {ver_ep:.4f}); score span {(s_bf.max() - s_bf.min()).item():.3e}")
        x = res["bf16 fast"]
        for name in ("int8_full fast", "int8_full all_kernel"):
            f = res[name]
            d = (f.scores - x.scores).abs()
            agree = (f.winner_idx == x.winner_idx).float().mean().item()
            log(f"{cell} {name} vs bf16 fast, end to end (int8 candidates "
                f"under the int8 verifier): max |d score| {d.max().item():.3e}"
                f" = {(d.max() / (x.scores.max() - x.scores.min())).item():.4f}"
                f" of the score span (worst episode's own span "
                f"{(d.amax(1) / (x.scores.amax(1) - x.scores.amin(1))).max().item():.4f}),"
                f" same pick in {agree:.3f} of {e} episodes")
        if cell == first_cell:
            for name in ("bf16 fast", "int8_full fast"):
                fn, p, v = runs[name]
                profiles[name] = profile_step(
                    torch, card, cell, lambda: fn(p, v, *inputs, noise=noise),
                    label=name)
        times = {name: [] for name in runs}
        # STEP_REPEATS in-turns rounds: the p50s only compare the int8
        # steps with bf16 fast, and the run must leave room for phase 14
        for _ in range(STEP_REPEATS):       # the configs in turns
            for name, (fn, p, v) in runs.items():
                t0 = time.perf_counter()
                fn(p, v, *inputs, noise=noise)
                torch.cuda.synchronize()
                times[name].append(time.perf_counter() - t0)
        p50 = {name: float(np.median(t)) for name, t in times.items()}
        for name in runs:
            log(f"step {cell} {name}: p50 {p50[name] * 1e3:.2f} ms (min "
                f"{min(times[name]) * 1e3:.2f}), verified actions/s "
                f"{e * pcfg.chunk_size / p50[name]:.2f}, p50 / bf16 fast "
                f"{p50[name] / p50['bf16 fast']:.3f} | {card}")
    del qpp, qvp
    torch.cuda.empty_cache()
    return profiles


def pi0fast_phase(torch, card, dev, cfg):
    """pi0-FAST at full width (`Pi0FastConfig()`: PaliGemma 2B + so400m,
    random weights): greedy generation at B = 1 and 4, deterministic and
    invariant to the padded prompt ids; prefill and per-token times; the
    policy's queue."""
    from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
    from cover_vla_tpu_torch.models import gemma, pi0fast

    t0 = time.perf_counter()
    params = pi0fast.init_pi0fast(2, cfg, device=dev)
    torch.cuda.synchronize()
    log(f"pi0fast: random weights, {sum(p.numel() for p in params.parameters()) / 1e9:.3f}B "
        f"params, init {time.perf_counter() - t0:.1f}s")
    tok = HashTokenizer(cfg.paligemma.vocab_size)
    rng = np.random.default_rng(8)
    tasks = ["put carrot on plate", "put the spoon on the towel",
             "stack the green block on the yellow block",
             "put eggplant into yellow basket"]
    s = cfg.vision.image_size
    for b in (1, 4):
        state = rng.uniform(-1, 1, (b, 7)).astype(np.float32)
        toks, masks = tok.encode_batch(pi0fast.build_prompts(state, tasks[:b]),
                                       cfg.max_input_seq_len)
        images = torch.from_numpy(rng.uniform(-1, 1, (b, 1, s, s, 3)).astype(
            np.float32)).to(dev)
        im = torch.ones((b, 1), dtype=torch.bool, device=dev)
        corrupt = toks.copy()
        corrupt[~masks] = 7
        t_toks, t_masks, t_corrupt = (torch.from_numpy(x).to(dev)
                                      for x in (toks, masks, corrupt))
        outs, walls = [], []
        for tt in (t_toks, t_toks, t_corrupt):
            t0 = time.perf_counter()
            outs.append(pi0fast.generate_action_tokens(params, cfg, images,
                                                       im, tt, t_masks))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out = outs[0]
        if out.shape != (b, cfg.max_decoding_steps) or out.dtype != torch.int32:
            raise AssertionError(f"pi0fast B={b}: {out.shape} {out.dtype}")
        if not torch.equal(outs[1], out):
            raise AssertionError(f"pi0fast B={b}: generation not deterministic")
        if not torch.equal(outs[2], out):
            raise AssertionError(f"pi0fast B={b}: padded prompt ids changed "
                                 "the generation")
        # the prefill alone: embeddings, vision tower and the LM prefill
        with torch.no_grad():
            prefill = []
            for _ in range(3):
                t0 = time.perf_counter()
                embs, pad = pi0fast.embed_prefix(params, cfg, images, im,
                                                 t_toks, t_masks)
                pos = torch.cumsum(pad.to(torch.int32), dim=1) - 1
                gemma.prefill(params["paligemma"], cfg.paligemma, embs, pos,
                              pad[:, None, :] & pad[:, :, None],
                              return_hidden=True)
                torch.cuda.synchronize()
                prefill.append(time.perf_counter() - t0)
        eos = int((out == cfg.eos_token_id).sum())
        gen = min(walls[1:])
        per_token = (gen - min(prefill)) / (cfg.max_decoding_steps - 1)
        log(f"pi0fast B={b}: int32[{b}, {cfg.max_decoding_steps}], equal on "
            f"repeat and with corrupted padded prompt ids ({int((~masks).sum())} "
            f"ids); generation {gen * 1e3:.1f} ms (first call "
            f"{walls[0] * 1e3:.1f}), prefill {min(prefill) * 1e3:.2f} ms over "
            f"{pad.shape[1]} slots, {per_token * 1e3:.3f} ms a generated token "
            f"({cfg.max_decoding_steps - 1} decode steps; EOS tokens emitted: "
            f"{eos}) | {card}")
    policy = pi0fast.Pi0FastPolicy(params, cfg, text_tokenizer=tok,
                                   device=dev)
    imgs = rng.uniform(-1, 1, (1, 1, s, s, 3)).astype(np.float32)
    state = rng.uniform(-1, 1, (1, 7)).astype(np.float32)
    a0 = policy.select_action(imgs, state, tasks[:1])
    a1 = policy.select_action(imgs, state, tasks[:1])
    # a second generation would have refilled the queue
    if not (a0.shape == a1.shape == (1, 7) and np.isfinite(a0).all()
            and len(policy._queue) == cfg.n_action_steps - 2):
        raise AssertionError("Pi0FastPolicy queue")
    log(f"pi0fast policy: select_action x2 = one generation, "
        f"{len(policy._queue)} actions left in the queue")
    return params


def serving_phase(torch, card, dev, pcfg, vcfg, pp, vp, fast_params):
    """Four served policies answer infer x3, reset, infer through the
    server's verb dispatch (msgpack frames when msgpack imports): the
    factory's int8 pi0 and pi0-FAST, a pi0 wrapper under the fast config
    (K1, K2) in int8, and the int8_full CoVer engine (all kernels)."""
    import importlib.util
    from cover_vla_tpu_torch.configs import CoVerConfig, fast_pi0_config
    from cover_vla_tpu_torch.data.tokenizer import HashTokenizer
    from cover_vla_tpu_torch.engine import CoVerEngine
    from cover_vla_tpu_torch.models.factory import make_policy
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.serving import (
        CoVerPolicyWrapper, Pi0PolicyWrapper, WebsocketPolicyClient,
        WebsocketPolicyServer)
    from cover_vla_tpu_torch.serving import msgpack_numpy as mpn

    have = {m: importlib.util.find_spec(m) is not None
            for m in ("msgpack", "websockets")}
    ptok = HashTokenizer(pcfg.paligemma.vocab_size)
    pc, vc = kernel_configs(pcfg, vcfg)["all_kernel"]
    engine = CoVerEngine(
        pp, vp, pc, vc, CoVerConfig(n_samples=5, n_rephrases=8), seed=0,
        policy_tokenizer=ptok,
        verifier_tokenizer=HashTokenizer(vcfg.text.vocab_size, add_bos=False),
        device=dev)
    policies = {
        "pi0 int8 (factory)": make_policy(
            "pi0", params=pp, quantize="int8", tokenizer=ptok, device=dev),
        "pi0fast (factory)": make_policy(
            "pi0fast", params=fast_params, text_tokenizer=ptok, device=dev),
        "pi0 fast config int8": Pi0PolicyWrapper(
            pp, fast_pi0_config(pcfg), tokenizer=ptok, quantize="int8",
            device=dev),
        "cover int8_full (all_kernel)": CoVerPolicyWrapper(
            engine, quantize="int8_full")}
    # whether the next infer runs the model (an empty action queue, a
    # chunk boundary), and the kernel launches one run makes
    def runs_model(policy):
        if isinstance(policy, CoVerPolicyWrapper):
            return policy.engine._tick % policy.engine.pcfg.chunk_size == 0
        return not policy._queue
    per_run = {"pi0 int8 (factory)": {},
               "pi0fast (factory)": {},
               "pi0 fast config int8": {
                   "shared_prefix_gqa": pcfg.expert.depth * pcfg.num_denoise_steps,
                   "mha_dense": pcfg.vision.depth},
               "cover int8_full (all_kernel)": launches_per_step(pcfg, vcfg)}
    rng = np.random.default_rng(9)
    eef = np.array([0.1, 0.0, 0.2, 1.0, 0.0, 0.0, 0.0, 0.6])
    task = "put carrot on plate"

    def request(name, i):
        img = rng.integers(0, 255, (256, 256, 3), dtype=np.uint8)
        if name.startswith("pi0fast"):
            obs = {"image": img, "state": rng.uniform(-1, 1, 7).astype(
                np.float32), "task": task}
        elif name.startswith("cover"):
            obs = {"image": img, "proprio": rng.uniform(-0.1, 0.1, 7).astype(
                np.float32)}
            if i == 0:
                obs["reset_task"] = task
        else:
            obs = {"image": img, "state": {"agent": {"eef_pos": eef}},
                   "task": task}
        return {"type": "infer", "obs": obs}

    for name, policy in policies.items():
        server = WebsocketPolicyServer(policy, metadata={"model": name})
        ca.reset_launch_counts()
        lat = {True: [], False: []}
        plan = ["infer", "infer", "infer", "reset", "infer"]
        for i, verb in enumerate(plan):
            req = request(name, i) if verb == "infer" else {"type": "reset"}
            ran = runs_model(policy)
            t0 = time.perf_counter()
            if have["msgpack"]:
                resp = mpn.unpackb(mpn.packb(server.dispatch(
                    mpn.unpackb(mpn.packb(req)))))
            else:
                resp = server.dispatch(req)
            wall = time.perf_counter() - t0
            if verb == "reset":
                assert resp == {"status": "ok"}, resp
                continue
            act = np.asarray(resp["actions"])
            if act.shape != (7,) or not np.isfinite(act).all():
                raise AssertionError(f"{name}: action {act}")
            lat[ran].append(wall)
        model_runs = len(lat[True])
        counts = dict(ca.launch_counts)
        want = {k: per_run[name].get(k, 0) * model_runs for k in counts}
        if model_runs != 2 or counts != want:
            raise AssertionError(f"{name}: {model_runs} model runs, launches "
                                 f"{counts}, expected 2 and {want}")
        log(f"serving {name}: infer x3, reset, infer through dispatch"
            f"{' with msgpack frames' if have['msgpack'] else ''}: {model_runs} "
            f"model runs, p50 {np.median(lat[True]) * 1e3:.1f} ms (requests "
            f"that ran the model), {np.median(lat[False]) * 1e3:.2f} ms "
            f"(queue pops), launches {counts} | {card}")

    if have["msgpack"] and have["websockets"]:
        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        name = "pi0 fast config int8"
        server = WebsocketPolicyServer(policies[name], "127.0.0.1", port,
                                       metadata={"model": name})
        server.serve_in_thread()
        try:
            client = WebsocketPolicyClient("127.0.0.1", port,
                                           retry_interval_s=0.5, max_retries=20)
            try:
                assert client.metadata == {"model": name}, client.metadata
                client.reset()
                t0 = time.perf_counter()
                out = client.infer(request(name, 1)["obs"])
                wall = time.perf_counter() - t0
                assert np.asarray(out["actions"]).shape == (7,)
            finally:
                client.close()
        finally:
            server.stop()
        log(f"serving over a localhost websocket ({name}): metadata, reset, "
            f"infer in {wall * 1e3:.1f} ms | {card}")
    else:
        log(f"serving: no localhost socket round trip, not importable: "
            f"{[m for m, ok in have.items() if not ok]}")


# ---------------------------------------------------------------------------
# phase 7: checkpoints and the entry point at full width
# ---------------------------------------------------------------------------


def lerobot_pi0_tensors(pp, pcfg):
    """The inverse of convert_pi0's layout: (name, tensor) pairs of a
    lerobot PI0Policy state dict, as views of the card tree `pp` in its
    own dtypes (un-transposed, un-stacked, renamed)."""
    root = "model.paligemma_with_expert."
    out = []

    def gemma_stack(tree, prefix, depth, embed):
        layers = tree["layers"]
        for i in range(depth):
            p = f"{prefix}.layers.{i}."
            out.append((p + "input_layernorm.weight", layers["input_ln"][i]))
            for key, name in (("q", "self_attn.q_proj"),
                              ("k", "self_attn.k_proj"),
                              ("v", "self_attn.v_proj"),
                              ("o", "self_attn.o_proj"),
                              ("gate", "mlp.gate_proj"),
                              ("up", "mlp.up_proj"),
                              ("down", "mlp.down_proj")):
                out.append((p + name + ".weight", layers[key][i].t()))
            out.append((p + "post_attention_layernorm.weight",
                        layers["post_ln"][i]))
        out.append((prefix + ".norm.weight", tree["final_norm"]))
        if embed:
            out.append((prefix + ".embed_tokens.weight", tree["embed"]))

    def linear(name, sub, i=None):
        k, b = sub["kernel"], sub["bias"]
        if i is not None:
            k, b = k[i], b[i]
        out.append((name + ".weight", k.t()))
        out.append((name + ".bias", b))

    v, vc = pp["vision"], pcfg.vision
    vt = root + "paligemma.vision_tower.vision_model"
    ps = vc.patch_size
    out.append((vt + ".embeddings.patch_embedding.weight",
                v["patch_embed"]["kernel"].reshape(ps, ps, 3, vc.width)
                .permute(3, 2, 0, 1)))
    out.append((vt + ".embeddings.patch_embedding.bias",
                v["patch_embed"]["bias"]))
    out.append((vt + ".embeddings.position_embedding.weight", v["pos_emb"]))
    blocks = v["blocks"]
    for i in range(vc.depth):
        p = f"{vt}.encoder.layers.{i}."
        for ln in ("1", "2"):
            out.append((p + f"layer_norm{ln}.weight",
                        blocks[f"ln{ln}"]["scale"][i]))
            out.append((p + f"layer_norm{ln}.bias",
                        blocks[f"ln{ln}"]["bias"][i]))
        for key, name in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                          ("o", "out_proj")):
            linear(p + "self_attn." + name, blocks["attn"][key], i)
        linear(p + "mlp.fc1", blocks["mlp"]["fc1"], i)
        linear(p + "mlp.fc2", blocks["mlp"]["fc2"], i)
    out.append((vt + ".post_layernorm.weight", v["final_ln"]["scale"]))
    out.append((vt + ".post_layernorm.bias", v["final_ln"]["bias"]))
    linear(root + "paligemma.multi_modal_projector.linear", pp["mm_proj"])
    gemma_stack(pp["paligemma"], root + "paligemma.language_model.model",
                pcfg.paligemma.depth, True)
    gemma_stack(pp["expert"], root + "gemma_expert.model", pcfg.expert.depth,
                False)
    for key, name in (("state_proj", "state_proj"),
                      ("action_in_proj", "action_in_proj"),
                      ("action_out_proj", "action_out_proj"),
                      ("time_mlp_in", "action_time_mlp_in"),
                      ("time_mlp_out", "action_time_mlp_out")):
        linear("model." + name, pp[key])
    return out


def write_safetensors(torch, path, named) -> int:
    """A .safetensors file of (name, tensor) pairs (any device), written
    one tensor at a time: the u64 header length, the JSON header padded to
    8 bytes, then the data in order. Returns the bytes written."""
    codes = {torch.bfloat16: "BF16", torch.float32: "F32"}
    header, off = {}, 0
    for name, t in named:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [off, off + n]}
        off += n
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for _, t in named:
            c = t.contiguous().cpu()
            f.write((c.view(torch.int16) if c.dtype == torch.bfloat16
                     else c).numpy().data)
        f.flush()
        os.fsync(f.fileno())
    return 8 + len(raw) + off


def resident_share(path) -> float:
    """The share of `path`'s pages in the page cache: `mincore` over a
    mapping of the file that touches none of them."""
    import ctypes
    import mmap
    libc = ctypes.CDLL(None, use_errno=True)
    libc.mmap.restype = ctypes.c_void_p
    libc.mmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, ctypes.c_long]
    libc.munmap.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    libc.mincore.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                             ctypes.c_void_p]
    size = os.path.getsize(path)
    pages = -(-size // mmap.PAGESIZE)
    vec = (ctypes.c_ubyte * pages)()
    fd = os.open(path, os.O_RDONLY)
    try:
        addr = libc.mmap(None, size, mmap.PROT_READ, mmap.MAP_SHARED, fd, 0)
        if addr is None or addr == ctypes.c_void_p(-1).value:
            raise OSError(ctypes.get_errno(), f"mmap of {path}")
        try:
            if libc.mincore(ctypes.c_void_p(addr), size, vec):
                raise OSError(ctypes.get_errno(), f"mincore of {path}")
        finally:
            libc.munmap(ctypes.c_void_p(addr), size)
    finally:
        os.close(fd)
    return 1 - bytes(vec).count(0) / pages


def drop_page_cache(path) -> float:
    """Write `path`'s dirty pages back and ask the kernel to drop its
    cached pages (no root needed), then return the share of its pages
    that `mincore` still finds resident: under 0.01, the next read comes
    from the disk. Some sandboxes honour neither call, their file systems
    living in memory; then every read of the file is a memory read."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)
    return resident_share(path)


def read_from(resident: float) -> str:
    """Where a read after `drop_page_cache` comes from, for the log."""
    if resident < 0.01:
        return f"the disk (page cache dropped: {resident:.1%} resident)"
    return (f"a file not shown dropped from the page cache ({resident:.0%} "
            "resident after POSIX_FADV_DONTNEED): not a disk reading")


def mount_of(path) -> str:
    """The file system type and mount point that hold `path`."""
    path, best = os.path.realpath(path), ("?", "")
    with open("/proc/mounts") as f:
        for line in f:
            _, point, fstype = line.split()[:3]
            inside = path == point or path.startswith(point.rstrip("/") + "/")
            if inside and len(point) >= len(best[1]):
                best = (fstype, point)
    return f"{best[0]} at {best[1]}"


def read_rate_gbs(path) -> float:
    """GB/s of one sequential read of `path` in 64 MiB pieces."""
    buf = bytearray(64 << 20)
    view, total = memoryview(buf), 0
    t0 = time.perf_counter()
    with open(path, "rb", buffering=0) as f:
        while True:
            n = f.readinto(view)
            if not n:
                break
            total += n
    return total / (time.perf_counter() - t0) / 1e9


class RssPeak:
    """The host's resident set, sampled every 10 ms from /proc/self/statm
    while the `with` block runs: peak and last readings in GB. (Linux's
    resettable peak, `VmHWM` after a `clear_refs` write, is missing in
    sandboxed kernels such as gVisor's.)"""

    def __init__(self):
        import threading
        self._page = os.sysconf("SC_PAGE_SIZE")
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.peak = self.last = self._read()

    def _read(self) -> float:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self._page / 1e9

    def _run(self):
        while not self._stop.wait(0.01):
            self.last = self._read()
            self.peak = max(self.peak, self.last)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)
        self.last = self._read()
        self.peak = max(self.peak, self.last)
        return False


def assert_tree_equal(torch, got, want, what, where=""):
    """Same keys; every leaf the same dtype, shape and bits."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{what}{where}: keys {sorted(got)} vs "
                             f"{sorted(want)}")
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, torch.Tensor):
            if g.dtype != w.dtype or not torch.equal(g, w):
                raise AssertionError(f"{what}{where}/{k}: not bit-equal "
                                     f"({g.dtype} vs {w.dtype})")
        else:
            assert_tree_equal(torch, g, w, what, f"{where}/{k}")


class StageLog:
    """Collects the loaders' stage seconds (their INFO records)."""

    def __init__(self):
        import logging
        self.logger = logging.getLogger("cover_vla_tpu_torch.convert.loaders")
        self.records = []
        outer = self

        class Handler(logging.Handler):
            def emit(self, record):
                if hasattr(record, "stage"):
                    outer.records.append((record.stage, record.seconds))

        self.handler = Handler()
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)

    def take(self) -> dict:
        out = dict(self.records)
        self.records.clear()
        return out

    def close(self):
        self.logger.removeHandler(self.handler)


def checkpoint_phase(torch, card, dev, pcfg, vcfg, pp, vp):
    """Phase 7: a full-width lerobot π0 .safetensors and a heads-only
    merged verifier .pt, written from the random trees, loaded back
    bit-equal (cold, cached), run through the all-kernel step bit-equal
    to the in-memory trees, and served through run.build_server with both
    switch_model kinds."""
    import gc
    import shutil
    import tempfile
    from cover_vla_tpu_torch import run
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.convert import checkpoints, loaders
    from cover_vla_tpu_torch.convert.verifier_to_torch import (
        save_merged_ensemble)
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import (
        make_propose_step_batched, make_verified_step_batched)
    from cover_vla_tpu_torch.models import pi0, verifier
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.serving import msgpack_numpy as mpn
    from cover_vla_tpu_torch.utils import count_params, param_bytes

    tmp = tempfile.mkdtemp(prefix="cvla_checkpoints_")
    stages = StageLog()
    try:
        # 7.1 disk ----------------------------------------------------------
        p_bytes, v_bytes = param_bytes(pp), param_bytes(vp)
        usage = shutil.disk_usage(tmp)
        # at once: the .safetensors, its cache and the verifier blob; in
        # all, also the second π0 (a blob) and two merged .pt files
        need = 2 * p_bytes + v_bytes
        log(f"phase 7 disk: {tmp}: {usage.free / 1e9:.1f} GB free of "
            f"{usage.total / 1e9:.1f} GB; the phase writes "
            f"{(3 * p_bytes + v_bytes) / 1e9:.2f} GB in all, at most "
            f"{need / 1e9:.2f} GB at once (π0 .safetensors {p_bytes / 1e9:.3f} "
            f"GB = {count_params(pp) / 1e9:.3f}B params, its cache as much, "
            f"verifier blob {v_bytes / 1e9:.3f} GB); each file is deleted "
            f"once it has served")
        if usage.free < 1.1 * need:
            raise AssertionError(
                f"phase 7 needs {need / 1e9:.1f} GB on {tmp}, "
                f"{usage.free / 1e9:.1f} GB are free")

        # 7.2 a lerobot-layout π0 state dict ----------------------------------
        st = os.path.join(tmp, "model.safetensors")
        t0 = time.perf_counter()
        n = write_safetensors(torch, st, lerobot_pi0_tensors(pp, pcfg))
        write_s = time.perf_counter() - t0
        src = read_from(drop_page_cache(st))
        disk_gbs = read_rate_gbs(st)
        drop_page_cache(st)
        log(f"checkpoint: wrote the lerobot π0 .safetensors, {n / 1e9:.3f} "
            f"GB in {write_s:.2f} s (card to host to file, fsync) on "
            f"{mount_of(st)}; a sequential read of it {disk_gbs:.2f} GB/s "
            f"from {src} | {card}")

        # 7.3 load it twice: cold, then from the cache ------------------------
        def timed_load(label):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            with RssPeak() as rss:
                before = rss.last
                t0 = time.perf_counter()
                out = loaders.load_policy_params(st, pcfg, device=dev)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            got = stages.take()
            log(f"load {label}: {wall:.2f} s, {p_bytes / wall / 1e9:.2f} GB/s "
                f"end to end; stages "
                f"{ {k: round(v, 3) for k, v in got.items()} }; to device "
                f"{p_bytes / got['to_device'] / 1e9:.2f} GB/s; host RSS "
                f"{before:.2f} GB before, peak {rss.peak:.2f} GB, "
                f"{rss.last:.2f} GB after; card peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}")
            return out, got

        loaded, cold = timed_load("cold (read + convert + cache write + "
                                  "to device)")
        if "convert" not in cold or "cache_write" not in cold:
            raise AssertionError(f"the cold load did not convert: {cold}")
        assert_tree_equal(torch, loaded, pp, "cold-loaded π0")
        del loaded
        gc.collect()
        blob_path = os.path.join(st + loaders.CACHE_SUFFIX,
                                 checkpoints.BLOB_NAME)
        src = read_from(drop_page_cache(blob_path))
        loaded, cached = timed_load(f"cached, read from {src}, to device")
        if "convert" in cached:
            raise AssertionError(f"the cached load converted: {cached}")
        assert_tree_equal(torch, loaded, pp, "cache-loaded π0")
        del loaded
        gc.collect()
        loaded_pp, _ = timed_load("cached, in the page cache (pageable "
                                  "host-to-device copy)")
        assert_tree_equal(torch, loaded_pp, pp, "cache-loaded π0")
        log("checkpoint: π0 .safetensors -> convert_pi0 -> cache -> card: "
            "every leaf bit-equal to the random tree, three loads")

        # 7.4 the verifier heads ----------------------------------------------
        pt = os.path.join(tmp, "merged_ensemble.pt")
        t0 = time.perf_counter()
        save_merged_ensemble(pt, vp["members"], vcfg)
        t1 = time.perf_counter()
        loaded_vp = loaders.load_verifier_params(
            pt, vcfg, backbone_params=vp["backbone"], device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        assert_tree_equal(torch, loaded_vp, vp, "reloaded verifier")
        log(f"checkpoint: verifier heads ({count_params(vp['members']) / 1e6:.2f}M "
            f"params, 3 members) -> merged .pt in {t1 - t0:.2f} s -> back "
            f"with the served backbone in {t2 - t1:.2f} s: bit-equal | {card}")

        # 7.5 the loaded weights through the kernels ---------------------------
        from cover_vla_tpu_torch.configs import fast_pi0_config, replace
        pc = replace(fast_pi0_config(pcfg), attention_impl="cuda")
        vc = kernel_configs(pcfg, vcfg)["all_kernel"][1]
        ccfg = CoVerConfig(n_samples=5, n_rephrases=8)
        stats = DatasetStatistics.from_json()
        inputs, noise_np = episode_inputs(pcfg, vcfg, ccfg, 1, seed=0)
        noise = torch.from_numpy(noise_np).to(dev)
        step = make_verified_step_batched(pc, vc, ccfg, stats, device=dev)
        want = step(pp, vp, *inputs, noise=noise)
        torch.cuda.synchronize()
        ca.reset_launch_counts()
        got = step(loaded_pp, loaded_vp, *inputs, noise=noise)
        torch.cuda.synchronize()
        launches = dict(ca.launch_counts)
        if launches != launches_per_step(pcfg, vcfg):
            raise AssertionError(f"loaded-weights step launches {launches}")
        check_result(torch, got, 1, 8, 5, pcfg.chunk_size)
        for name, a in want._asdict().items():
            if not torch.equal(a, getattr(got, name)):
                raise AssertionError(f"loaded-weights step: {name} differs")
        raw, proprio, lt, lm, _, hist, hlen = inputs
        propose = make_propose_step_batched(pc, vc, ccfg, stats, device=dev)
        cw = propose(pp, raw, proprio, lt, lm, hist, hlen, noise=noise)
        cg = propose(loaded_pp, raw, proprio, lt, lm, hist, hlen, noise=noise)
        for name, a in cw._asdict().items():
            if not torch.equal(a, getattr(cg, name)):
                raise AssertionError(f"loaded-weights candidates: {name} "
                                     f"differs")
        log(f"checkpoint: E1_N5_K8 all_kernel step on the loaded weights: all "
            f"{cw.exec_chunks.shape[1]} candidates, scores and the pick "
            f"bit-equal to the in-memory weights; launches {launches}")
        del loaded_pp, loaded_vp, want, got, cw, cg
        gc.collect()

        # 7.6 serving through run.py -------------------------------------------
        serve = run.ServeCfg(mode="cover", checkpoint=st,
                             verifier_checkpoint=pt)
        try:
            run.build_server(run.RunCfg(role="serve_policy", serve=serve))
        except RuntimeError as e:
            if "tokenizer" not in str(e):
                raise
        else:
            raise AssertionError("build_server served a checkpoint under the "
                                 "hash tokenizer without allow_hash_tokenizer")
        serve = replace(serve, allow_hash_tokenizer=True)
        try:
            run.build_server(run.RunCfg(role="serve_policy", serve=serve))
        except ValueError as e:
            if "heads-only" not in str(e):
                raise
        else:
            raise AssertionError("build_server took a heads-only .pt as its "
                                 "first verifier checkpoint")
        vdir = checkpoints.save_params(os.path.join(tmp, "verifier"), vp)
        t0 = time.perf_counter()
        server = run.build_server(run.RunCfg(
            role="serve_policy", serve=replace(serve, verifier_checkpoint=vdir)))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        policy = server.policy
        engine = policy.engine
        assert_tree_equal(torch, engine.policy_params, pp, "served π0")
        assert_tree_equal(torch, engine.verifier_params, vp, "served verifier")
        gc.collect()
        shutil.rmtree(st + loaders.CACHE_SUFFIX)
        os.remove(st)
        shutil.rmtree(vdir)
        log(f"serving: run.build_server(mode=cover, checkpoint=<.safetensors>, "
            f"verifier_checkpoint=<blob dir>, allow_hash_tokenizer) in "
            f"{build_s:.2f} s, both trees bit-equal; refused without "
            f"allow_hash_tokenizer, and with a heads-only .pt as its first "
            f"verifier (it carries no backbone) | {card}")

        pp2 = pi0.init_pi0(2, pcfg, device=dev)
        pdir = checkpoints.save_params(os.path.join(tmp, "pi0_2"), pp2)
        members2 = verifier.init_verifier(3, vcfg, num_members=3,
                                          device=dev)["members"]
        pt2 = os.path.join(tmp, "merged_ensemble_2.pt")
        save_merged_ensemble(pt2, members2, vcfg)
        have_msgpack = importlib.util.find_spec("msgpack") is not None
        rng = np.random.default_rng(11)
        task = "put carrot on plate"

        def infer(first=False):
            obs = {"image": rng.integers(0, 255, (256, 256, 3),
                                         dtype=np.uint8),
                   "proprio": rng.uniform(-0.1, 0.1, 7).astype(np.float32)}
            if first:
                obs["reset_task"] = task
            return {"type": "infer", "obs": obs}

        plan = [infer(True), infer(), infer(), {"type": "reset"},
                {"type": "switch_model", "path": pdir}, infer(),
                {"type": "switch_model", "path": "verifier:" + pt2}, infer()]
        model_s, pop_s, switch_s = [], [], {}
        backbone = engine.verifier_params["backbone"]
        ca.reset_launch_counts()
        for req in plan:
            ran = engine._tick % engine.pcfg.chunk_size == 0
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            resp = (mpn.unpackb(mpn.packb(server.dispatch(
                mpn.unpackb(mpn.packb(req))))) if have_msgpack
                else server.dispatch(req))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            if req["type"] == "infer":
                act = np.asarray(resp["actions"])
                if act.shape != (7,) or not np.isfinite(act).all():
                    raise AssertionError(f"served action {act}")
                (model_s if ran else pop_s).append(wall)
            elif req["type"] == "switch_model":
                assert resp == {"status": "ok"}, resp
                switch_s[req["path"]] = (
                    wall, torch.cuda.max_memory_allocated() / 1e9)
            else:
                assert resp == {"status": "ok"}, resp
        served_launches = dict(ca.launch_counts)
        if any(served_launches.values()):
            raise AssertionError(f"build_server's engine (the eager configs) "
                                 f"launched kernels: {served_launches}")
        assert_tree_equal(torch, engine.policy_params, pp2, "switched π0")
        assert_tree_equal(torch, engine.verifier_params["members"], members2,
                          "switched verifier heads")
        if engine.verifier_params["backbone"] is not backbone:
            raise AssertionError("the verifier switch replaced the backbone")
        (sp, pm), (sv, vm) = switch_s[pdir], switch_s["verifier:" + pt2]
        log(f"serving through run.py ({'msgpack frames' if have_msgpack else 'dicts'}): "
            f"infer x3, reset, switch π0 (blob dir) {sp:.2f} s (card peak "
            f"{pm:.2f} GB: both policy trees held until the swap), infer, "
            f"switch verifier:<heads .pt> {sv:.2f} s (card peak {vm:.2f} GB), "
            f"infer; {len(model_s)} requests ran the model: p50 "
            f"{np.median(model_s) * 1e3:.1f} ms, queue pops p50 "
            f"{np.median(pop_s) * 1e3:.2f} ms; switched trees bit-equal; "
            f"kernel launches {served_launches} (build_server serves the "
            f"eager configs, as the JAX package's does) | {card}")
        if len(model_s) != 3:
            raise AssertionError(f"{len(model_s)} model runs, expected 3")
    finally:
        stages.close()
        shutil.rmtree(tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8: training
# ---------------------------------------------------------------------------

# Card vs CPU through the tiny train steps (fp32 weights, TF32 off): loss
# and gradient norm within 1e-4 of themselves (1e-3 after an 8-bit step,
# whose outlier elements move them), parameters within 1e-5 (1% of the
# learning rate) in all but a share of elements, 8-bit grids differing in
# a share of entries. Adam divides each gradient by its own RMS, so an
# element whose gradient is rounding noise on both devices steps by a
# noise-driven fraction of lr; 8-bit AdamW rounds ~1e-7 differences into
# different int8 grid entries, and an element whose second moment rounds
# to 0 then steps by many times lr. The same bounds hold the port against
# the JAX package (tests/test_torch_training.py).
TRAIN_PARAM_ATOL = 1e-5
TRAIN_SHARE = {"adamw": 1e-4, "adamw_8bit": 1e-2}
TRAIN_GRID_SHARE = 1e-2


def train_batch(np_rng, cfg, b, pad_rows=1):
    """A π0 training batch: frames in [-1, 1] at the tower's size, 72
    prompt tokens with a padded tail, state, actions and a padded chunk
    tail on `pad_rows` rows."""
    s, t = cfg.vision.image_size, cfg.tokenizer_max_length
    lmask = np.ones((b, t), bool)
    lmask[:, t - 5:] = False
    is_pad = np.zeros((b, cfg.chunk_size), bool)
    is_pad[:pad_rows, -2:] = True
    return {
        "images": np_rng.uniform(-1, 1, (b, 1, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((b, 1), bool),
        "lang_tokens": np_rng.integers(0, min(1000, cfg.paligemma.vocab_size),
                                       (b, t)).astype(np.int32),
        "lang_masks": lmask,
        "state": np_rng.standard_normal((b, cfg.max_state_dim)
                                        ).astype(np.float32),
        "actions": np_rng.standard_normal(
            (b, cfg.chunk_size, cfg.max_action_dim)).astype(np.float32),
        "actions_is_pad": is_pad}


def to_device(torch, batch, dev):
    return {k: torch.from_numpy(np.array(v)).to(dev) for k, v in batch.items()}


def training_small_reference(torch, dev):
    """8a: the tiny π0 (fp32) through 3 partitioned adamw_8bit steps and 3
    full adamw steps with grad_accum 2, on the card and on the CPU from
    the same tree, batch, noise and flow times."""
    from cover_vla_tpu_torch.configs import replace, tiny_pi0_config
    from cover_vla_tpu_torch.models import pi0
    from cover_vla_tpu_torch.models.params import ParamTree
    from cover_vla_tpu_torch.training import optim, train_pi0
    from cover_vla_tpu_torch.utils.tree import flatten, unflatten

    cfg = replace(tiny_pi0_config(), compute_dtype="float32")
    base = {k: v.detach().float()
            for k, v in flatten(pi0.init_pi0(0, cfg, device="cpu")).items()}
    rng = np.random.default_rng(8)
    batch = train_batch(rng, cfg, 4)
    noise = rng.standard_normal((4, cfg.chunk_size, cfg.max_action_dim)
                                ).astype(np.float32)
    time_ = rng.uniform(0.001, 1.0, (4,)).astype(np.float32)
    for opt, partitioned, accum in (("adamw_8bit", True, 1),
                                    ("adamw", False, 2)):
        runs = {}
        for d in ("cpu", dev):
            tree = ParamTree(unflatten({k: v.clone().to(d)
                                        for k, v in base.items()}))
            # no warmup: optax AdamW's first update (count 0) moves the
            # parameters, so the second call of grad_accum 2 does
            tx = train_pi0.make_optimizer(optim.warmup_cosine(1e-3, 0, 20),
                                          optimizer=opt,
                                          accumulate_steps=accum)
            if partitioned:
                mask = train_pi0.freeze_mask(tree)
                state = train_pi0.init_partitioned_state(tree, tx, mask)
                step = train_pi0.make_partitioned_train_step(cfg, tx, mask)
            else:
                leaves = {k: v.requires_grad_(True)
                          for k, v in flatten(tree).items()}
                state = train_pi0.TrainState(tree, tx.init(leaves),
                                             optim.counter())
                step = train_pi0.make_train_step(cfg, tx)
            out = []
            for _ in range(3):
                state, m = step(state, None, to_device(torch, batch, d),
                                noise=torch.from_numpy(noise).to(d),
                                time=torch.from_numpy(time_).to(d))
                # copies: on the CPU `.cpu()` would alias the live tensors
                grids = ({k: q["values"].to("cpu", copy=True) for k, q in
                          state.opt_state["1"]["mu"].items()}
                         if opt == "adamw_8bit" else {})
                out.append((m["loss"].item(), m["grad_norm"].item(),
                            {k: v.detach().to("cpu", copy=True) for k, v in
                             flatten(state.params).items()}, grids))
            runs[str(d)] = out
        for i, (c, g) in enumerate(zip(runs["cpu"], runs[str(dev)])):
            rel = 1e-3 if opt == "adamw_8bit" and i else 1e-4
            d_loss = abs(g[0] - c[0]) / abs(c[0])
            d_norm = abs(g[1] - c[1]) / abs(c[1])
            diffs = torch.cat([(g[2][k] - c[2][k]).abs().reshape(-1)
                               for k in c[2]])
            share = (diffs > TRAIN_PARAM_ATOL).float().mean().item()
            grid_share = (sum(int((g[3][k] != c[3][k]).sum()) for k in c[3])
                          / max(1, sum(v.numel() for v in c[3].values())))
            log(f"train small reference: {opt} "
                f"{'partitioned' if partitioned else f'full, grad_accum {accum}'}"
                f" step {i + 1}: loss card {g[0]:.6f} cpu {c[0]:.6f} (rel "
                f"{d_loss:.2e}), grad_norm rel {d_norm:.2e}, parameters beyond "
                f"{TRAIN_PARAM_ATOL:g}: {share:.2e} of {diffs.numel()} "
                f"(largest {diffs.max().item():.2e})"
                + (f", int8 grid entries differing {grid_share:.2e}"
                   if opt == "adamw_8bit" else ""))
            assert d_loss <= rel and d_norm <= rel, (opt, i, d_loss, d_norm)
            assert share <= TRAIN_SHARE[opt], (opt, i, share)
            if opt == "adamw":
                assert diffs.max().item() <= 1e-4, (opt, i)
            assert grid_share <= TRAIN_GRID_SHARE, (opt, i, grid_share)


def trainable_reckoning(cfg) -> int:
    """The expert stack plus the five fp32 projections, from the config."""
    e, w = cfg.expert, cfg.proj_width
    qd, kvd = e.num_heads * e.head_dim, e.num_kv_heads * e.head_dim
    layer = (e.width * qd + 2 * e.width * kvd + qd * e.width
             + 3 * e.width * e.mlp_dim + 2 * e.width)
    linear = lambda i, o: i * o + o
    return (e.depth * layer + e.width
            + linear(cfg.max_state_dim, w) + linear(cfg.max_action_dim, w)
            + linear(w, cfg.max_action_dim) + linear(2 * w, w) + linear(w, w))


def timed_steps(torch, step, state, batch, n, seed):
    """n synchronised steps: (state, step seconds, losses, grad norms)."""
    secs, losses, norms = [], [], []
    for i in range(n):
        gen = torch.Generator(device=batch["state"].device).manual_seed(seed + i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, gen, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(m["loss"].item())
        norms.append(m["grad_norm"].item())
    assert all(math.isfinite(x) for x in losses + norms), (losses, norms)
    return state, secs, losses, norms


def training_full_width(torch, card, dev, cfg, b=32):
    """8b: a random π0 of `cfg` (Pi0Config() on the card), expert-only with
    remat, B = 32, one camera: 6 steps of adamw_8bit, then 6 of adamw,
    then the whole tree under adamw. Returns (params, batch)."""
    import gc
    from cover_vla_tpu_torch.models import pi0
    from cover_vla_tpu_torch.training import optim, train_pi0
    from cover_vla_tpu_torch.utils.tree import flatten

    params = pi0.init_pi0(7, cfg, device=dev)
    batch = to_device(torch, train_batch(np.random.default_rng(9), cfg, b,
                                         pad_rows=4), dev)
    mask = train_pi0.freeze_mask(params, train_expert_only=True)
    leaves, m = flatten(params), flatten(mask)
    n_train = sum(v.numel() for k, v in leaves.items() if m[k])
    n_all = sum(v.numel() for v in leaves.values())
    want = trainable_reckoning(cfg)
    log(f"train full width: {n_all / 1e9:.3f}B params, {n_train / 1e6:.3f}M "
        f"trainable expert-only (reckoned {want / 1e6:.3f}M: the expert "
        f"stack plus the projections), B = {b}, prefix "
        f"{cfg.prefix_len} tokens, remat | {card}")
    assert n_train == want, (n_train, want)
    frozen = {k: v.detach().clone() for k, v in leaves.items() if not m[k]}
    trained_before = {k: v.detach().clone() for k, v in leaves.items() if m[k]}
    # the role's defaults: lr 5e-5, 100 warmup steps of 1000
    schedule = optim.warmup_cosine(5e-5, 100, 1000)
    state = None
    for opt in ("adamw_8bit", "adamw"):
        del state
        gc.collect()
        tx = train_pi0.make_optimizer(schedule, optimizer=opt)
        state = train_pi0.init_partitioned_state(params, tx, mask)
        step = train_pi0.make_partitioned_train_step(cfg, tx, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state, secs, losses, norms = timed_steps(torch, step, state, batch, 6,
                                                 seed=100)
        peak = torch.cuda.max_memory_allocated() / 1e9
        # two more steps: a warm one, then one under the profiler
        held = [state]

        def one_step():
            held[0], _ = step(held[0], torch.Generator(device=dev)
                              .manual_seed(300), batch)
        profile_step(torch, card, f"train B={b}", one_step,
                     label=f"{opt} expert-only")
        state = held[0]
        log(f"train step {opt} expert-only B={b}: median of steps 2-6 "
            f"{np.median(secs[1:]) * 1e3:.1f} ms (steps "
            f"{[round(s * 1e3, 1) for s in secs]} ms), card peak "
            f"{peak:.2f} GB | {card}")
        log(f"  losses {[round(x, 5) for x in losses]}, grad norms "
            f"{[round(x, 5) for x in norms]}")
    after = flatten(state.params)
    assert all(torch.equal(v, after[k]) for k, v in frozen.items()), \
        "a frozen leaf changed"
    changed = {k: (after[k] != v).float().mean().item()
               for k, v in trained_before.items()}
    log(f"train full width: frozen leaves ({len(frozen)}) bit-equal; share "
        f"of changed elements per trained leaf after 12 steps: "
        f"{ {k: round(c, 4) for k, c in changed.items()} }")
    assert any(c > 0 for c in changed.values()), "no trained leaf changed"
    del state, frozen, trained_before
    gc.collect()
    torch.cuda.empty_cache()

    # the whole tree under adamw: gradients and bf16 moments for 3.24B
    tx = train_pi0.make_optimizer(schedule)
    every = {k: v.requires_grad_(True) for k, v in flatten(params).items()}
    full = train_pi0.TrainState(params, tx.init(every), optim.counter())
    full_step = train_pi0.make_train_step(cfg, tx)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full, secs, losses, norms = timed_steps(torch, full_step, full, batch, 2,
                                            seed=200)
    log(f"train step adamw whole tree ({n_all / 1e9:.3f}B trainable) B={b}: "
        f"{[round(s * 1e3, 1) for s in secs]} ms (the first includes the "
        f"allocator's growth), card peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, losses "
        f"{[round(x, 5) for x in losses]} | {card}")
    for k, v in flatten(params).items():
        v.requires_grad_(m[k])
    del full, every
    gc.collect()
    torch.cuda.empty_cache()
    return params, batch


def write_trajectories(root, n=2, frames=40, seed=11, hw=224):
    """npz trajectories as run.py reads them: hw x hw uint8 frames, 7-dim
    states and actions from a seed, a task string."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for i in range(n):
        np.savez(os.path.join(root, f"traj{i}.npz"),
                 images=rng.integers(0, 256, (frames, hw, hw, 3),
                                     dtype=np.uint8),
                 states=rng.standard_normal((frames, 7)).astype(np.float32),
                 actions=rng.uniform(-1, 1, (frames, 7)).astype(np.float32),
                 task=("put the carrot on the plate", "open the drawer")[i % 2])


def training_entry_point(torch, card, dev, cfg, tiny=False):
    """8c: run.main --role train at the width of `cfg` (Pi0Config() on the
    card; `tiny` for tiny_pi0_config()) with adamw_8bit, validation and
    checkpoints for 4 steps, then resumed to step 6; the restored state
    bit-equal to the saved one, metrics.jsonl with the JAX role's keys."""
    import gc
    import json
    import shutil
    import tempfile
    from cover_vla_tpu_torch import run
    from cover_vla_tpu_torch.convert import blob, checkpoints
    from cover_vla_tpu_torch.training import optim, train_pi0
    from cover_vla_tpu_torch.utils import param_bytes
    from cover_vla_tpu_torch.utils.tree import flatten

    tmp = tempfile.mkdtemp(prefix="cvla_train_")
    try:
        # another seed than the role's: every leaf must come from the file
        tx = train_pi0.make_optimizer(optim.warmup_cosine(5e-5, 100, 6),
                                      optimizer="adamw_8bit")
        target, _ = train_pi0.init_partitioned_train_state(43, cfg, tx,
                                                           device=dev)
        save_gb = sum(v.numel() * v.element_size()
                      for v in flatten(target._asdict()).values()) / 1e9
        usage = shutil.disk_usage(tmp)
        log(f"phase 8 disk: {tmp}: {usage.free / 1e9:.1f} GB free; a train "
            f"state is {save_gb:.2f} GB ({param_bytes(target.params) / 1e9:.2f}"
            f" GB of parameters), at most two at once")
        if usage.free < 2.2 * save_gb * 1e9:
            raise AssertionError(f"phase 8 needs {2.2 * save_gb:.1f} GB on "
                                 f"{tmp}, {usage.free / 1e9:.1f} GB are free")
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        write_trajectories(data, hw=cfg.vision.image_size)
        argv = ["--role", "train", "--train.tiny", str(tiny).lower(),
                "--train.dataset_dir", data,
                "--train.checkpoint_dir", ck, "--train.batch_size", "16",
                "--train.val_every", "2", "--train.val_batches", "1",
                "--train.save_every", "2", "--train.keep_last", "1",
                "--train.optimizer", "adamw_8bit"]
        t0 = time.perf_counter()
        run.main(argv + ["--train.num_steps", "4"], device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
        assert kept == ["step_00000004"], kept
        saved = blob.load_tree(os.path.join(ck, kept[0], checkpoints.BLOB_NAME))
        t0 = time.perf_counter()
        restored, at = checkpoints.restore_train_state(ck, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got, want = flatten(restored._asdict()), flatten(saved)
        assert at == 4 and set(got) == set(want)
        bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        assert not bad, f"restored leaves differ from the saved ones: {bad[:5]}"
        log(f"train entry point: run.main --role train, 4 steps of B=16 at "
            f"{'tiny' if tiny else 'full'} width (adamw_8bit, validation at "
            f"2 and 4, saves at 2 and "
            f"4, keep_last 1): {first_s:.1f} s; restored {len(want)} leaves "
            f"of step 4 into a fresh state in {restore_s:.2f} s, bit-equal "
            f"to the saved ones | {card}")
        del restored, target, got, want, saved
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run.main(argv + ["--train.num_steps", "6", "--train.resume", "true"],
                 device=dev)
        torch.cuda.synchronize()
        log(f"train entry point: resumed to step 6 in "
            f"{time.perf_counter() - t0:.1f} s")
        kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
        assert kept == ["step_00000006"], kept
        final = blob.load_tree(os.path.join(ck, kept[0], checkpoints.BLOB_NAME))
        assert int(final["step"]) == 6
        assert int(final["opt_state"]["1"]["count"]) == 6
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        keys = {frozenset(r) for r in recs}
        want_keys = {frozenset({"_time", "_step", "loss", "grad_norm"}),
                     frozenset({"_time", "_step", "val/acc@0.01",
                                "val/acc@0.05", "val/acc@0.1", "val/mae"})}
        assert keys == want_keys, keys
        steps = [(r["_step"], "val/mae" in r) for r in recs]
        # the JAX role logs the metrics of every 10th step (step 0 here)
        # and validates after steps 2, 4 and 6
        assert steps == [(0, False), (2, True), (4, True), (6, True)], steps
        for r in recs:
            assert all(math.isfinite(v) for k, v in r.items()), r
        log(f"train entry point: metrics.jsonl {len(recs)} records, "
            f"keys {sorted(set().union(*keys))}; last validation "
            f"{ {k: round(v, 4) for k, v in recs[-1].items() if k.startswith('val/')} }")
        del final
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert not os.path.exists(tmp)
    log(f"train entry point: {tmp} deleted")


def training_kernels(torch, card, dev, pcfg, params, batch):
    """8d: validate_pi0 on the trained weights under the all-kernel and the
    eager configs: launches a call, the predicted chunks within 1e-2, the
    accuracy dictionaries."""
    from cover_vla_tpu_torch.configs import VerifierConfig
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import decode_candidates
    from cover_vla_tpu_torch.models import pi0
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.training.validation import (
        DEFAULT_THRESHOLDS, validate_pi0)

    configs = kernel_configs(pcfg, VerifierConfig())
    b = batch["state"].shape[0]
    noise = torch.zeros((b, 1, pcfg.chunk_size, pcfg.max_action_dim),
                        device=dev)
    keys = ("images", "img_masks", "lang_tokens", "lang_masks", "state")
    out = {}
    for name in ("all_kernel", "eager"):
        cfg = configs[name][0]
        ca.reset_launch_counts()
        acc = validate_pi0(params, cfg, batch)
        counts = dict(ca.launch_counts)
        with torch.no_grad():
            chunk = pi0.sample_actions(params, cfg, *[batch[k] for k in keys],
                                       num_candidates=1, noise=noise)
        out[name] = (acc, counts, chunk)
        log(f"train kernels: validate_pi0 on the trained weights, {name}: "
            f"launches {counts}, {acc}")
    want = {"shared_prefix_gqa": pcfg.expert.depth * pcfg.num_denoise_steps,
            "mha_dense": pcfg.vision.depth,
            "prefix_gqa": pcfg.paligemma.depth}      # 180, 27, 18
    assert out["all_kernel"][1] == want, out["all_kernel"][1]
    assert out["eager"][1] == dict.fromkeys(want, 0), out["eager"][1]
    (ak, _, ck), (eg, _, ce) = out["all_kernel"], out["eager"]
    # phase 4's bounds hold the decoded execution actions (the first six
    # normalised dims scaled by the Bridge p01..p99 range) to FAST_ATOL and
    # the raw gripper to twice that; the raw 32-dim outputs are held to the
    # JAX package's fast-vs-exact bound (atol 0.05, rtol 0.1)
    stats = DatasetStatistics.from_json()
    lo, hi = (torch.tensor(np.asarray(x, np.float32), device=dev)
              for x in (stats.action.p01, stats.action.p99))
    (xk, _, gk), (xe, _, ge) = (decode_candidates(c[..., :7], lo, hi)
                                for c in (ck, ce))
    act_dev = (xk[..., :6] - xe[..., :6]).abs().max().item()
    grip_dev = (gk - ge).abs().max().item()
    raw = (ck - ce).abs()
    raw_ok = bool((raw <= 0.05 + 0.1 * ce.abs()).all())
    # an accuracy can change only through elements whose eager error lies
    # within their own deviation of a threshold
    gt = batch["actions"][:, None]
    keep = ~batch["actions_is_pad"][:, None, :, None].expand_as(raw)
    err = (ce - gt).abs()[keep]
    d = raw[keep]
    n = err.numel()
    flip_bound = {f"acc@{t}": ((err - t).abs() <= d).sum().item() / n
                  for t in DEFAULT_THRESHOLDS}
    acc_dev = {k: abs(ak[k] - eg[k]) for k in flip_bound}
    log(f"train kernels: all_kernel vs eager: decoded actions max |d| "
        f"{act_dev:.3e} (bound {FAST_ATOL}), raw gripper {grip_dev:.3e} "
        f"(bound {2 * FAST_ATOL}), raw outputs max |d| {raw.max().item():.3e} "
        f"(JAX bound atol 0.05 + rtol 0.1: {'held' if raw_ok else 'broken'}); "
        f"accuracies {'equal' if not any(acc_dev.values()) else 'differ'}: "
        f"{acc_dev} (bound: "
        f"errors within their deviation of the threshold, {flip_bound}), mae "
        f"by {abs(ak['mae'] - eg['mae']):.2e} | {card}")
    assert act_dev <= FAST_ATOL and grip_dev <= 2 * FAST_ATOL and raw_ok, \
        (act_dev, grip_dev)
    assert all(acc_dev[k] <= flip_bound[k] + 1e-12 for k in flip_bound), \
        (ak, eg, flip_bound)
    assert abs(ak["mae"] - eg["mae"]) <= raw.max().item()


def training_phase(torch, card, dev):
    from cover_vla_tpu_torch.configs import Pi0Config
    cfg = Pi0Config()
    training_small_reference(torch, dev)
    params, batch = training_full_width(torch, card, dev, cfg)
    training_entry_point(torch, card, dev, cfg)
    training_kernels(torch, card, dev, cfg, params, batch)


# ---------------------------------------------------------------------------
# phase 9: verifier and π0-FAST training
# ---------------------------------------------------------------------------

# Tiny card vs CPU (fp32 weights, TF32 off): losses within 1e-6 of
# themselves, the π0-FAST gradient norm within 1e-6 too; the members after
# each ensemble step within 1e-4 (10% of lr) and within 1e-5 in all but
# VTRAIN_SHARE of their elements, outside the attention key biases, which
# are held to one lr. A softmax is invariant to a key bias, so its
# gradient is rounding noise that Adam scales to a fraction of lr on both
# devices; an element whose gradient is near Adam's eps (1e-8) steps by
# g / (|g| + eps) of lr, which a 1e-9 difference in g moves (8 of the
# heads' 41,814 other elements beyond 1e-5 after the first step, the
# largest 2.9e-5, on the H100).
VTRAIN_REL = 1e-6
VTRAIN_SHARE = 1e-3
# kernel vs eager features: the JAX package's fast-vs-exact bound
FEAT_ATOL, FEAT_RTOL = 0.05, 0.1


def verifier_k2(vcfg) -> int:
    """K2's launches in one frozen-backbone verifier step or one retrieval
    probe: one per layer of the two towers (48 at full width)."""
    return vcfg.vision.depth + vcfg.text.depth


def verifier_batch(np_rng, vcfg, b):
    """Images in [-1, 1] at the tower's size, a full row of text tokens,
    action histories of 4-10 steps top-padded with the -5 fill."""
    s, t = vcfg.vision.image_size, vcfg.text.context_length
    hist = np_rng.uniform(-1, 1, (b, vcfg.history_length, vcfg.action_dim)
                          ).astype(np.float32)
    for i, n in enumerate(np_rng.integers(4, vcfg.history_length + 1, b)):
        hist[i, :vcfg.history_length - n] = vcfg.action_padding_value
    return {"images": np_rng.uniform(-1, 1, (b, s, s, 3)).astype(np.float32),
            "text_tokens": np_rng.integers(1, min(1000, vcfg.text.vocab_size),
                                           (b, t)).astype(np.int32),
            "action_histories": hist}


def candidate_batch(np_rng, vcfg, b, n):
    """The ranking objectives' batch: N candidates per state (pos_traj
    and N - 1 neg_trajs for the ranking loss, cand_trajs and qualities
    for the listwise and regression losses)."""
    batch = verifier_batch(np_rng, vcfg, b)
    shape = (b, n, vcfg.history_length, vcfg.action_dim)
    cands = np_rng.uniform(-1, 1, shape).astype(np.float32)
    batch.update(pos_traj=batch.pop("action_histories"),
                 neg_trajs=cands[:, 1:], cand_trajs=cands,
                 qualities=np_rng.uniform(0, 1, (b, n)).astype(np.float32))
    return batch


def fast_batch(np_rng, cfg, b, hw=None):
    """A π0-FAST batch through make_fast_batch: uint8 frames, 7-dim states
    and action chunks from a seed, the hash tokenizer's prompts, padded to
    max_input_seq_len tokens."""
    from cover_vla_tpu_torch.data.tokenizer import make_policy_tokenizer
    from cover_vla_tpu_torch.training.train_pi0fast import make_fast_batch
    hw = hw or cfg.vision.image_size
    frames = {"image": np_rng.integers(0, 256, (b, hw, hw, 3), dtype=np.uint8),
              "state": np_rng.uniform(-1, 1, (b, 7)).astype(np.float32),
              "actions": np_rng.uniform(-1, 1, (b, cfg.chunk_size, 7)
                                        ).astype(np.float32),
              "task": ["put the carrot on the plate"] * b}
    return make_fast_batch(frames, make_policy_tokenizer(
        cfg.paligemma.vocab_size), cfg)


def member_divergence(torch, got, want, lr):
    """(share beyond TRAIN_PARAM_ATOL and largest difference outside the
    attention key biases, largest key-bias difference, within the
    bounds) of two flat trees."""
    diff = {k: (got[k].float().cpu() - want[k].float().cpu()).abs().reshape(-1)
            for k in want}
    kb = [k for k in diff if k.endswith("attn.k.bias")]
    rest = torch.cat([d for k, d in diff.items() if k not in kb])
    key_bias = max((diff[k].max().item() for k in kb), default=0.0)
    share = (rest > TRAIN_PARAM_ATOL).float().mean().item()
    ok = share <= VTRAIN_SHARE and rest.max().item() <= 1e-4 and key_bias <= lr
    return share, rest.max().item(), key_bias, ok


def fresh_tree(torch, base, dev):
    """A copy of a tree on `dev` that shares no storage with `base`."""
    from cover_vla_tpu_torch.models.params import ParamTree
    from cover_vla_tpu_torch.utils.tree import flatten, unflatten
    return ParamTree(unflatten({k: v.detach().clone().to(dev)
                                for k, v in flatten(base).items()}))


def vtrain_small_reference(torch, dev):
    """9.1: the tiny verifier (fp32, 3 members) through 3 ensemble AdamW
    steps, one step each of the ranking, listwise and regression
    objectives, and the tiny π0-FAST's token_ce_loss with its gradient
    norm, on the card and on the CPU from the same trees and batches."""
    from cover_vla_tpu_torch.configs import tiny_verifier_config
    from cover_vla_tpu_torch.models import pi0fast, verifier
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.training import train_verifier as tv
    from cover_vla_tpu_torch.utils.tree import cast_tree, flatten

    vcfg, lr = tiny_verifier_config(), 1e-3
    base = cast_tree(verifier.init_verifier(0, vcfg, 3, device="cpu"),
                     torch.float32)
    rng = np.random.default_rng(91)
    batch, cands = verifier_batch(rng, vcfg, 6), candidate_batch(rng, vcfg,
                                                                 4, 5)
    runs = {}
    for d in ("cpu", dev):
        tree = fresh_tree(torch, base, d)
        members = tree["members"]
        tx = optim.make_adamw(optim.linear_warmup(lr, 0))
        state = tv.VerifierTrainState(
            members, tx.init({k: v.requires_grad_(True) for k, v in
                              flatten(members).items()}), optim.counter())
        step = tv.make_ensemble_train_step(vcfg, tx)
        out = []
        for _ in range(3):
            state, m = step(state, tree["backbone"], to_device(torch, batch, d))
            out.append((m["loss"].item(), m["grad_norm"].item(),
                        {k: v.detach().to("cpu", copy=True)
                         for k, v in flatten(state.members).items()}))
        objectives = {}
        for name, make in (("ranking", tv.make_ranking_train_step),
                           ("listwise", tv.make_listwise_train_step),
                           ("regression", tv.make_regression_train_step)):
            full = fresh_tree(torch, base, d)
            ftx = optim.make_adamw(optim.linear_warmup(lr, 0))
            fstate = tv.FullVerifierTrainState(
                full, ftx.init({k: v.requires_grad_(True) for k, v in
                                flatten(full).items()}), optim.counter())
            _, fm = make(vcfg, ftx)(fstate, to_device(torch, cands, d))
            objectives[name] = fm["loss"].item()
        runs[str(d)] = (out, objectives)
    (c_out, c_obj), (g_out, g_obj) = runs["cpu"], runs[str(dev)]
    for i, (c, g) in enumerate(zip(c_out, g_out)):
        d_loss = abs(g[0] - c[0]) / abs(c[0])
        d_norm = abs(g[1] - c[1]) / abs(c[1])
        share, worst, key_bias, ok = member_divergence(torch, g[2], c[2], lr)
        log(f"verifier train small reference: ensemble step {i + 1}: loss "
            f"card {g[0]:.7f} cpu {c[0]:.7f} (rel {d_loss:.2e}), grad_norm "
            f"rel {d_norm:.2e}; members beyond {TRAIN_PARAM_ATOL:g} outside "
            f"the key biases {share:.2e} (largest {worst:.2e}), key biases "
            f"largest {key_bias:.2e}")
        assert d_loss <= VTRAIN_REL and ok, (i, d_loss, share, worst, key_bias)
        assert d_norm <= 1e-4, (i, d_norm)
    for name in c_obj:
        rel = abs(g_obj[name] - c_obj[name]) / abs(c_obj[name])
        log(f"verifier train small reference: {name} step loss card "
            f"{g_obj[name]:.7f} cpu {c_obj[name]:.7f} (rel {rel:.2e})")
        assert rel <= VTRAIN_REL, (name, rel)

    fcfg = pi0fast.tiny_pi0fast_config()
    fbase = cast_tree(pi0fast.init_pi0fast(0, fcfg, device="cpu"),
                      torch.float32)
    fbatch = fast_batch(np.random.default_rng(92), fcfg, 3)
    got = {}
    for d in ("cpu", dev):
        tree = fresh_tree(torch, fbase, d)
        leaves = {k: v.requires_grad_(True) for k, v in flatten(tree).items()}
        b = to_device(torch, fbatch, d)
        loss = pi0fast.token_ce_loss(tree, fcfg, b["images"], b["img_masks"],
                                     b["tokens"], b["pad_mask"],
                                     b["suffix_mask"])
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        got[str(d)] = (loss.item(), optim.global_norm(
            {k: g for k, g in zip(leaves, grads) if g is not None}).item())
    (cl, cn), (gl, gn) = got["cpu"], got[str(dev)]
    d_loss, d_norm = abs(gl - cl) / abs(cl), abs(gn - cn) / abs(cn)
    log(f"π0-FAST small reference: token_ce_loss card {gl:.7f} cpu {cl:.7f} "
        f"(rel {d_loss:.2e}), gradient norm card {gn:.6f} cpu {cn:.6f} (rel "
        f"{d_norm:.2e})")
    assert d_loss <= VTRAIN_REL and d_norm <= VTRAIN_REL, (d_loss, d_norm)


def verifier_trainable_reckoning(vcfg, members: int) -> int:
    """The trainable heads of `members` members, from the config."""
    linear = lambda i, o: i * o + o
    d = vcfg.vision_pooling_output_dim

    def pooling(kv, out):
        inter = out // vcfg.num_readouts
        layer = (2 * inter + 2 * linear(inter, inter) + 2 * linear(kv, inter)
                 + 2 * inter + linear(inter, out) + linear(out, inter))
        return (vcfg.num_readouts * inter + vcfg.pooling_layers * layer
                + 2 * inter)

    traj = vcfg.traj_layers * (4 * linear(d, d) + 4 * d + linear(d, 2 * d)
                               + linear(2 * d, d))
    one = (2 + pooling(vcfg.text.embed_dim, vcfg.text_pooling_output_dim)
           + pooling(vcfg.vision.width, d) + linear(vcfg.fused_dim, d)
           + linear(vcfg.action_dim, d) + traj)
    return members * one


def verifier_logits(torch, vcfg, members, feats, action_histories):
    """Each member's training logits [M, B, B] (exp(logit_scale) it.ac)."""
    from cover_vla_tpu_torch.models import verifier
    it = verifier.member_image_text_embed(members, vcfg, feats)
    ac = verifier.member_action_embed(members, vcfg, action_histories)
    return (torch.exp(members["logit_scale"])[:, None, None]
            * torch.einsum("mbd,mnd->mbn", it, ac))


def topk_flip_bound(torch, eager_logits, dev_max: float) -> float:
    """The most a member-mean top-k accuracy may move when every logit
    moves by at most dev_max: the member mean of the share of rows (each
    direction) in which some other logit lies within 2 dev_max of the
    label's."""
    bounds = []
    for l in (eager_logits, eager_logits.transpose(-1, -2)):
        diag = torch.diagonal(l, dim1=-2, dim2=-1)[..., None]
        near = ((l - diag).abs() <= 2 * dev_max)
        near = near & ~torch.eye(l.shape[-1], dtype=torch.bool,
                                 device=l.device)
        bounds.append(near.any(dim=-1).float().mean(dim=-1).mean().item())
    return max(bounds)


def compare_verifier_metrics(torch, what, eager, kernel, eager_logits,
                             kernel_logits):
    """Kernel vs eager training metrics: loss and member losses within
    SCORE_ATOL, grad_norm within SCORE_ATOL of itself, the logit scale
    equal, and each top-k accuracy within the share of rows a logit
    deviation could reorder."""
    dev_max = (kernel_logits - eager_logits).abs().max().item()
    flip = topk_flip_bound(torch, eager_logits, dev_max)
    diffs = {k: (kernel[k] - eager[k]).abs().max().item() for k in eager}
    log(f"{what}: kernel vs eager: logits max |d| {dev_max:.3e}; "
        + ", ".join(f"{k} {v:.3e}" for k, v in diffs.items())
        + f"; top-k flip bound {flip:.4f}")
    for k, v in diffs.items():
        if k.startswith("top"):
            assert v <= flip + 1e-6, (what, k, v, flip)
        elif k == "grad_norm":
            assert v <= SCORE_ATOL * eager[k].abs().item(), (what, k, v)
        elif k == "logit_scale":
            assert v == 0, (what, k, v)
        else:
            assert v <= SCORE_ATOL, (what, k, v)


def vtrain_full_width(torch, card, dev, vcfg, b=32):
    """9.2: the frozen-backbone ensemble step at full width (3 members,
    B = 32, the role's AdamW under linear warmup) under the eager and the
    kernel config in turns: step times, card peak, device-busy share,
    trainable count, K2's launches; kernel vs eager features, metrics and
    members after one step; the backbone bit-equal. Returns the verifier
    tree."""
    from cover_vla_tpu_torch.configs import fast_verifier_config
    from cover_vla_tpu_torch.models import verifier
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.training import train_verifier as tv
    from cover_vla_tpu_torch.utils.tree import flatten

    params = verifier.init_verifier(11, vcfg, 3, device=dev)
    backbone, members = params["backbone"], params["members"]
    leaves = flatten(members)
    n_train = sum(v.numel() for v in leaves.values())
    want = verifier_trainable_reckoning(vcfg, 3)
    log(f"verifier train full width: {sum(v.numel() for v in flatten(params).values()) / 1e9:.3f}B "
        f"params, {n_train / 1e6:.3f}M trainable (3 members' heads; reckoned "
        f"{want / 1e6:.3f}M from the config), B = {b}, "
        f"{vcfg.vision.image_size}² images, {vcfg.text.context_length} text "
        f"tokens | {card}")
    assert n_train == want, (n_train, want)
    start = {k: v.detach().clone() for k, v in leaves.items()}
    frozen = {k: v.clone() for k, v in flatten(backbone).items()}
    batch = to_device(torch, verifier_batch(np.random.default_rng(93), vcfg,
                                            b), dev)
    configs = {"eager": vcfg, "kernel": fast_verifier_config(vcfg)}
    feats, logits = {}, {}
    with torch.no_grad():
        for name, cfg in configs.items():
            ca.reset_launch_counts()
            feats[name] = verifier.extract_features(
                params, cfg, batch["images"], batch["text_tokens"])
            assert ca.launch_counts["mha_dense"] == (
                verifier_k2(vcfg) if name == "kernel" else 0), ca.launch_counts
            logits[name] = verifier_logits(torch, vcfg, members, feats[name],
                                           batch["action_histories"])
    for part in ("patch", "text"):
        e, k = getattr(feats["eager"], part), getattr(feats["kernel"], part)
        d = (k - e).abs()
        ok = bool((d <= FEAT_ATOL + FEAT_RTOL * e.abs()).all())
        log(f"verifier train full width: kernel vs eager {part} features "
            f"{tuple(e.shape)}: max |d| {d.max().item():.3e} (JAX bound atol "
            f"{FEAT_ATOL} + rtol {FEAT_RTOL}: {'held' if ok else 'broken'})")
        assert ok, part
    del feats
    first = {}
    for name in ("eager", "kernel", "kernel", "eager"):
        cfg = configs[name]
        with torch.no_grad():
            for k, v in leaves.items():
                v.copy_(start[k])
        tx = optim.make_adamw(optim.linear_warmup(5e-5, 100))
        state = tv.VerifierTrainState(members, tx.init(leaves),
                                      optim.counter())
        step = tv.make_ensemble_train_step(cfg, tx)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs, launches, losses = [], [], []
        for i in range(6):
            ca.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, backbone, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            launches.append(ca.launch_counts["mha_dense"])
            losses.append(m["loss"].item())
            if i == 0 and name not in first:
                first[name] = ({k: v.detach().clone() for k, v in m.items()},
                               {k: v.detach().clone() for k, v in
                                leaves.items()})
        peak = torch.cuda.max_memory_allocated() / 1e9
        held = [state]

        def one_step():
            held[0], _ = step(held[0], backbone, batch)
        prof = profile_step(torch, card, f"verifier train B={b}", one_step,
                            label=name)
        log(f"verifier train step {name}: median of steps 2-6 "
            f"{np.median(secs[1:]) * 1e3:.1f} ms (steps "
            f"{[round(x * 1e3, 1) for x in secs]} ms), card peak {peak:.2f} "
            f"GB, device busy share {prof['busy_ms'] / prof['wall_ms']:.3f}, "
            f"K2 launches a step {launches}, losses "
            f"{[round(x, 5) for x in losses]} | {card}")
        assert all(math.isfinite(x) for x in losses), losses
        assert launches == [verifier_k2(vcfg) if name == "kernel" else 0] * 6, \
            launches
    (em, emembers), (km, kmembers) = first["eager"], first["kernel"]
    compare_verifier_metrics(torch, "verifier train step 1", em, km,
                             logits["eager"], logits["kernel"])
    dm = max((kmembers[k] - emembers[k]).abs().max().item() for k in emembers)
    log(f"verifier train step 1: kernel vs eager members max |d| {dm:.3e} "
        f"(bound {TRAIN_PARAM_ATOL:g})")
    assert dm <= TRAIN_PARAM_ATOL, dm
    after = flatten(backbone)
    assert all(torch.equal(after[k], v) for k, v in frozen.items()), \
        "the frozen backbone changed"
    log(f"verifier train full width: the backbone ({len(frozen)} leaves) "
        f"bit-equal after {4 * 8} steps")
    return params


def vtrain_backbone_steps(torch, card, dev, vcfg, params):
    """9.3: the whole verifier trained (eager): one make_full_train_step
    at B = 16, refused under the kernel config; then the ranking (15
    negatives), listwise and regression (16 candidates) steps at B = 32
    with train_backbone=False. Step times and card peaks."""
    import gc
    from cover_vla_tpu_torch.configs import fast_verifier_config
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.training import train_verifier as tv
    from cover_vla_tpu_torch.utils.tree import flatten

    rng = np.random.default_rng(94)
    tx = optim.make_adamw(optim.linear_warmup(5e-5, 100))
    leaves = flatten(params)
    state = tv.FullVerifierTrainState(params, tx.init(leaves),
                                      optim.counter())
    n_all = sum(v.numel() for v in leaves.values())
    runs = [("full", tv.make_full_train_step(vcfg, tx),
             verifier_batch(rng, vcfg, 16))]
    cands16 = candidate_batch(rng, vcfg, 32, 16)
    runs += [("ranking, 15 negatives", tv.make_ranking_train_step(
                  vcfg, tx, train_backbone=False), candidate_batch(
                  rng, vcfg, 32, 16)),
             ("listwise, 16 candidates", tv.make_listwise_train_step(
                 vcfg, tx, train_backbone=False), cands16),
             ("regression, 16 candidates", tv.make_regression_train_step(
                 vcfg, tx, train_backbone=False), cands16)]
    for name, step, np_batch in runs:
        batch = to_device(torch, np_batch, dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        secs, losses = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
        assert all(math.isfinite(x) for x in losses), (name, losses)
        log(f"verifier train {name} (whole tree {n_all / 1e9:.3f}B, "
            f"{'backbone trained' if name == 'full' else 'train_backbone=False'}"
            f") B={batch['images'].shape[0]}: steps "
            f"{[round(x * 1e3, 1) for x in secs]} ms (the first includes the "
            f"allocator's growth), card peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, losses "
            f"{[round(x, 5) for x in losses]} | {card}")
        if name == "full":
            kstep = tv.make_full_train_step(fast_verifier_config(vcfg), tx)
            try:
                kstep(state, batch)
            except RuntimeError as e:
                assert "no backward pass" in str(e), e
                log(f"verifier train full step under the kernel config: "
                    f"refused ({e})")
            else:
                raise AssertionError("the kernel-config full step ran")
    for v in flatten(params).values():
        v.requires_grad_(False)
    del state, runs
    gc.collect()
    torch.cuda.empty_cache()


def vtrain_eval_and_retrieval(torch, card, dev, vcfg, params, probes=32,
                              pool=20):
    """9.4: ensemble_eval_metrics on a held-out batch and retrieval_test
    over `probes` probes with pools of `pool`, eager and kernel: metrics,
    every probe's scores within SCORE_ATOL, ranks differing only across
    eager gaps below it, K2's launches per probe."""
    from cover_vla_tpu_torch.configs import fast_verifier_config
    from cover_vla_tpu_torch.eval.verifier_retrieval import (
        display_results, retrieval_test)
    from cover_vla_tpu_torch.models import verifier
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.training.train_verifier import (
        ensemble_eval_metrics)

    configs = {"eager": vcfg, "kernel": fast_verifier_config(vcfg)}
    batch = to_device(torch, verifier_batch(np.random.default_rng(95), vcfg,
                                            32), dev)
    metrics, logits = {}, {}
    for name, cfg in configs.items():
        ca.reset_launch_counts()
        metrics[name] = ensemble_eval_metrics(params["members"], cfg,
                                              params["backbone"], batch)
        assert ca.launch_counts["mha_dense"] == (
            verifier_k2(vcfg) if name == "kernel" else 0), ca.launch_counts
        with torch.no_grad():
            feats = verifier.extract_features(params, cfg, batch["images"],
                                              batch["text_tokens"])
            logits[name] = verifier_logits(torch, vcfg, params["members"],
                                           feats, batch["action_histories"])
    log(f"verifier validation: eager {({k: round(v.item(), 5) for k, v in metrics['eager'].items()})}")
    compare_verifier_metrics(torch, "verifier validation", metrics["eager"],
                             metrics["kernel"], logits["eager"],
                             logits["kernel"])

    data = verifier_batch(np.random.default_rng(96), vcfg, probes)
    results, scores = {}, {}
    for name, cfg in configs.items():
        ca.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[name] = retrieval_test(params, cfg, data["images"],
                                       data["text_tokens"],
                                       data["action_histories"],
                                       pool_size=pool, seed=5)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k2 = ca.launch_counts["mha_dense"]
        log(f"verifier retrieval {name}: {probes} probes, pool {pool}, "
            f"{wall:.2f} s, K2 launches {k2} ({k2 / probes:g} a probe); "
            + display_results(results[name]).replace("\n", ";"))
        assert k2 == (verifier_k2(vcfg) * probes if name == "kernel" else 0), k2
        # every probe's scores, over the harness's own pools
        rng = np.random.default_rng(5)
        per = []
        with torch.no_grad():
            for i in range(probes):
                others = [j for j in range(probes) if j != i]
                idx = np.concatenate([[i], rng.choice(
                    others, size=min(pool - 1, len(others)), replace=False)])
                per.append(verifier.score_actions(
                    params, cfg, torch.from_numpy(data["images"][i:i + 1]).to(dev),
                    torch.from_numpy(data["text_tokens"][i:i + 1]).to(dev),
                    torch.from_numpy(data["action_histories"][idx]).to(dev)
                ).cpu().numpy())
        scores[name] = np.stack(per)
        ranks = [int(np.where(np.argsort(-s) == 0)[0][0]) for s in per]
        assert results[name]["mean_rank"] == float(np.mean(ranks))
    e, k = scores["eager"], scores["kernel"]
    dev_max = float(np.abs(k - e).max())
    e_rank = (e > e[:, :1]).sum(axis=1)
    k_rank = (k > k[:, :1]).sum(axis=1)
    gap = np.abs(e[:, 1:] - e[:, :1]).min(axis=1)
    moved = e_rank != k_rank
    log(f"verifier retrieval: kernel vs eager scores max |d| {dev_max:.3e} "
        f"(bound {SCORE_ATOL}); ground-truth ranks differ in "
        f"{int(moved.sum())} of {probes} probes (eager gaps there "
        f"{np.round(gap[moved], 5).tolist()}, bound {SCORE_ATOL}) | {card}")
    assert dev_max <= SCORE_ATOL, dev_max
    assert (gap[moved] < SCORE_ATOL).all(), gap[moved]


def write_bridge_dataset(root, n=96, hw=256, seed=12):
    """A normalized Bridge-verifier JSON of n samples: .npy uint8 frames,
    two instructions, action histories of 4-10 steps."""
    from cover_vla_tpu_torch.data.bridge_verifier_dataset import (
        save_normalized_dataset)
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    samples = []
    for i in range(n):
        np.save(os.path.join(root, f"img{i}.npy"),
                rng.integers(0, 256, (hw, hw, 3), dtype=np.uint8))
        samples.append({"image": f"img{i}.npy",
                        "instruction": ("put the carrot on the plate",
                                        "open the drawer")[i % 2],
                        "action_history": rng.uniform(
                            -1, 1, (int(rng.integers(4, 11)), 7))})
    save_normalized_dataset(os.path.join(root, "dataset.json"), samples)


def check_disk(tmp, need_bytes, what):
    import shutil
    free = shutil.disk_usage(tmp).free
    log(f"{what} disk: {tmp}: {free / 1e9:.1f} GB free, needs at most "
        f"{need_bytes / 1e9:.2f} GB at once")
    if free < 1.1 * need_bytes:
        raise AssertionError(f"{what} needs {need_bytes / 1e9:.1f} GB on "
                             f"{tmp}, {free / 1e9:.1f} GB are free")


def vtrain_entry_point(torch, card, dev, tiny=False, b=32):
    """9.5: run.main --role train_verifier over a written bridge JSON of
    96 samples, 6 steps with validation every 2, then resumed to 8:
    best/, the merged ensemble read back bit-equal, the restored train
    state bit-equal to the saved one; the seconds of each stage."""
    import gc
    import json
    import shutil
    import tempfile
    from cover_vla_tpu_torch import run
    from cover_vla_tpu_torch.configs import (
        VerifierConfig, tiny_verifier_config)
    from cover_vla_tpu_torch.convert import blob, checkpoints
    from cover_vla_tpu_torch.convert.verifier_from_torch import (
        convert_merged_checkpoint)
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.training import train_verifier as tv
    from cover_vla_tpu_torch.utils import param_bytes
    from cover_vla_tpu_torch.utils.tree import flatten

    vcfg = tiny_verifier_config() if tiny else VerifierConfig()
    tmp = tempfile.mkdtemp(prefix="cvla_vtrain_")
    try:
        tx = optim.make_adamw(optim.linear_warmup(5e-5, 100))
        backbone, state = tv.init_train_state(44, vcfg, tx, num_members=3,
                                              device=dev)
        target = tv.VerifierCheckpoint(state.members, state.opt_state,
                                       backbone)
        save_b = sum(v.numel() * v.element_size()
                     for v in flatten(target._asdict()).values())
        # two train states (a save and its rotation), best/ and the .pt
        check_disk(tmp, 3 * save_b + param_bytes(state.members), "phase 9.5")
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        write_bridge_dataset(data, hw=64 if tiny else 256)
        write_s = time.perf_counter() - t0
        argv = ["--role", "train_verifier", "--train.tiny", str(tiny).lower(),
                "--train.dataset_dir", data, "--train.checkpoint_dir", ck,
                "--train.batch_size", str(b), "--train.val_every", "2",
                "--train.keep_last", "1"]
        t0 = time.perf_counter()
        run.main(argv + ["--train.num_steps", "6"], device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
        assert kept == ["step_00000006"], kept
        assert os.path.isfile(os.path.join(ck, "best", checkpoints.BLOB_NAME))
        saved = blob.load_tree(os.path.join(ck, kept[0], checkpoints.BLOB_NAME))
        t0 = time.perf_counter()
        merged = convert_merged_checkpoint(
            os.path.join(ck, "merged_ensemble.pt"), vcfg, device=dev)
        torch.cuda.synchronize()
        merged_s = time.perf_counter() - t0
        got, want = flatten(merged["members"]), flatten(saved["members"])
        assert set(got) == set(want)
        assert all(torch.equal(got[k].cpu(), want[k]) for k in want), \
            "the merged ensemble's members differ from the saved ones"
        t0 = time.perf_counter()
        restored, at = checkpoints.restore_train_state(ck, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got, want = flatten(restored._asdict()), flatten(saved)
        assert at == 6 and set(got) == set(want)
        bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        assert not bad, f"restored leaves differ from the saved ones: {bad[:5]}"
        del restored, target, state, backbone, got, want, merged
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run.main(argv + ["--train.num_steps", "8", "--train.resume", "true"],
                 device=dev)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        final = blob.load_tree(os.path.join(checkpoints.latest_checkpoint(ck),
                                             checkpoints.BLOB_NAME))
        assert int(final["opt_state"]["1"]["count"]) == 8
        with open(os.path.join(ck, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        val = [(r["_step"], round(r["val/top1_i2a"], 4)) for r in recs
               if "val/top1_i2a" in r]
        assert [s for s, _ in val] == [2, 4, 6, 8], val
        log(f"verifier train entry point: run.main --role train_verifier at "
            f"{'tiny' if tiny else 'full'} width, 96 samples ({'64' if tiny else '256'}² "
            f".npy frames, written in {write_s:.1f} s), B={b}, 3 members: 6 "
            f"steps with validation at 2, 4, 6 {first_s:.1f} s; merged "
            f"ensemble read back in {merged_s:.2f} s, members bit-equal; a "
            f"{save_b / 1e9:.2f} GB train state restored in {restore_s:.2f} "
            f"s, {len(flatten(saved))} leaves bit-equal; resumed to 8 in "
            f"{resume_s:.1f} s; val top1_i2a {val} | {card}")
        del final, saved
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert not os.path.exists(tmp)


def fast_trainable_reckoning(cfg) -> int:
    """Every leaf of π0-FAST: the vision tower, mm_proj and PaliGemma."""
    v, g = cfg.vision, cfg.paligemma
    linear = lambda i, o: i * o + o
    p = v.patch_size * v.patch_size * 3
    block = (4 * v.width + 4 * linear(v.width, v.width)
             + linear(v.width, v.mlp_dim) + linear(v.mlp_dim, v.width))
    vision = linear(p, v.width) + v.num_patches * v.width \
        + v.depth * block + 2 * v.width
    qd, kvd = g.num_heads * g.head_dim, g.num_kv_heads * g.head_dim
    layer = (2 * g.width + g.width * qd + 2 * g.width * kvd + qd * g.width
             + 3 * g.width * g.mlp_dim)
    return (vision + linear(v.width, g.width) + g.depth * layer + g.width
            + g.vocab_size * g.width)


def fast_train_full_width(torch, card, dev, cfg, b=8):
    """9.6: π0-FAST at full width, the whole tree, B = 8, one image, 256
    input tokens: AdamW, then 8-bit AdamW: step time (median of steps
    2-6), card peak, device-busy share, trainable count."""
    import gc
    from cover_vla_tpu_torch.training import optim, train_pi0, train_pi0fast
    from cover_vla_tpu_torch.utils.tree import flatten

    batch = to_device(torch, fast_batch(np.random.default_rng(97), cfg, b),
                      dev)
    n_tok = int(batch["pad_mask"].sum(dim=1).float().mean().item())
    for opt in ("adamw", "adamw_8bit"):
        tx = train_pi0.make_optimizer(optim.warmup_cosine(5e-5, 100, 1000),
                                      optimizer=opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = train_pi0fast.init_train_state(8, cfg, tx, device=dev)
        n_train = sum(v.numel() for v in flatten(state.params).values())
        assert n_train == fast_trainable_reckoning(cfg), n_train
        step = train_pi0fast.make_train_step(cfg, tx)
        secs, losses = [], []
        for _ in range(6):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            losses.append(m["loss"].item())
        peak = torch.cuda.max_memory_allocated() / 1e9
        held = [state]

        def one_step():
            held[0], _ = step(held[0], batch)
        prof = profile_step(torch, card, f"π0-FAST train B={b}", one_step,
                            label=opt)
        state = held[0]
        log(f"π0-FAST train step {opt}, whole tree ({n_train / 1e9:.3f}B "
            f"trainable, equal to the config's reckoning), B={b}, "
            f"{cfg.vision.num_patches} image + {cfg.max_input_seq_len} input "
            f"tokens ({n_tok} real on average): median of steps 2-6 "
            f"{np.median(secs[1:]) * 1e3:.1f} ms (steps "
            f"{[round(x * 1e3, 1) for x in secs]} ms), card peak {peak:.2f} "
            f"GB, device busy share {prof['busy_ms'] / prof['wall_ms']:.3f}, "
            f"losses {[round(x, 5) for x in losses]} | {card}")
        assert all(math.isfinite(x) for x in losses), losses
        del state, held, step, tx
        gc.collect()
        torch.cuda.empty_cache()


def write_rlds_episodes(root, n=2, frames=40, hw=256, seed=13):
    """One raw-image RLDS shard of n episodes (no PIL needed)."""
    from cover_vla_tpu_torch.data.rlds import write_rlds_shard
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    eps = [{"images": rng.integers(0, 256, (frames, hw, hw, 3), dtype=np.uint8),
            "states": rng.standard_normal((frames, 7)).astype(np.float32),
            "actions": rng.uniform(-1, 1, (frames, 7)).astype(np.float32),
            "task": ("put the carrot on the plate", "open the drawer")[i % 2]}
           for i in range(n)]
    write_rlds_shard(os.path.join(root, "fix.tfrecord-00000-of-00001"), eps,
                     image_format="raw")


def fast_train_entry_point(torch, card, dev, cfg, tiny=False, b=8):
    """9.7: run.main --role train_pi0fast over one raw-image RLDS shard
    (--train.data_format rlds), adamw_8bit, 4 steps, then resumed to 6:
    the restored state bit-equal to the saved one; stage seconds."""
    import gc
    import shutil
    import tempfile
    from cover_vla_tpu_torch import run
    from cover_vla_tpu_torch.convert import blob, checkpoints
    from cover_vla_tpu_torch.training import optim, train_pi0, train_pi0fast
    from cover_vla_tpu_torch.utils.tree import flatten

    tmp = tempfile.mkdtemp(prefix="cvla_fasttrain_")
    try:
        tx = train_pi0.make_optimizer(optim.warmup_cosine(5e-5, 100, 6),
                                      optimizer="adamw_8bit")
        target = train_pi0fast.init_train_state(45, cfg, tx, device=dev)
        save_b = sum(v.numel() * v.element_size()
                     for v in flatten(target._asdict()).values())
        check_disk(tmp, 2.1 * save_b, "phase 9.7")
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        write_rlds_episodes(data, hw=64 if tiny else 256)
        argv = ["--role", "train_pi0fast", "--train.tiny", str(tiny).lower(),
                "--train.data_format", "rlds", "--train.dataset_dir", data,
                "--train.checkpoint_dir", ck, "--train.batch_size", str(b),
                "--train.optimizer", "adamw_8bit", "--train.keep_last", "1"]
        t0 = time.perf_counter()
        run.main(argv + ["--train.num_steps", "4"], device=dev)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        kept = [os.path.basename(p) for p in checkpoints.list_checkpoints(ck)]
        assert kept == ["step_00000004"], kept
        saved = blob.load_tree(os.path.join(ck, kept[0], checkpoints.BLOB_NAME))
        t0 = time.perf_counter()
        restored, at = checkpoints.restore_train_state(ck, target)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got, want = flatten(restored._asdict()), flatten(saved)
        assert at == 4 and set(got) == set(want)
        bad = [k for k in want if not torch.equal(got[k].cpu(), want[k])]
        assert not bad, f"restored leaves differ from the saved ones: {bad[:5]}"
        del restored, target, got, want, saved
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        run.main(argv + ["--train.num_steps", "6", "--train.resume", "true"],
                 device=dev)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        final = blob.load_tree(os.path.join(checkpoints.latest_checkpoint(ck),
                                             checkpoints.BLOB_NAME))
        assert int(final["step"]) == 6
        assert int(final["opt_state"]["1"]["count"]) == 6
        log(f"π0-FAST train entry point: run.main --role train_pi0fast at "
            f"{'tiny' if tiny else 'full'} width over one raw-image RLDS shard "
            f"(2 x 40 frames), B={b}, adamw_8bit: 4 steps and a save "
            f"{first_s:.1f} s; a {save_b / 1e9:.2f} GB train state restored in "
            f"{restore_s:.2f} s, bit-equal; resumed to 6 in {resume_s:.1f} s "
            f"| {card}")
        del final
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    assert not os.path.exists(tmp)


def training_phase_9(torch, card, dev):
    import gc
    from cover_vla_tpu_torch.configs import VerifierConfig
    from cover_vla_tpu_torch.models.pi0fast import Pi0FastConfig
    vcfg = VerifierConfig()
    vtrain_small_reference(torch, dev)
    params = vtrain_full_width(torch, card, dev, vcfg)
    vtrain_eval_and_retrieval(torch, card, dev, vcfg, params)
    vtrain_backbone_steps(torch, card, dev, vcfg, params)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    vtrain_entry_point(torch, card, dev)
    fcfg = Pi0FastConfig()
    fast_train_full_width(torch, card, dev, fcfg)
    fast_train_entry_point(torch, card, dev, fcfg)


# ---------------------------------------------------------------------------
# phase 10: multi-process (parallel/*, the sharded step, FSDP / DDP,
# torchrun launches)
# ---------------------------------------------------------------------------

# the 2-process gloo parity on the host's CPU: tests/test_torch_training.py's
# shares, after the third 8-bit step tests/test_torch_train_pi0fast.py's
LATE_8BIT_SHARE = 5e-2


def state_mismatches(torch, got: dict, want: dict, where: str = "") -> list:
    """The paths at which two trees of tensors differ in any bit."""
    out = []
    for k in want:
        if isinstance(want[k], torch.Tensor):
            if not torch.equal(got[k].detach(), want[k].detach()):
                out.append(f"{where}/{k}")
        else:
            out += state_mismatches(torch, got[k], want[k], f"{where}/{k}")
    return out


def gathered(state) -> dict:
    """A sharded train state's whole parameters (flat) and optimizer
    state, gathered by every rank."""
    from cover_vla_tpu_torch.parallel.mesh import (
        gather_tensor, map_shards, shard_plan)
    from cover_vla_tpu_torch.utils.tree import flatten
    plan = shard_plan(state.params)
    return {"params": flatten(map_shards(state.params, plan, gather_tensor)),
            "opt_state": map_shards(state.opt_state, plan, gather_tensor)}


def sharded_step_phase(torch, card, dev, pcfg, vcfg, mesh, cells,
                       repeats=STEP_REPEATS):
    """10.1: make_verified_step_sharded at world size 1 against
    make_verified_step_batched on phase 4's weights and inputs, under the
    fast and all-kernel configs: every field bit-equal (the noise given,
    and drawn from one seed), launches per step, p50 in turns."""
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched, make_verified_step_sharded)
    from cover_vla_tpu_torch.ops import cuda_attention as ca

    pp, vp = init_full_width(torch, dev, pcfg, vcfg)
    stats = DatasetStatistics.from_json()
    attn = kernel_configs(pcfg, vcfg)
    expected = {"all_kernel": launches_per_step(pcfg, vcfg)}
    expected["fast"] = {**expected["all_kernel"], "prefix_gqa": 0}
    for cell, (e, ccfg) in cells.items():
        inputs, noise_np = episode_inputs(pcfg, vcfg, ccfg, e, seed=0)
        noise = torch.from_numpy(noise_np).to(dev)
        for a in ("fast", "all_kernel"):
            pc, vc = attn[a]
            steps = {"batched": make_verified_step_batched(
                         pc, vc, ccfg, stats, device=dev),
                     "sharded": make_verified_step_sharded(
                         pc, vc, ccfg, stats, mesh, device=dev)}
            res = {}
            for name, step in steps.items():
                ca.reset_launch_counts()
                res[name] = step(pp, vp, *inputs, noise=noise)
                torch.cuda.synchronize()
                counts = dict(ca.launch_counts)
                if counts != expected[a]:
                    raise AssertionError(f"{cell} {a} {name}: launch counts "
                                         f"{counts}, expected {expected[a]}")
            drawn = {name: step(pp, vp, *inputs, generator=torch.Generator(
                device=dev).manual_seed(21)) for name, step in steps.items()}
            for got, want, what in ((res["sharded"], res["batched"],
                                     "noise given"),
                                    (drawn["sharded"], drawn["batched"],
                                     "noise drawn")):
                check_result(torch, got, e, ccfg.n_rephrases, ccfg.n_samples,
                             pcfg.chunk_size)
                bad = state_mismatches(torch, got._asdict(), want._asdict())
                if bad:
                    raise AssertionError(f"{cell} {a} sharded vs batched "
                                         f"({what}): {bad}")
            times = {name: [] for name in steps}
            for i in range(repeats):     # in turns, the first alternating
                for name in (("batched", "sharded") if i % 2 == 0
                             else ("sharded", "batched")):
                    t0 = time.perf_counter()
                    steps[name](pp, vp, *inputs, noise=noise)
                    torch.cuda.synchronize()
                    times[name].append(time.perf_counter() - t0)
            p50 = {n: float(np.median(t)) * 1e3 for n, t in times.items()}
            log(f"sharded step {cell} {a}: world size 1 (mesh "
                f"{tuple(mesh.shape)}), every field bit-equal to the batched "
                f"step (noise given and drawn), launches {expected[a]} a "
                f"step; p50 sharded {p50['sharded']:.2f} ms (min "
                f"{min(times['sharded']) * 1e3:.2f}), batched "
                f"{p50['batched']:.2f} ms (min "
                f"{min(times['batched']) * 1e3:.2f}), in turns, "
                f"sharded / batched {p50['sharded'] / p50['batched']:.3f} | "
                f"{card}")
    del pp, vp


def fsdp_train_phase(torch, card, dev, cfg, mesh, b=32, n=6):
    """10.2: the FSDP expert-only π0 step (8-bit AdamW, B = 32) at world
    size 1 against the unsharded step from the same seed's state and the
    same batches, in turns: loss, grad norm and (after the last step)
    every parameter and optimizer entry bit-equal; step times, card peaks,
    the collectives' device time from a profile."""
    import gc
    from cover_vla_tpu_torch.training import optim, train_pi0

    batch = to_device(torch, train_batch(np.random.default_rng(9), cfg, b,
                                         pad_rows=4), dev)
    schedule = optim.warmup_cosine(5e-5, 100, 1000)
    runs = {}
    for name, m in (("unsharded", None), ("fsdp", mesh)):
        tx = train_pi0.make_optimizer(schedule, optimizer="adamw_8bit")
        state, mask = train_pi0.init_partitioned_train_state(
            7, cfg, tx, mesh=m, device=dev)
        runs[name] = [state, train_pi0.make_partitioned_train_step(
            cfg, tx, mask, mesh=m), [], [], []]
    for i in range(n):
        for name in (("unsharded", "fsdp") if i % 2 == 0
                     else ("fsdp", "unsharded")):
            run = runs[name]
            gen = torch.Generator(device=dev).manual_seed(100 + i)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            run[0], met = run[1](run[0], gen, batch)
            torch.cuda.synchronize()
            run[2].append(time.perf_counter() - t0)
            run[3].append(torch.cuda.max_memory_allocated() / 1e9)
            run[4].append((met["loss"].item(), met["grad_norm"].item()))
    u, f = runs["unsharded"], runs["fsdp"]
    if u[4] != f[4]:
        raise AssertionError(f"FSDP vs unsharded (loss, grad norm): {f[4]} "
                             f"vs {u[4]}")
    got = gathered(f[0])
    from cover_vla_tpu_torch.utils.tree import flatten
    bad = (state_mismatches(torch, got["params"], flatten(u[0].params))
           + state_mismatches(torch, got["opt_state"], u[0].opt_state))
    if bad:
        raise AssertionError(f"FSDP vs unsharded state after {n} steps: "
                             f"{bad[:8]}")
    held = [f[0]]

    def one_step():
        held[0], _ = f[1](held[0], torch.Generator(device=dev)
                          .manual_seed(300), batch)
    prof = profile_step(torch, card, f"FSDP train B={b}", one_step,
                        label="adamw_8bit expert-only, world size 1")
    for name, run in runs.items():
        log(f"FSDP train step {name} adamw_8bit expert-only B={b}: median of "
            f"steps 2-{n} {np.median(run[2][1:]) * 1e3:.1f} ms (steps "
            f"{[round(x * 1e3, 1) for x in run[2]]} ms, in turns), card peak "
            f"{max(run[3]):.2f} GB | {card}")
    log(f"FSDP train: {n} steps at world size 1 bit-equal to the unsharded "
        f"steps (losses {[round(x[0], 5) for x in f[4]]}, every parameter "
        f"and int8 grid entry); collectives {prof['nccl_ms']:.3f} ms of "
        f"device time in {prof['nccl_launches']} launches a step, device "
        f"busy share {prof['busy_ms'] / prof['wall_ms']:.3f} | {card}")
    del runs, u, f, held, got
    gc.collect()
    torch.cuda.empty_cache()


def ddp_verifier_phase(torch, card, dev, vcfg, mesh, b=32, n=4):
    """10.3: the DDP ensemble step at world size 1 under the kernel config
    against the unsharded step from the same members, in turns: K2's
    launches, every metric and member bit-equal, step times."""
    from cover_vla_tpu_torch.configs import fast_verifier_config
    from cover_vla_tpu_torch.models import verifier
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.training import optim
    from cover_vla_tpu_torch.training import train_verifier as tv
    from cover_vla_tpu_torch.utils.tree import flatten

    params = verifier.init_verifier(11, vcfg, 3, device=dev)
    kcfg = fast_verifier_config(vcfg)
    batch = to_device(torch, verifier_batch(np.random.default_rng(93), vcfg,
                                            b), dev)
    runs = {}
    for name, m in (("unsharded", None), ("ddp", mesh)):
        members = fresh_tree(torch, params["members"], dev)
        leaves = flatten(members)
        for v in leaves.values():
            v.requires_grad_(True)
        tx = optim.make_adamw(optim.linear_warmup(5e-5, 100))
        runs[name] = [tv.VerifierTrainState(members, tx.init(leaves),
                                            optim.counter()),
                      tv.make_ensemble_train_step(kcfg, tx, mesh=m), [], []]
    for i in range(n):
        for name in (("unsharded", "ddp") if i % 2 == 0
                     else ("ddp", "unsharded")):
            run = runs[name]
            ca.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run[0], met = run[1](run[0], params["backbone"], batch)
            torch.cuda.synchronize()
            run[2].append(time.perf_counter() - t0)
            if ca.launch_counts["mha_dense"] != verifier_k2(vcfg):
                raise AssertionError(f"{name}: K2 launches "
                                     f"{dict(ca.launch_counts)}")
            run[3].append(met)
        bad = state_mismatches(torch, runs["ddp"][3][-1],
                               runs["unsharded"][3][-1])
        bad += state_mismatches(torch, flatten(runs["ddp"][0].members),
                                flatten(runs["unsharded"][0].members))
        if bad:
            raise AssertionError(f"DDP vs unsharded after step {i + 1}: {bad}")
    for name, run in runs.items():
        log(f"DDP verifier train step {name} (kernel config, B={b}): median "
            f"of steps 2-{n} {np.median(run[2][1:]) * 1e3:.1f} ms (steps "
            f"{[round(x * 1e3, 1) for x in run[2]]} ms, in turns), K2 "
            f"{verifier_k2(vcfg)} launches a step | {card}")
    log(f"DDP verifier train: {n} steps at world size 1, every metric and "
        f"member bit-equal to the unsharded steps, losses "
        f"{[round(m['loss'].item(), 5) for m in runs['ddp'][3]]}")


def fsdp_fast_phase(torch, card, dev, cfg, mesh, b=8):
    """10.4: one FSDP π0-FAST step (the whole tree, 8-bit AdamW, B = 8)
    at world size 1 against the unsharded step from the same seed's
    state: the loss and every parameter bit-equal (one state on the card
    at a time; the unsharded result waits on the host)."""
    import gc
    from cover_vla_tpu_torch.training import optim, train_pi0, train_pi0fast
    from cover_vla_tpu_torch.utils.tree import flatten

    batch = to_device(torch, fast_batch(np.random.default_rng(97), cfg, b),
                      dev)
    out = {}
    for name, m in (("unsharded", None), ("fsdp", mesh)):
        tx = train_pi0.make_optimizer(optim.warmup_cosine(5e-5, 100, 1000),
                                      optimizer="adamw_8bit")
        state = train_pi0fast.init_train_state(8, cfg, tx, mesh=m,
                                               device=dev)
        step = train_pi0fast.make_train_step(cfg, tx, mesh=m)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, met = step(state, batch)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        params = (gathered(state)["params"] if m is not None
                  else flatten(state.params))
        if name == "unsharded":
            out["params"] = {k: v.detach().cpu() for k, v in params.items()}
        else:
            bad = [k for k, v in params.items()
                   if not torch.equal(v.detach().cpu(), out["params"][k])]
            if bad or met["loss"].item() != out["loss"]:
                raise AssertionError(f"π0-FAST FSDP vs unsharded: loss "
                                     f"{met['loss'].item()} vs {out['loss']},"
                                     f" leaves {bad[:8]}")
        out["loss"] = met["loss"].item()
        log(f"π0-FAST train step {name} adamw_8bit whole tree B={b}: first "
            f"step {secs * 1e3:.1f} ms, card peak "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, loss "
            f"{out['loss']:.5f} | {card}")
        del state, step, tx, params
        gc.collect()
        torch.cuda.empty_cache()
    log(f"π0-FAST FSDP: one step at world size 1 bit-equal to the unsharded "
        f"step ({len(out['params'])} leaves and the loss)")


def torchrun_phase(torch, card, tiny=False, b=16):
    """10.5: `python -m torch.distributed.run --standalone --nproc_per_node
    1 -m cover_vla_tpu_torch.run --role train` at full width (8-bit, 3
    steps), then resumed: the re-saved state byte-equal to the saved
    one."""
    import filecmp
    import shutil
    import tempfile
    from cover_vla_tpu_torch.convert import checkpoints

    tmp = tempfile.mkdtemp(prefix="cvla_torchrun_")
    try:
        data, ck = os.path.join(tmp, "data"), os.path.join(tmp, "ck")
        write_trajectories(data, hw=224)
        argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc_per_node", "1", "-m", "cover_vla_tpu_torch.run",
                "--role", "train", "--train.tiny", str(tiny).lower(),
                "--train.dataset_dir", data, "--train.checkpoint_dir", ck,
                "--train.batch_size", str(b), "--train.num_steps", "3",
                "--train.optimizer", "adamw_8bit"]
        if tiny:
            argv += ["--device", "cpu"]
        secs = []
        for extra in ([], ["--train.resume", "true"]):
            t0 = time.perf_counter()
            proc = subprocess.run(argv + extra, capture_output=True,
                                  text=True, timeout=600,
                                  cwd=os.path.dirname(os.path.abspath(
                                      __file__)))
            secs.append(time.perf_counter() - t0)
            if proc.returncode:
                raise AssertionError(f"torchrun exited {proc.returncode}:\n"
                                     f"{proc.stdout[-3000:]}\n"
                                     f"{proc.stderr[-6000:]}")
            path = checkpoints.latest_checkpoint(ck)
            assert os.path.basename(path) == "step_00000003", path
            f = os.path.join(path, checkpoints.BLOB_NAME)
            if not extra:
                first = os.path.join(tmp, "first.blob")
                os.link(f, first)      # the resume replaces the file
        if not filecmp.cmp(first, f, shallow=False):
            raise AssertionError("the resumed run's state differs from the "
                                 "saved one")
        with open(os.path.join(ck, "metrics.jsonl")) as fh:
            recs = [json.loads(line) for line in fh]
        assert [r["_step"] for r in recs] == [0], recs
        log(f"torchrun --nproc_per_node 1 run.main --role train "
            f"({'tiny' if tiny else 'full'} width, NCCL world size 1, "
            f"adamw_8bit, B={b}): 3 steps and a save {secs[0]:.1f} s, the "
            f"resume {secs[1]:.1f} s; the re-saved state "
            f"({os.path.getsize(f) / 1e9:.2f} GB) byte-equal to the saved "
            f"one; metrics.jsonl {len(recs)} record, loss "
            f"{recs[0]['loss']:.5f} | {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gloo_parity_rank(rank: int, world: int, store: str, out: str) -> None:
    """One rank of 10.6 (CPU, gloo): the tiny π0's partitioned FSDP steps
    at dp=1 x fsdp=world (every leaf of 256 elements and more sharded),
    AdamW and 8-bit AdamW, 3 steps; rank 0 also runs the unsharded steps
    and writes the deviations."""
    import torch
    torch.set_num_threads(2)
    from cover_vla_tpu_torch.configs import replace, tiny_pi0_config
    from cover_vla_tpu_torch.models import pi0
    from cover_vla_tpu_torch.models.params import ParamTree
    from cover_vla_tpu_torch.parallel import distributed
    from cover_vla_tpu_torch.parallel.mesh import (
        fsdp_sharding, make_mesh, shard_params)
    from cover_vla_tpu_torch.training import optim, train_pi0
    from cover_vla_tpu_torch.utils.tree import flatten, unflatten

    distributed.init_multihost(f"file://{store}", world, rank, device="cpu")
    try:
        cfg = replace(tiny_pi0_config(), compute_dtype="float32")
        base = pi0.init_pi0(0, cfg, device="cpu")
        rng = np.random.default_rng(8)
        batch = to_device(torch, train_batch(rng, cfg, 4), "cpu")
        kw = {"noise": torch.from_numpy(rng.standard_normal(
                  (4, cfg.chunk_size, cfg.max_action_dim)).astype(np.float32)),
              "time": torch.from_numpy(rng.uniform(0.001, 1.0, (4,))
                                       .astype(np.float32))}
        mesh = make_mesh(dp=1, fsdp=world)
        result = {}
        for opt in ("adamw", "adamw_8bit"):
            runs = {}
            for m in (mesh, None) if rank == 0 else (mesh,):
                tree = ParamTree(unflatten({k: v.detach().float().clone()
                                            for k, v in flatten(base).items()}))
                tx = train_pi0.make_optimizer(
                    optim.warmup_cosine(1e-3, 1, 20), optimizer=opt)
                mask = train_pi0.freeze_mask(tree)
                if m is None:
                    state = train_pi0.init_partitioned_state(tree, tx, mask)
                else:
                    params = shard_params(tree, fsdp_sharding(
                        tree, m, min_size=256))
                    mk = flatten(mask)
                    state = train_pi0.PartitionedTrainState(
                        params, tx.init({k: v for k, v in
                                         flatten(params).items() if mk[k]}),
                        optim.counter())
                step = train_pi0.make_partitioned_train_step(cfg, tx, mask,
                                                             mesh=m)
                per = []
                for _ in range(3):
                    state, met = step(state, None, batch, **kw)
                    params = (gathered(state)["params"] if m is not None
                              else flatten(state.params))
                    per.append((met["loss"].item(),
                                {k: v.detach().clone()
                                 for k, v in params.items()}))
                runs["fsdp" if m is not None else "plain"] = per
            if rank == 0:
                dev_steps = []
                for (lf, pf), (lp, pp) in zip(runs["fsdp"], runs["plain"]):
                    d = torch.cat([(pf[k] - pp[k]).abs().reshape(-1)
                                   for k in pp])
                    dev_steps.append({
                        "loss_rel": abs(lf - lp) / abs(lp),
                        "share": (d > TRAIN_PARAM_ATOL).float().mean().item(),
                        "max": d.max().item()})
                result[opt] = dev_steps
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        distributed.shutdown()


def gloo_parity_phase(world=2, timeout=300):
    """10.6: the 2-process gloo parity of the tiny π0 FSDP steps on this
    machine's CPU (the card machine has one GPU; NCCL takes one device per
    rank)."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="cvla_gloo_")
    out = os.path.join(tmp, "result.json")
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gloo-rank", str(r),
         str(world), os.path.join(tmp, "store"), out], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [f"rank {r} exited {p.returncode}:\n{o[-3000:]}"
           for r, (p, o) in enumerate(zip(procs, logs)) if p.returncode]
    if bad:
        raise AssertionError("gloo parity: " + "\n".join(bad))
    with open(out) as f:
        result = json.load(f)
    for opt, steps in result.items():
        for i, s in enumerate(steps):
            share = (LATE_8BIT_SHARE if opt == "adamw_8bit" and i == 2
                     else TRAIN_SHARE[opt])
            rel = 1e-3 if opt == "adamw_8bit" and i else 1e-4
            ok = s["share"] <= share and s["loss_rel"] <= rel and (
                opt != "adamw" or s["max"] <= 1e-4)
            if not ok:
                raise AssertionError(f"gloo parity {opt} step {i + 1}: {s}")
    log(f"gloo parity (this machine's CPU, {world} processes, FileStore): "
        f"tiny π0 partitioned FSDP steps vs unsharded, 3 steps each of adamw "
        f"and adamw_8bit within the CPU tests' bounds: "
        f"{ {o: [(round(s['loss_rel'], 8), round(s['share'], 5)) for s in st] for o, st in result.items()} }"
        f" (loss rel, share of parameters beyond {TRAIN_PARAM_ATOL:g}); "
        f"{time.perf_counter() - t0:.1f} s")


def multiprocess_phase(torch, card, dev):
    """Phase 10 at world size 1 over NCCL (one card), full width."""
    import gc
    import tempfile
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, Pi0Config, VerifierConfig)
    from cover_vla_tpu_torch.models.pi0fast import Pi0FastConfig
    from cover_vla_tpu_torch.parallel import distributed
    from cover_vla_tpu_torch.parallel.mesh import make_mesh

    tmp = tempfile.mkdtemp(prefix="cvla_store_")
    distributed.init_multihost(f"file://{tmp}/store", 1, 0, device=dev)
    try:
        mesh = make_mesh()
        log(f"phase 10: process group {torch.distributed.get_backend()}, "
            f"world size {distributed.world_size()}, mesh "
            f"{tuple(mesh.shape)} {mesh.mesh_dim_names}")
        pcfg, vcfg = Pi0Config(), VerifierConfig()
        cells = {"E16_N16_K1": (16, CoVerConfig(n_samples=16, n_rephrases=1)),
                 "E1_N5_K8": (1, CoVerConfig(n_samples=5, n_rephrases=8))}
        t0 = time.perf_counter()
        # STEP_REPEATS in-turns pairs: the phase's p50s only compare the
        # two steps, and the run must leave room for phases 11-14
        sharded_step_phase(torch, card, dev, pcfg, vcfg, mesh, cells,
                           repeats=STEP_REPEATS)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"phase 10.1 sharded step: wall {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        fsdp_train_phase(torch, card, dev, pcfg, mesh)
        ddp_verifier_phase(torch, card, dev, vcfg, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        fsdp_fast_phase(torch, card, dev, Pi0FastConfig(), mesh)
        log(f"phase 10.2-10.4 FSDP / DDP steps: wall "
            f"{time.perf_counter() - t0:.1f} s")
    finally:
        distributed.shutdown()
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    torchrun_phase(torch, card)
    gloo_parity_phase()
    log(f"phase 10.5-10.6 torchrun, gloo: wall "
        f"{time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: the bench role
# ---------------------------------------------------------------------------


def bench_phase(torch, card, dev):
    """11: `run.main(["--role", "bench"])` at the role's defaults, with its
    standard output captured; returns the phase's wall seconds."""
    import contextlib
    import io
    from cover_vla_tpu_torch import bench, run
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, Pi0Config, VerifierConfig)
    from cover_vla_tpu_torch.ops import cuda_attention as ca

    pcfg, vcfg = Pi0Config(), VerifierConfig()
    ccfg = CoVerConfig(n_samples=16, n_rephrases=1)
    log(f"phase 11: card memory before the role {torch.cuda.memory_allocated(dev) / 1e9:.2f} GB "
        f"allocated, {torch.cuda.memory_reserved(dev) / 1e9:.2f} GB reserved")
    ca.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        run.main(["--role", "bench"], device=dev)
    wall = time.perf_counter() - t0
    counts = dict(ca.launch_counts)
    lines = [line for line in out.getvalue().splitlines() if line.strip()]
    for line in lines:
        log(f"bench: {line}")
    log(f"phase 11 bench role: wall {wall:.1f} s | {card}")
    if len(lines) != 1:
        raise AssertionError(f"the bench role printed {len(lines)} lines")
    res = json.loads(lines[0])
    if tuple(res) != bench.JSON_KEYS:
        raise AssertionError(f"bench keys {tuple(res)} != {bench.JSON_KEYS}")
    for key in ("value", "vs_baseline", "p50_batched_step_ms",
                "pipelined_step_ms", "pipelined_actions_per_sec",
                "p50_single_step_ms", "single_episode_actions_per_sec",
                "profiled_device_ms", "ref_protocol_5x8_p50_ms",
                "ref_protocol_5x8_actions_per_sec",
                "max_throughput_actions_per_sec", "int8_actions_per_sec",
                "compile_s", "model_tflops_per_step",
                "xla_reported_tflops_per_step"):
        if not (isinstance(res[key], (int, float))
                and math.isfinite(res[key]) and res[key] > 0):
            raise AssertionError(f"bench {key} = {res[key]!r}")
    flops = bench._analytic_flops(pcfg, vcfg, ccfg, 16)
    if res["model_tflops_per_step"] != flops / 1e12:
        raise AssertionError(f"bench model_tflops_per_step "
                             f"{res['model_tflops_per_step']} != {flops / 1e12}")
    if not (res["mfu"] is not None and 0 < res["mfu"] <= 1
            and res["mfu_profiled"] is not None
            and 0 < res["mfu_profiled"] <= 1.05):
        raise AssertionError(f"bench mfu {res['mfu']}, mfu_profiled "
                             f"{res['mfu_profiled']}")
    if res["profiled_device_ms"] > res["pipelined_step_ms"] * 1.05:
        raise AssertionError(
            f"bench profiled device {res['profiled_device_ms']} ms exceeds "
            f"the pipelined step {res['pipelined_step_ms']} ms")
    if torch.cuda.get_device_name(dev) not in res["device"]:
        raise AssertionError(f"bench device {res['device']!r}")
    # the max-throughput and int8 steps: a first call and repeats x 10
    # pipelined ones each; the eager steps launch no kernel
    steps = 2 * (1 + res["repeats"] * 10)
    want = {"shared_prefix_gqa": 180 * steps, "mha_dense": 75 * steps,
            "prefix_gqa": 0}
    if counts != want:
        raise AssertionError(f"bench launch counts {counts}, expected {want} "
                             f"({steps} kernel steps)")
    log(f"bench: launches {counts} over {steps} max-throughput and int8 "
        f"steps (180 / 75 / 0 a step); pipelined / blocking E16 "
        f"{res['pipelined_step_ms'] / res['p50_batched_step_ms']:.3f}, "
        f"device busy share of the pipelined step "
        f"{res['profiled_device_ms'] / res['pipelined_step_ms']:.3f} | {card}")
    return wall


# ---------------------------------------------------------------------------
# phase 12: the verification-scaling experiment's trained trees
# ---------------------------------------------------------------------------

TRAINED_EPISODES = 16
TRAINED_TICKS = 60          # the experiment's MAX_ENV_STEPS
TRAINED_CPU_STEPS = 2       # verified steps replayed on the CPU (fp32)


def vs_script():
    """scripts/torch_verification_scaling.py as a module: the experiment's
    configs, its attention configs and the loader of the committed trees."""
    return script_module("torch_verification_scaling")


def script_module(name: str):
    """scripts/<name>.py as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decision_gap(scores: np.ndarray, n: int, threshold: float) -> float:
    """The smallest score margin a pick rests on: the stage-1 gate
    (candidate 0's score against the threshold), the top-two gap of the
    group means when there are several groups, and the top-two gap inside
    the winning group. Scores that all move by less than half of it cannot
    change the pick."""
    grouped = scores.reshape(-1, n)
    means = grouped.mean(axis=1)
    best = np.sort(grouped[int(np.argmax(means))])[::-1]
    gaps = [abs(float(scores[0]) - threshold)]
    if len(means) > 1:
        top = np.sort(means)[::-1]
        gaps.append(top[0] - top[1])
    if n > 1:
        gaps.append(best[0] - best[1])
    return float(min(gaps))


def trained_cohort(torch, vs, dev, pc, vc, ccfg, pp, vp, stats, noises,
                   record=None, episodes=TRAINED_EPISODES, task=None,
                   outputs=None):
    """One lockstep cohort of `episodes` fake-env episodes of `task` (the
    experiment's task by default; its seeds, its tokenizers) through
    BatchedCoVerEngine on `dev`, the verified steps fed `noises` in turn;
    `record` receives each verified step's inputs and noise, `outputs` its
    result. Returns the evaluation's result and the number of verified
    steps."""
    from cover_vla_tpu_torch.data.tokenizer import (
        make_policy_tokenizer, make_verifier_tokenizer)
    from cover_vla_tpu_torch.engine import BatchedCoVerEngine, evaluate_batched
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched)
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    from cover_vla_tpu_torch.eval.fake_env import make_fake_env
    from cover_vla_tpu_torch.eval.rephrase import load_rephrases

    step = make_verified_step_batched(pc, vc, ccfg, stats, device=dev)
    it, calls = iter(noises), []

    def step_fn(pp_, vp_, *inputs, generator=None):
        noise = next(it)
        calls.append(1)
        if record is not None:
            record.append(([np.array(x) for x in inputs], noise))
        out = step(pp_, vp_, *inputs, noise=noise)
        if outputs is not None:
            outputs.append(out)
        return out

    engine = BatchedCoVerEngine(
        pp, vp, pc, vc, ccfg, num_episodes=episodes, stats=stats,
        rephrases=load_rephrases() if ccfg.n_rephrases > 1 else None,
        policy_tokenizer=make_policy_tokenizer(pc.paligemma.vocab_size),
        verifier_tokenizer=make_verifier_tokenizer(vc.text.vocab_size),
        seed=7, step_fn=step_fn, device=dev)
    envs = [make_fake_env(task or vs.TASK, max_steps=TRAINED_TICKS)
            for _ in range(episodes)]
    out = evaluate_batched(engine, envs, BridgeSimplerAdapter(stats=stats),
                           max_steps=TRAINED_TICKS,
                           seeds=[1000 + e for e in range(episodes)])
    return out, len(calls)


def trained_phase(torch, card, dev):
    """12: the committed trained trees of the verification-scaling
    experiment (loaded without ml_dtypes or the JAX package) at the
    experiment's widths: lockstep cohorts of 16 episodes, verifier N=16
    K=1 and N=5 K=8, under eager, fast and all_kernel with the same host
    noise; every config's own cohort counted (launches a verified step,
    successes), then eager's inputs replayed through the kernel configs
    (candidates, scores, picks) and, with fp32 trees, through eager on the
    CPU. Returns the all-kernel launches a verified step."""
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.engine.verified_step import (
        make_propose_step_batched, make_verified_step_batched)
    from cover_vla_tpu_torch.models.params import ParamTree
    from cover_vla_tpu_torch.ops import cuda_attention as ca

    vs = vs_script()
    pcfg, vcfg = vs.experiment_configs()
    t0 = time.perf_counter()
    pp, vp, stats = vs.load_trees("policy_params.pkl", "verifier_params.pkl",
                                  pcfg, vcfg, dev)
    torch.cuda.synchronize()
    log(f"trained trees: policy {sum(p.numel() for p in pp.parameters())} + "
        f"verifier {sum(p.numel() for p in vp.parameters())} params "
        f"({len([p for p in pp.parameters() if p.dtype == torch.bfloat16])} "
        f"bf16 leaves) loaded in {time.perf_counter() - t0:.2f} s")
    attn = {c: vs.attention_configs(pcfg, vcfg, c) for c in vs.CONFIGS}
    per_step = launches_per_step(pcfg, vcfg)
    expected = {"all_kernel": per_step,
                "fast": {**per_step, "prefix_gqa": 0},
                "eager": {k: 0 for k in per_step}}

    def fp32(tree, device):
        return ParamTree({k: fp32(tree[k], device)
                          if isinstance(tree[k], ParamTree)
                          else tree[k].detach().float().to(device)
                          for k in tree})

    decided_all, launches = 0, None
    rng = np.random.default_rng(12)
    for cohort, (n, k) in (("N16_K1", (16, 1)), ("N5_K8", (5, 8))):
        ccfg = CoVerConfig(n_samples=n, n_rephrases=k, max_history=(
            vcfg.history_length - pcfg.chunk_size))
        noises = rng.standard_normal(
            (TRAINED_TICKS // pcfg.chunk_size, TRAINED_EPISODES, k, n,
             pcfg.chunk_size, pcfg.max_action_dim)).astype(np.float32)
        record = []
        for a in vs.CONFIGS:              # each config's own episodes
            pc, vc = attn[a]
            ca.reset_launch_counts()
            t0 = time.perf_counter()
            out, steps = trained_cohort(
                torch, vs, dev, pc, vc, ccfg, pp, vp, stats, noises,
                record=record if a == "eager" else None)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = dict(ca.launch_counts)
            want = {key: v * steps for key, v in expected[a].items()}
            if counts != want:
                raise AssertionError(f"trained {cohort} {a}: launches "
                                     f"{counts}, expected {want} ({steps} "
                                     f"verified steps)")
            if a == "all_kernel" and launches is None:
                launches = {key: v // steps for key, v in counts.items()}
            log(f"trained {cohort} {a}: {sum(out['success'])}/"
                f"{TRAINED_EPISODES} successes, {steps} verified steps, "
                f"wall {wall:.2f} s, launches a verified step "
                f"{ {key: v // steps for key, v in counts.items()} } | {card}")

        # eager's inputs through the kernel configs: all K*N candidates;
        # the scores of every candidate whose binarised gripper (raw
        # output against 0.5) is the same in both configs (a raw gripper
        # within the bound of 0.5 may binarise the other way and move its
        # candidate's trajectory, so its score, by a gripper step); the
        # picks wherever eager's decision gap exceeds twice the step's
        # largest score difference
        fused = {a: make_verified_step_batched(pc, vc, ccfg, stats,
                                               device=dev)
                 for a, (pc, vc) in attn.items()}
        propose = {a: make_propose_step_batched(pc, vc, ccfg, stats,
                                                device=dev)
                   for a, (pc, vc) in attn.items()}
        worst = {a: [0.0, 0.0, 0.0, 0.0] for a in ("fast", "all_kernel")}
        decided = {a: 0 for a in worst}
        flips = {a: 0 for a in worst}
        for inputs, noise in record:
            raw, prop, lt, lm, _, hist, hlen = inputs
            x = fused["eager"](pp, vp, *inputs, noise=noise)
            xc = propose["eager"](pp, raw, prop, lt, lm, hist, hlen,
                                  noise=noise)
            xs = x.scores.cpu().numpy()
            for a in worst:
                f = fused[a](pp, vp, *inputs, noise=noise)
                fc = propose[a](pp, raw, prop, lt, lm, hist, hlen,
                                noise=noise)
                cand = (fc.exec_chunks[..., :6] - xc.exec_chunks[..., :6]
                        ).abs().max().item()
                grip = (fc.raw_grippers - xc.raw_grippers).abs().max().item()
                flip = (fc.verifier_chunks[..., 6]
                        != xc.verifier_chunks[..., 6]).any(dim=-1)
                sd = (f.scores - x.scores).abs()
                sdev = sd.max().item()
                kept = sd[~flip].max().item() if (~flip).any() else 0.0
                if cand > FAST_ATOL or grip > 2 * FAST_ATOL or kept > SCORE_ATOL:
                    raise AssertionError(
                        f"trained {cohort} {a}: candidates {cand}, raw "
                        f"gripper {grip}, scores {kept} from eager")
                worst[a] = [max(w, v) for w, v in zip(worst[a],
                                                      (cand, grip, kept, sdev))]
                flips[a] += int(flip.sum())
                for e in range(TRAINED_EPISODES):
                    if decision_gap(xs[e], n, ccfg.rescore_threshold) \
                            <= 2 * sdev:
                        continue
                    decided[a] += 1
                    w = int(x.winner_idx[e])
                    if int(f.winner_idx[e]) != w:
                        raise AssertionError(
                            f"trained {cohort} {a}: episode {e} picks "
                            f"{int(f.winner_idx[e])}, eager {w} across a "
                            f"decision gap above twice the score "
                            f"difference {sdev}")
                    # the gripper vote reads the winning group's binarised
                    # grippers: compare it only where none of them flipped
                    g0 = (w // n) * n
                    dims = 6 if flip[e, g0:g0 + n].any() else 7
                    torch.testing.assert_close(
                        f.exec_chunk[e, :, :dims], x.exec_chunk[e, :, :dims],
                        rtol=FAST_RTOL, atol=FAST_ATOL)
        picks = len(record) * TRAINED_EPISODES
        for a in worst:
            log(f"trained {cohort} {a} vs eager over {len(record)} verified "
                f"steps: candidates max dev {worst[a][0]:.3e}, raw gripper "
                f"{worst[a][1]:.3e}, scores {worst[a][2]:.3e} (bound "
                f"{SCORE_ATOL}; {flips[a]} of {picks * k * n} candidates "
                f"binarised their gripper the other way, scores with them "
                f"{worst[a][3]:.3e}); picks decided by a gap above twice the "
                f"step's score difference {decided[a]}/{picks}, all equal")
            decided_all += decided[a]

        if cohort == "N16_K1":
            inputs, noise = record[0]
            profile_step(torch, card, f"trained {cohort}", lambda: fused[
                "all_kernel"](pp, vp, *inputs, noise=noise),
                label="all_kernel")

        # the same inputs through eager with fp32 trees, card vs CPU
        cpu = torch.device("cpu")
        cstep = make_verified_step_batched(pcfg, vcfg, ccfg, stats, device=cpu)
        pp32, vp32 = fp32(pp, dev), fp32(vp, dev)
        cpp32, cvp32 = fp32(pp, cpu), fp32(vp, cpu)
        dev_max, same = 0.0, 0
        for inputs, noise in record[:TRAINED_CPU_STEPS]:
            g = fused["eager"](pp32, vp32, *inputs, noise=noise)
            c = cstep(cpp32, cvp32, *inputs, noise=noise)
            dev_max = max(dev_max, max(
                (getattr(g, name).cpu() - getattr(c, name)).abs().max().item()
                for name in ("exec_chunk", "verifier_chunk", "scores")))
            same += int(torch.equal(g.winner_idx.cpu(), c.winner_idx))
        if dev_max > 1e-4 or same != min(len(record), TRAINED_CPU_STEPS):
            raise AssertionError(f"trained {cohort}: fp32 card vs CPU "
                                 f"deviation {dev_max}, picks equal in "
                                 f"{same} steps")
        log(f"trained {cohort}: fp32 eager card vs CPU over {same} verified "
            f"steps, max float deviation {dev_max:.3e} (bound 1e-4), picks "
            f"equal")
    if decided_all == 0:
        raise AssertionError("trained: no pick was decided by a gap above "
                             "twice the score difference")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the verification-scaling experiment's training stages
# ---------------------------------------------------------------------------

STAGE_STEPS = 3             # card-vs-CPU steps of each stage
STAGE_TIMED = 20            # timed steps of each stage at its batch
RANK_EPISODES = 10          # the rankdata cohort
# Card vs CPU, fp32 with TF32 off, over STAGE_STEPS steps from the same
# state and batches: losses within STAGE_LOSS_RTOL; every parameter within
# STAGE_PARAM_ATOL (10% of lr) and all but STAGE_SHARE of them within 1e-5.
# Adam divides gradients near the rounding level, such as the verifier's
# text-aware pooling query / key ones, by their own RMS: on an H100 2.6e-3
# of the verifier's elements sat beyond 1e-5 after three steps, the
# largest 6.5e-5. An attention key bias, whose gradient is zero in exact
# arithmetic, moves by up to the learning rate on each side at each step:
# the bound is twice the sum of the steps' rates.
STAGE_LOSS_RTOL, STAGE_PARAM_ATOL, STAGE_SHARE = 1e-5, 1e-4, 1e-2
STAGE_LR = 1e-3


def stage_param_check(torch, name, got, want, key_bias_bound):
    """got (card), want (CPU): {leaf: tensor}; returns (share beyond 1e-5,
    largest difference outside the key biases, largest key-bias one)."""
    diff = {k: (got[k].detach().cpu() - want[k].detach()).abs().reshape(-1)
            for k in want}
    kb = [k for k in diff if k.endswith("attn.k.bias")]
    rest = torch.cat([v for k, v in diff.items() if k not in kb])
    share = float((rest > 1e-5).float().mean())
    worst = float(rest.max())
    kbw = max([float(diff[k].max()) for k in kb], default=0.0)
    if share > STAGE_SHARE or worst > STAGE_PARAM_ATOL or kbw > key_bias_bound:
        raise AssertionError(f"{name}: card vs CPU parameters: share "
                             f"{share:.2e} beyond 1e-5, worst {worst:.2e}, "
                             f"key biases {kbw:.2e}")
    return share, worst, kbw


def stage_rankdata_cohort(torch, vs, card, dev, pp, stats, art):
    """One rankdata cohort of RANK_EPISODES episodes with the committed
    policy, driven by eager; at each chunk boundary the `fast` propose step
    (K1) runs on the same inputs and noise. Trajectories and execution
    candidates within phase 12's bound (FAST_ATOL); each candidate's
    quality within its chunk pair's Lipschitz bound of eager's where both
    reach the same grasp / success state. The records go to
    `art`/rankdata.npz. Returns the K1 launches of the fast proposals."""
    import argparse
    import copy
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.data.tokenizer import (
        make_policy_tokenizer, make_verifier_tokenizer)
    from cover_vla_tpu_torch.engine import BatchedCoVerEngine, evaluate_batched
    from cover_vla_tpu_torch.engine.verified_step import (
        make_propose_step_batched, make_select_step_batched)
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv
    from cover_vla_tpu_torch.eval.fake_expert import chunk_quality
    from cover_vla_tpu_torch.ops import cuda_attention as ca

    pcfg, vcfg = vs.experiment_configs()
    fast_p, _ = vs.attention_configs(pcfg, vcfg, "fast")
    n = 16
    ccfg = CoVerConfig(n_samples=n, n_rephrases=1, noise_std=1.0,
                       selection="injected", gripper_vote=False,
                       rescore_threshold=float("inf"),
                       max_history=vcfg.history_length - pcfg.chunk_size)
    eager = make_propose_step_batched(pcfg, vcfg, ccfg, stats, device=dev)
    fast = make_propose_step_batched(fast_p, vcfg, ccfg, stats, device=dev)
    rng = np.random.default_rng(13)
    seen = {"boundaries": 0, "k1": 0, "traj": 0.0, "exec": 0.0,
            "candidates": 0, "discrete": 0, "dq": 0.0}

    def propose(pp_, raw, prop, lt, lm, hist, hlen, generator=None):
        noise = rng.standard_normal((RANK_EPISODES, 1, n, pcfg.chunk_size,
                                     pcfg.max_action_dim)).astype(np.float32)
        want = eager(pp_, raw, prop, lt, lm, hist, hlen, noise=noise)
        ca.reset_launch_counts()
        got = fast(pp_, raw, prop, lt, lm, hist, hlen, noise=noise)
        torch.cuda.synchronize()
        seen["k1"] += ca.launch_counts["shared_prefix_gqa"]
        # phase 12's rule: the first six action dims within the bound, the
        # raw grippers within twice it; a raw gripper near 0.5 may
        # binarise the other way (counted)
        seen["traj"] = max(seen["traj"], float(
            (got.trajectories[..., :6] - want.trajectories[..., :6])
            .abs().max()))
        seen["exec"] = max(seen["exec"], float(
            (got.exec_chunks[..., :6] - want.exec_chunks[..., :6])
            .abs().max()))
        seen["grip"] = max(seen.get("grip", 0.0), float(
            (got.raw_grippers - want.raw_grippers).abs().max()))
        seen["flips"] = seen.get("flips", 0) + int(
            (got.verifier_chunks[..., 6] != want.verifier_chunks[..., 6])
            .any(dim=-1).sum())
        seen["fast"] = got
        return want

    def discrete_end(env, chunk):
        sim = copy.deepcopy(env)
        for a in chunk:
            _, _, done, trunc, _ = sim.step(np.asarray(a, np.float64))
            if done or trunc:
                break
        return bool(sim._grasped), bool(sim.episode_stats["success"])

    args = argparse.Namespace(oracle_frac=0.3, dagger_frac=0.5,
                              wrong_noun_frac=0.0)
    collector = vs.RankdataCollector(args, np.random.default_rng(123))
    engine = BatchedCoVerEngine(
        pp, None, pcfg, vcfg, ccfg, num_episodes=RANK_EPISODES, stats=stats,
        policy_tokenizer=make_policy_tokenizer(pcfg.paligemma.vocab_size),
        verifier_tokenizer=make_verifier_tokenizer(vcfg.text.vocab_size),
        seed=9, device=dev,
        step_fn=(propose, make_select_step_batched(ccfg, device=dev)))
    own = collector.factory(engine)

    def factory(envs):
        inner = own(envs)

        def score_fn(exec_chunks, proposal):
            fx = seen["fast"].exec_chunks.cpu().numpy()
            for e in np.nonzero(~engine.done)[0]:
                for i in range(n):
                    f, w = fx[e, i], exec_chunks[e, i]
                    if discrete_end(envs[e], f) != discrete_end(envs[e], w):
                        seen["discrete"] += 1
                        continue
                    bound = np.linalg.norm(
                        np.clip(f[:, :3], -0.05, 0.05)
                        - np.clip(w[:, :3], -0.05, 0.05), axis=-1).sum()
                    dq = abs(chunk_quality(envs[e], f)
                             - chunk_quality(envs[e], w))
                    seen["candidates"] += 1
                    seen["dq"] = max(seen["dq"], dq)
                    if dq > bound + 1e-6:
                        raise AssertionError(
                            f"rankdata: fast quality off by {dq:.3e} over "
                            f"a Lipschitz bound of {bound:.3e}")
            seen["boundaries"] += 1
            return inner(exec_chunks, proposal)
        return score_fn

    engine.score_fn_factory = factory
    envs = [FakeWidowXEnv(vs.TASK, max_steps=vs.MAX_ENV_STEPS)
            for _ in range(RANK_EPISODES)]
    t0 = time.perf_counter()
    evaluate_batched(engine, envs, BridgeSimplerAdapter(),
                     max_steps=vs.MAX_ENV_STEPS,
                     seeds=[50_000 + j for j in range(RANK_EPISODES)])
    wall = time.perf_counter() - t0
    if (seen["traj"] > FAST_ATOL or seen["exec"] > FAST_ATOL
            or seen["grip"] > 2 * FAST_ATOL):
        raise AssertionError(f"rankdata: fast vs eager trajectories "
                             f"{seen['traj']:.3e}, candidates "
                             f"{seen['exec']:.3e}, raw grippers "
                             f"{seen['grip']:.3e} (bound {FAST_ATOL})")
    if seen["k1"] != 10 * seen["boundaries"]:
        raise AssertionError(f"rankdata: K1 {seen['k1']} launches over "
                             f"{seen['boundaries']} boundaries")
    if seen["discrete"] > 0.05 * (seen["candidates"] + seen["discrete"]):
        raise AssertionError(f"rankdata: {seen['discrete']} candidates "
                             f"reach another grasp state under fast")
    arrays = collector.arrays()
    np.savez(os.path.join(art, "rankdata.npz"), **arrays)
    log(f"stage rankdata cohort (E={RANK_EPISODES}, N={n}, fast vs eager in "
        f"lockstep): {len(arrays['frames'])} states over "
        f"{seen['boundaries']} boundaries in {wall:.1f} s (both proposals "
        f"and the labels), exec mix {collector.counters}; trajectories max "
        f"dev {seen['traj']:.3e}, candidates {seen['exec']:.3e} (bound "
        f"{FAST_ATOL}), raw grippers {seen['grip']:.3e}, {seen['flips']} "
        f"candidates binarised their gripper the other way; qualities within their Lipschitz bound for "
        f"{seen['candidates']} candidates (largest difference "
        f"{seen['dq']:.3e}), {seen['discrete']} reach another grasp state; "
        f"K1 {seen['k1']} launches | {card}")
    return seen["k1"]


def stage_steps_phase(torch, card, dev):
    """13: the verification-scaling experiment's training stages at its
    widths: one rankdata cohort (fast against eager), then STAGE_STEPS
    steps of train_policy, pretrain_backbone and train_verifier on the card
    and on the CPU from the same fp32 state and batches, the verifier's
    frozen-backbone step under `fast` (K2), and each stage's step time at
    its batch. Returns the launches {K1: rankdata cohort, K2: verifier
    fast steps, K3: 0}."""
    import argparse
    import tempfile
    from cover_vla_tpu_torch.configs import replace
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, pi0_from_jax, place_like, verifier_from_jax)
    from cover_vla_tpu_torch.models.params import ParamTree
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from cover_vla_tpu_torch.training import optim, train_pi0, train_verifier
    from cover_vla_tpu_torch.utils.tree import flatten, unflatten

    vs = vs_script()
    cpu = torch.device("cpu")
    pcfg, vcfg = vs.experiment_configs()
    src = vs.src_dir()
    stats = load_pickle(os.path.join(src, "stats.pkl"))
    pp = pi0_from_jax(load_pickle(os.path.join(src, "policy_params.pkl")),
                      pcfg, device=dev)
    art = tempfile.mkdtemp(prefix="stage_art_")
    os.environ["VS_TORCH_ART_DIR"] = art
    k1 = stage_rankdata_cohort(torch, vs, card, dev, pp, stats, art)

    def fp32_copy(tree, device):
        return ParamTree(unflatten({k: v.detach().float().clone().to(device)
                                    for k, v in flatten(tree).items()}))

    def schedule():
        return vs.stage_schedule(STAGE_LR, 20, 50)

    def run(name, make_state, step, batches, leaves):
        """STAGE_STEPS steps on the card and on the CPU, held together."""
        out = []
        for d in (dev, cpu):
            state = make_state(d)
            losses = []
            for b in batches:
                state, loss = step(state, {k: v.to(d) for k, v in b.items()})
                losses.append(float(loss))
            out.append((leaves(state), losses))
        (gs, gl), (cs, cl) = out
        lerr = max(abs(g - c) / max(abs(c), 1e-6) for g, c in zip(gl, cl))
        if lerr > STAGE_LOSS_RTOL:
            raise AssertionError(f"{name}: card vs CPU losses {gl} / {cl}")
        kb_bound = 2 * sum(schedule()(i) for i in range(STAGE_STEPS))
        share, worst, kbw = stage_param_check(torch, name, gs, cs, kb_bound)
        log(f"stage {name}: {STAGE_STEPS} steps card vs CPU (fp32, TF32 "
            f"off): losses {gl[0]:.6f} .. {gl[-1]:.6f}, largest relative "
            f"difference {lerr:.2e} (bound {STAGE_LOSS_RTOL}); parameters "
            f"{share:.2e} beyond 1e-5 (bound {STAGE_SHARE}), worst "
            f"{worst:.2e} (bound {STAGE_PARAM_ATOL}), key biases {kbw:.2e} "
            f"(bound {kb_bound:.1e})")
    def timed(name, step_once, b):
        for _ in range(3):
            step_once()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STAGE_TIMED):
            step_once()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / STAGE_TIMED
        log(f"stage {name} step time at B={b}: {ms:.2f} ms a step (mean of "
            f"{STAGE_TIMED}), card peak "
            f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB | {card}")

    gen = torch.Generator().manual_seed(0)
    # train_policy: the committed policy in fp32, the demos' frames
    pcfg32 = replace(pcfg, compute_dtype="float32")
    data, _ = vs.policy_data(argparse.Namespace(rephrases=True), pcfg32, cpu)
    idx_rng = np.random.default_rng(0)
    batches = []
    for _ in range(STAGE_STEPS):
        idx = idx_rng.integers(0, len(data["state"]), 8)
        v = idx_rng.integers(0, len(data["lang_tokens"]), 8)
        b = vs.policy_batch(data, idx, v, pcfg32)
        b["noise"] = torch.randn(b["actions"].shape, generator=gen)
        b["time"] = torch.rand((8,), generator=gen) * 0.999 + 0.001
        batches.append(b)

    def policy_state(d, cfg=pcfg32, params=None):
        tx = optim.adamw(schedule(), weight_decay=1e-5)
        params = fp32_copy(pp, d) if params is None else params
        return (train_pi0.TrainState(params, tx.init(flatten(params)),
                                     optim.counter()),
                train_pi0.make_train_step(cfg, tx))

    def policy_step(st, b):
        state, step = st
        b = dict(b)
        noise, t = b.pop("noise"), b.pop("time")
        state, m = step(state, None, b, noise=noise, time=t)
        return (state, step), m["loss"]

    run("train_policy", policy_state, policy_step, batches,
        lambda st: flatten(st[0].params))
    # pretrain_backbone: the committed tower + a seeded head, synthetic
    # frames augmented on the CPU
    frames, positions, shapes = vs.synth_localisation_frames(16)
    y = torch.from_numpy(vs.localisation_targets(positions, shapes))
    vision = load_pickle(os.path.join(src, "pretrained_vision.pkl"))
    p_dim = vcfg.vision.num_patches * vcfg.vision.width
    head = {"kernel": torch.randn((p_dim, y.shape[1]), generator=gen)
            * p_dim ** -0.5, "bias": torch.zeros((y.shape[1],))}
    batches = []
    for _ in range(STAGE_STEPS):
        i = torch.randint(0, 16, (8,), generator=gen)
        f_b, y_b = vs.pretrain_augment(torch.from_numpy(frames)[i], y[i],
                                       **vs.pretrain_draws(gen, 8, cpu))
        batches.append({"images": vs.verifier_prep(
            f_b, vcfg.vision.image_size), "y": y_b})

    def pretrain_state(d):
        tree = {"vision": place_like(vision, None, d),
                "head": {k: v.clone().to(d) for k, v in head.items()}}
        tx = optim.adamw(schedule(), weight_decay=1e-5)
        return tree, tx, tx.init(flatten(tree))

    def pretrain_step(st, b):
        tree, tx, opt = st
        loss, opt = vs.pretrain_update(tx, opt, tree, vcfg, b["images"],
                                       b["y"])
        return (tree, tx, opt), loss

    run("pretrain_backbone", pretrain_state, pretrain_step, batches,
        lambda st: flatten(st[0]))
    # train_verifier: the committed verifier, the cohort's rankdata, the
    # regression step with the backbone frozen
    args = argparse.Namespace(
        data=["rankdata.npz"], dr_phase="all", min_spread=0.02,
        rephrases=True, cross_task_text=True, batch=8, augment=True,
        color_aug=False, objective="regression")
    vdata = vs.verifier_data(args, vcfg, cpu)
    vtree = load_pickle(os.path.join(src, "verifier_params.pkl"))
    batches = [vs.verifier_batch(vdata, gen, args, vcfg,
                                 vcfg.action_padding_value)
               for _ in range(STAGE_STEPS)]

    def verifier_state(d, cfg=vcfg):
        tx = optim.adamw(schedule(), weight_decay=1e-5)
        params = fp32_copy(verifier_from_jax(vtree, vcfg, device=d), d)
        return (train_verifier.FullVerifierTrainState(
            params, tx.init(flatten(params)), optim.counter()),
            train_verifier.make_regression_train_step(
                cfg, tx, q_scale=1.0, train_backbone=False))

    def verifier_step(st, b):
        state, step = st
        state, m = step(state, b)
        return (state, step), m["loss"]

    run("train_verifier", verifier_state, verifier_step, batches,
        lambda st: flatten(st[0].params))
    # the frozen backbone under `fast` on the card: K2 in the features
    _, kcfg = vs.attention_configs(pcfg, vcfg, "fast")
    eager_losses, fast_losses = [], []
    for cfg, losses in ((vcfg, eager_losses), (kcfg, fast_losses)):
        st = verifier_state(dev, cfg)
        ca.reset_launch_counts()
        for b in batches:
            st, loss = verifier_step(st, {k: v.to(dev) for k, v in b.items()})
            losses.append(float(loss))
        torch.cuda.synchronize()
    k2 = ca.launch_counts["mha_dense"]
    if k2 != 5 * STAGE_STEPS:
        raise AssertionError(f"train_verifier fast: K2 {k2} launches in "
                             f"{STAGE_STEPS} steps (5 a step expected)")
    lerr = max(abs(f - e) / abs(e) for f, e in zip(fast_losses, eager_losses))
    if lerr > KERNEL_TOL:
        raise AssertionError(f"train_verifier fast vs eager losses "
                             f"{fast_losses} / {eager_losses}")
    log(f"stage train_verifier under fast: K2 {k2} launches in "
        f"{STAGE_STEPS} steps; losses within {lerr:.2e} of eager's (bound "
        f"{KERNEL_TOL}: the towers' bf16 attention)")

    # step times at the stages' batches and precisions (train_policy 64
    # in bf16, pretrain 64, train_verifier 24 under fast)
    torch.cuda.reset_peak_memory_stats(dev)
    gdata = {k: v.to(dev) for k, v in data.items()}
    pstate = policy_state(dev, pcfg, ParamTree(unflatten({
        k: v.detach().clone() for k, v in flatten(pp).items()})))
    pgen = torch.Generator(device=dev).manual_seed(1)

    def policy_once():
        nonlocal pstate
        idx = idx_rng.integers(0, len(data["state"]), 64)
        v = idx_rng.integers(0, len(data["lang_tokens"]), 64)
        state, step = pstate
        state, _ = step(state, pgen, vs.policy_batch(gdata, idx, v, pcfg))
        pstate = (state, step)

    timed("train_policy", policy_once, 64)
    dframes, dy = torch.from_numpy(frames).to(dev), y.to(dev)
    tstate = pretrain_state(dev)
    dgen = torch.Generator(device=dev).manual_seed(2)

    def pretrain_once():
        nonlocal tstate
        tree, tx, opt = tstate
        i = torch.randint(0, 16, (64,), generator=dgen, device=dev)
        f_b, y_b = vs.pretrain_augment(dframes[i], dy[i],
                                       **vs.pretrain_draws(dgen, 64, dev))
        _, opt = vs.pretrain_update(tx, opt, tree, vcfg, vs.verifier_prep(
            f_b, vcfg.vision.image_size), y_b)
        tstate = (tree, tx, opt)

    timed("pretrain_backbone", pretrain_once, 64)
    vdev = {k: v.to(dev) if hasattr(v, "to") else v for k, v in vdata.items()}
    args.batch = 24
    vstate = verifier_state(dev, kcfg)

    def verifier_once():
        nonlocal vstate
        vstate, _ = verifier_step(vstate, vs.verifier_batch(
            vdev, dgen, args, vcfg, vcfg.action_padding_value))

    timed("train_verifier (fast)", verifier_once, 24)
    os.environ.pop("VS_TORCH_ART_DIR", None)
    import shutil
    shutil.rmtree(art, ignore_errors=True)
    return {"shared_prefix_gqa": k1, "mha_dense": k2, "prefix_gqa": 0}


# ---------------------------------------------------------------------------
# phase 14: the experiment's last stages, the OOD diagnostics, the roofline
# ---------------------------------------------------------------------------

CAL_FRAMES = 512            # calibrate's ID frames (its default)
DEFER_EPISODES = 10
LANG_SLATES = 64
PROBE_FRAMES, PROBE_STEPS = 256, 100
ROOFLINE_STEPS = 1          # fast E16_N16_K1 steps profiled with shapes


def pick_rule(name: str, eager: np.ndarray, kernel: np.ndarray) -> str:
    """Phase 12's rule for argmax picks of [slates, N] scores: a kernel
    config's pick equals eager's wherever eager's top-two gap exceeds twice
    the largest score difference; the other picks that differ are counted.
    Returns the line that says so."""
    sdev = float(np.abs(kernel - eager).max())
    if sdev > SCORE_ATOL:
        raise AssertionError(f"{name}: fast scores {sdev} from eager's")
    top = np.sort(eager, axis=1)
    gap = top[:, -1] - top[:, -2]
    decided = gap > 2 * sdev
    same = kernel.argmax(1) == eager.argmax(1)
    if not same[decided].all():
        raise AssertionError(f"{name}: a pick differs across a top-two gap "
                             f"above twice the score difference {sdev}")
    return (f"{name}: scores fast vs eager max dev {sdev:.3e} (bound "
            f"{SCORE_ATOL}); picks decided by a gap above twice it "
            f"{int(decided.sum())}/{len(gap)}, all equal; "
            f"{int((~same).sum())} flips across smaller gaps")


def last_stages_phase(torch, card, dev):
    """14: `calibrate` (eager and fast on the card, eager on the CPU), a
    deference cohort on an OOD task, `lang` and `regret` under eager and
    fast with phase 12's pick rule, `probe`, and the roofline of phase
    11's bench trace and of a recorded fast E16_N16_K1 trace. Returns the
    launches of the phase's kernel paths."""
    import tempfile
    from cover_vla_tpu_torch import bench
    from cover_vla_tpu_torch.configs import CoVerConfig
    from cover_vla_tpu_torch.convert.from_jax import (
        load_pickle, place_like, verifier_from_jax)
    from cover_vla_tpu_torch.engine.verified_step import (
        make_verified_step_batched)
    from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS
    from cover_vla_tpu_torch.ops import cuda_attention as ca

    vs = vs_script()
    od = script_module("torch_ood_diagnostics")
    rf = script_module("torch_roofline")
    cpu = torch.device("cpu")
    src = vs.src_dir()
    pcfg, vcfg = vs.experiment_configs()
    _, vcfg_f = vs.attention_configs(pcfg, vcfg, "fast")
    pcfg_f, _ = vs.attention_configs(pcfg, vcfg, "fast")
    vtree = load_pickle(os.path.join(src, "verifier_params.pkl"))
    launches = {"shared_prefix_gqa": 0, "mha_dense": 0, "prefix_gqa": 0}

    def count(fn):
        ca.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        for k, v in ca.launch_counts.items():
            launches[k] += v
        return out, dict(ca.launch_counts)

    # 14.1 calibrate: eager and fast on the card, eager on the CPU
    t0 = time.perf_counter()
    frames = vs.calibration_frames(CAL_FRAMES,
                                   os.path.join(src, "rankdata.npz"))
    vp = verifier_from_jax(vtree, vcfg, device=dev)
    (proto, aff), _ = count(lambda: vs.calibration_prototype(
        vp, vcfg, frames, dev))
    (proto_f, _), k_fast = count(lambda: vs.calibration_prototype(
        vp, vcfg_f, frames, dev))
    proto_c, _ = vs.calibration_prototype(
        verifier_from_jax(vtree, vcfg, device=cpu), vcfg, frames, cpu)
    d_cpu = float(np.abs(proto - proto_c).max())
    d_fast = float(np.abs(proto_f - proto).max())
    if d_cpu > 1e-4 or d_fast > KERNEL_TOL:
        raise AssertionError(f"calibrate: prototype card vs CPU {d_cpu}, "
                             f"fast vs eager {d_fast}")
    p05, p50 = (float(np.percentile(aff, p)) for p in (5, 50))
    log(f"calibrate: {CAL_FRAMES} ID frames, prototype card vs CPU (eager, "
        f"fp32) max dev {d_cpu:.3e} (bound 1e-4), fast vs eager "
        f"{d_fast:.3e} (bound {KERNEL_TOL}; K2 {k_fast['mha_dense']} "
        f"launches); ID affinity p05 {p05:.4f}, p50 {p50:.4f}; wall "
        f"{time.perf_counter() - t0:.1f} s | {card}")

    # 14.2 deference: a cohort of the OOD task whose scenes sit farthest
    # from the prototype, under the ID p05 and p50 thresholds; at -inf the
    # calibrated tree's run is bit-equal to the uncalibrated tree's
    t0 = time.perf_counter()
    med = {t: float(np.median(vs.embed_frames(
        vp, vcfg, vs.ood_scene_frames(t, 4),
        TASK_INSTRUCTIONS.get(t, t.replace("_", " ")), dev) @ proto))
        for t in vs.OOD_TASKS}
    task = min(med, key=med.get)
    pp, _, stats = vs.load_trees("policy_params.pkl", "verifier_params.pkl",
                                 pcfg, vcfg, dev)
    vpc = vs.stamp_calibration(vp, proto)
    noises = np.random.default_rng(14).standard_normal(
        (TRAINED_TICKS // pcfg.chunk_size, DEFER_EPISODES, 1, 16,
         pcfg.chunk_size, pcfg.max_action_dim)).astype(np.float32)

    def cohort(tree, threshold, outputs, record=None):
        ccfg = CoVerConfig(n_samples=16, n_rephrases=1, max_history=(
            vcfg.history_length - pcfg.chunk_size), defer_threshold=threshold)
        return trained_cohort(torch, vs, dev, pcfg_f, vcfg_f, ccfg, pp, tree,
                              stats, noises, record=record,
                              episodes=DEFER_EPISODES, task=task,
                              outputs=outputs)

    deferred = {}
    for name, thr in (("p05", p05), ("p50", p50)):
        outs = []
        (res, steps), _ = count(lambda: cohort(vpc, thr, outs))
        deferred[name] = sum(int(o.deferred.sum()) for o in outs)
        for o in outs:              # a deferred pick executes candidate 0
            if not (o.winner_idx[o.deferred] == 0).all():
                raise AssertionError("a deferred pick is not candidate 0")
        log(f"defer {task} threshold {name} {thr:.4f}: {deferred[name]} of "
            f"{steps * DEFER_EPISODES} picks deferred, "
            f"{sum(res['success'])}/{DEFER_EPISODES} successes")
    if deferred["p50"] == 0:
        raise AssertionError("deference: no pick deferred at the ID p50")
    runs = []
    for tree in (vpc, vp):
        outs = []
        cohort(tree, float("-inf"), outs)
        runs.append(outs)
    for a, b in zip(*runs):
        for field in a._fields:
            if not torch.equal(getattr(a, field), getattr(b, field)):
                raise AssertionError(f"defer -inf: {field} differs from the "
                                     "uncalibrated step")
    log(f"defer: OOD affinity medians {json.dumps({k[7:]: round(v, 4) for k, v in med.items()})}; "
        f"the calibrated tree at -inf bit-equal to the uncalibrated tree over "
        f"{len(runs[0])} verified steps; wall {time.perf_counter() - t0:.1f} s")

    # 14.3 lang on LANG_SLATES slates, 14.4 regret on one cohort
    t0 = time.perf_counter()
    frames_l, trajs_l, q_l, instrs, rng = od.lang_slates(
        os.path.join(src, "rankdata_wn.npz"), LANG_SLATES)
    variants = od.lang_variants(instrs, rng)
    rows = {}
    for label, vc in (("eager", vcfg), ("fast", vcfg_f)):
        scores, k = count(lambda: {key: od.score_slates(
            vp, vc, frames_l, trajs_l, texts, dev)
            for key, texts in variants.items()})
        rows[label] = (scores, od.lang_row(scores, q_l), k)
    for key in variants:
        log(pick_rule(f"lang {key}", rows["eager"][0][key],
                      rows["fast"][0][key]))
    log(f"lang: eager {json.dumps(rows['eager'][1])}, fast "
        f"{json.dumps(rows['fast'][1])} (K2 {rows['fast'][2]['mha_dense']})")
    (slates, k_col) = count(lambda: od.collect_slates(
        vs.TASK, DEFER_EPISODES, DEFER_EPISODES, 16, 97, pp, stats, pcfg_f,
        vcfg_f, dev))
    frames_r, trajs_r, q_r, grasped = slates
    keep = (q_r.max(1) - q_r.min(1)) > 0.02
    instr = TASK_INSTRUCTIONS.get(vs.TASK, vs.TASK.replace("_", " "))
    sc = {label: od.score_slates(vp, vc, frames_r[keep], trajs_r[keep],
                                 instr, dev)
          for label, vc in (("eager", vcfg), ("fast", vcfg_f))}
    log(pick_rule("regret", sc["eager"], sc["fast"]))
    log(f"regret: {int(keep.sum())} slates of one cohort (K1 "
        f"{k_col['shared_prefix_gqa']} launches), eager "
        f"{json.dumps(od.regret_row(sc['eager'], q_r[keep], grasped[keep]))}, "
        f"fast {json.dumps(od.regret_row(sc['fast'], q_r[keep], grasped[keep]))}; "
        f"wall {time.perf_counter() - t0:.1f} s")

    # 14.5 probe
    t0 = time.perf_counter()
    tower = place_like(load_pickle(os.path.join(src, "pretrained_vision.pkl")),
                       None, dev)
    pf, positions, _ = vs.synth_localisation_frames(PROBE_FRAMES, seed=11)
    targets = torch.from_numpy(np.concatenate(
        [positions[:, 0:2], positions[:, 3:5], positions[:, 6:8]],
        1).astype(np.float32) / 0.1).to(dev)
    domains = od._domain_frames(16)
    (row, k_probe) = count(lambda: od.probe_rows(
        *od.train_probe_head(od.features_of(tower, vcfg_f, pf, dev), targets,
                             PROBE_STEPS),
        {dom: od.features_of(tower, vcfg_f, df, dev).cpu().numpy()
         for dom, (df, _) in domains.items()}, domains))
    if not all(math.isfinite(r["mae"]) for r in row.values()):
        raise AssertionError(f"probe: {row}")
    log(f"probe: the pretrained tower, {PROBE_FRAMES} frames, {PROBE_STEPS} "
        f"Adam steps (fast, K2 {k_probe['mha_dense']}): "
        f"{json.dumps({d: r['mae'] for d, r in row.items()})}; wall "
        f"{time.perf_counter() - t0:.1f} s")

    # 14.6 the roofline of phase 11's bench trace (eager steps) and of a
    # recorded fast E16_N16_K1 trace
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="roofline_")
    bench_dir = os.environ.get("BENCH_TRACE_DIR", os.path.join(
        tempfile.gettempdir(), "bench_trace"))
    _, rec_counts = count(lambda: rf.record(tmp, ROOFLINE_STEPS, "fast", dev))
    for label, trace_dir, steps, want in (
            ("bench (phase 11, eager)", bench_dir, 4, {}),
            ("fast E16_N16_K1 (recorded)", tmp, ROOFLINE_STEPS,
             {"K1": 180, "K2": 75})):
        trace = rf.load_trace(rf.trace_path(trace_dir))
        res = rf.roofline(trace, steps)
        busy = bench.trace_device_busy_s(trace_dir) * 1e3 / steps
        cats = {r["category"]: r for r in res["categories"]}
        # the wrappers' launches a step (the work record), and the trace's:
        # the device tracer may lose a few events, within 2%
        work = trace.get("cvlaKernelWork", {})
        got = {c: work[name]["launches"] / steps
               for c, name in rf.KERNEL_OF.items() if name in work}
        traced = {c: cats[c]["launches_per_step"] for c in ("K1", "K2", "K3")
                  if c in cats}
        if got != want or set(traced) != set(want) or any(
                traced[c] < 0.98 * want[c] for c in want):
            raise AssertionError(f"roofline {label}: hand-kernel launches a "
                                 f"step {got} recorded, {traced} in the "
                                 f"trace, expected {want}")
        if abs(res["busy_ms_per_step"] - busy) > 1e-6 * busy or abs(
                res["category_sum_ms_per_step"] - busy) > 0.02 * busy:
            raise AssertionError(f"roofline {label}: busy {busy} ms, union "
                                 f"{res['busy_ms_per_step']}, category sum "
                                 f"{res['category_sum_ms_per_step']}")
        if any(r["share_of_busy"] > 1 for r in res["categories"]):
            raise AssertionError(f"roofline {label}: a share exceeds 100%")
        lost = sum(cats[c]["launches_lost"] for c in traced)
        log(f"roofline {label}: {res['device_events']} device events over "
            f"{steps} steps, busy {busy:.3f} ms a step, category sum "
            f"{res['category_sum_ms_per_step']:.3f}; hand-kernel launches a "
            f"step {got} ({lost} lost by the trace) | {card}")
        for r in res["categories"]:
            log(f"  roofline {r['category']:13s} {r['ms_per_step']:9.3f} ms "
                f"{100 * r['share_of_busy']:6.2f}% "
                f"{r['launches_per_step']:8.1f} launches  TFLOP/s "
                f"{r['tflops'] if r['tflops'] is None else round(r['tflops'], 2)}"
                f"  TB/s {r['tbs'] if r['tbs'] is None else round(r['tbs'], 4)}")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"roofline: wall {time.perf_counter() - t0:.1f} s (record launches "
        f"{rec_counts})")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from cover_vla_tpu_torch import _build

    # phase 1: device ----------------------------------------------------
    t_start = time.perf_counter()
    card = card_line()
    dev = torch.device("cuda", 0)
    log(card)
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lib = _build.load()
    log(f"kernels: {lib.path} built in {lib.build_seconds:.1f}s")
    for line in lib.compiler_log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "error", "warning", "Performance Loss")):
            log(f"  nvcc: {line.strip()}")
    # ptxas serialises wgmma products it cannot prove independent and only
    # says so in a note (C7510 and following)
    if "wgmma.mma_async instructions are serialized" in lib.compiler_log:
        raise AssertionError("ptxas serialised the wgmma products of a kernel")
    spills = wgmma_spills(lib.compiler_log)
    if spills:      # empty when an existing library was reused
        log(f"kernels: spilled bytes (stores, loads) of the wgmma kernels "
            f"by <head dim, warpgroups, K3>: {spills}")
        # ViT-L, text, so400m, the prefill's and the decode's instance
        if any(spills[k] != (0, 0) for k in ("64,3,0", "64,2,0", "80,4,0",
                                              "256,2,1", "decode,256")):
            raise AssertionError(f"a main-shape wgmma kernel spills: {spills}")

    log(f"phase 1 device: wall {time.perf_counter() - t_start:.1f} s")
    # phase 2: kernels vs twins ------------------------------------------
    t0 = time.perf_counter()
    results, per_step, designs = kernel_phase(torch, card, dev)
    log(f"phase 2 kernels: wall {time.perf_counter() - t0:.1f} s")
    # phase 3: small reference -------------------------------------------
    t0 = time.perf_counter()
    small_reference_phase(torch, dev)
    log(f"phase 3 small reference: wall {time.perf_counter() - t0:.1f} s")
    # phase 4: main path -------------------------------------------------
    t0 = time.perf_counter()
    from cover_vla_tpu_torch.configs import CoVerConfig, Pi0Config, VerifierConfig
    pcfg, vcfg = Pi0Config(), VerifierConfig()
    pp, vp = init_full_width(torch, dev, pcfg, vcfg)
    cells = {"E16_N16_K1": (16, CoVerConfig(n_samples=16, n_rephrases=1)),
             "E1_N5_K8": (1, CoVerConfig(n_samples=5, n_rephrases=8))}
    launches = main_path_phase(torch, card, dev, pcfg, vcfg, pp, vp, cells)
    if launches != {"shared_prefix_gqa": 180, "mha_dense": 75,
                    "prefix_gqa": 18}:
        raise AssertionError(f"full-width launch counts {launches}")
    log(f"phase 4 main path: wall {time.perf_counter() - t0:.1f} s")
    # phase 5: closed-loop evaluation --------------------------------------
    t0 = time.perf_counter()
    episode_phase(torch, card, dev, pcfg, vcfg, pp, vp)
    log(f"phase 5 episodes: wall {time.perf_counter() - t0:.1f} s")
    # phase 6: serving -----------------------------------------------------
    t0 = time.perf_counter()
    int8_exactness(torch, card, dev, pp, vp)
    int8_step_phase(torch, card, dev, pcfg, vcfg, pp, vp, cells)
    from cover_vla_tpu_torch.configs import replace
    from cover_vla_tpu_torch.models.pi0fast import Pi0FastConfig
    # 64 of the 256 decode steps: the per-token time and the checks hold at
    # any length, and the run must leave room for phase 14
    fast_params = pi0fast_phase(torch, card, dev,
                                replace(Pi0FastConfig(), max_decoding_steps=64))
    serving_phase(torch, card, dev, pcfg, vcfg, pp, vp, fast_params)
    log(f"phase 6 serving: wall {time.perf_counter() - t0:.1f} s")
    # phase 7: checkpoints and the entry point ------------------------------
    t0 = time.perf_counter()
    del fast_params
    checkpoint_phase(torch, card, dev, pcfg, vcfg, pp, vp)
    log(f"phase 7 checkpoints: wall {time.perf_counter() - t0:.1f} s")
    # phase 8: training ------------------------------------------------------
    t0 = time.perf_counter()
    del pp, vp
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    training_phase(torch, card, dev)
    log(f"phase 8 training: wall {time.perf_counter() - t0:.1f} s")
    # phase 9: verifier and π0-FAST training --------------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    training_phase_9(torch, card, dev)
    log(f"phase 9 verifier and π0-FAST training: wall "
        f"{time.perf_counter() - t0:.1f} s")
    # phase 10: multi-process -------------------------------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    multiprocess_phase(torch, card, dev)
    log(f"phase 10 multi-process: wall {time.perf_counter() - t0:.1f} s")
    # phase 11: the bench role --------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    bench_phase(torch, card, dev)
    # phase 12: the experiment's trained trees ---------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    trained_launches = trained_phase(torch, card, dev)
    if trained_launches != {"shared_prefix_gqa": 10, "mha_dense": 7,
                            "prefix_gqa": 2}:
        raise AssertionError(f"trained launch counts {trained_launches}")
    log(f"phase 12 trained trees: wall {time.perf_counter() - t0:.1f} s")
    # phase 13: the experiment's training stages --------------------------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    stage_launches = stage_steps_phase(torch, card, dev)
    log(f"phase 13 training stages: wall {time.perf_counter() - t0:.1f} s")
    # phase 14: the last stages, the OOD diagnostics, the roofline ---------
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    last_launches = last_stages_phase(torch, card, dev)
    log(f"phase 14 last stages, diagnostics, roofline: wall "
        f"{time.perf_counter() - t0:.1f} s")
    log(f"all phases: wall {time.perf_counter() - t_start:.1f} s")

    replaces = {
        "shared_prefix_gqa": "cover_vla_tpu/ops/pallas_attention.py:135",
        "mha_dense": "cover_vla_tpu/ops/pallas_attention.py:270",
        "prefix_gqa": "cover_vla_tpu/ops/pallas_attention.py:314"}
    sources = {
        "shared_prefix_gqa": "cover_vla_tpu_torch/csrc/attention.cu",
        "mha_dense": "cover_vla_tpu_torch/csrc/dense_wgmma.cu",
        "prefix_gqa": "cover_vla_tpu_torch/csrc/prefix_attention.cu"}
    kernels = []
    for name, shapes in per_step.items():
        total = {key: sum(results[name][tag][key] * n
                          for tag, n in shapes.items())
                 for key in ("ms", "plain_ms", "library_ms", "bound_ms",
                             "device_ms", "library_device_ms")}
        bound_by = max(shapes, key=lambda tag: results[name][tag]["bound_ms"] * shapes[tag])
        kernels.append({
            "name": name, "route": "cuda", "design": designs[name],
            "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
            "launches_trained_step": trained_launches[name],
            "launches_training_stages": stage_launches[name],
            "launches_last_stages": last_launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in results[name].values()),
            **total, "bound_by": results[name][bound_by]["bound_by"],
            "per_step_of": {tag: n for tag, n in shapes.items()},
            "per_launch": {tag: {key: results[name][tag][key] for key in (
                "ms", "device_ms", "library_ms", "library_device_ms",
                "bound_ms", "plain_ms", "host_us")} for tag in shapes}})
    log(json.dumps({"kernels": kernels}))
    log(card_line())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-rank"]:     # a rank of phase 10.6
        gloo_parity_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                         sys.argv[5])
        sys.exit(0)
    sys.exit(main())
