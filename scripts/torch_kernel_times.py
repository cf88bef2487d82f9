#!/usr/bin/env python3
"""Times the port's decode (K1), dense (K2) and prefill (K3) attention
kernels at the main path's shapes on one NVIDIA GPU, through the public
wrappers of `cover_vla_tpu_torch.ops.cuda_attention` of the checkout it is
started in:

    python3 scripts/torch_kernel_times.py [label] [k1,k2,k3]

Run from the root of two checkouts in turns (parent, change, change,
parent) inside one job, it compares two designs of a kernel on one card.
Per shape it prints the time of one call in a stream of enqueued calls,
inside a replayed CUDA graph (device time without the host), the host time
of one enqueue, and the same for one `scaled_dot_product_attention` call
as a yardstick (for K1 over the prefix expanded across candidates); every
line carries the card's name and power limit. The second argument picks
the kernels (all three by default).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

sys.path.insert(0, os.getcwd())

import torch
import torch.nn.functional as F

from cover_vla_tpu_torch.ops import cuda_attention as ca


def stream_ms(fn, args, iters=50):
    fn(*args)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, args, launches=20, replays=5):
    fn(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (launches * replays)


def host_us(fn, args, calls=300):
    fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn(*args)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# K1's main shapes (B, N, S, G, D, P, real prefix keys): the E=16 x N=16
# step, the 5x8 protocol and the episode path's cohort of 4 x 8 rephrases
K1_SHAPES = dict(bench=(16, 16, 5, 8, 256, 328, 268),
                 protocol=(8, 5, 5, 8, 256, 328, 268),
                 cohort=(32, 5, 5, 8, 256, 328, 268))


def k1_args(rnd, dev, b, n, s, g, d, p, n_valid):
    """K1's inputs with Hkv = 1: q, k_suf, v_suf, k_pre, v_pre, prefix_pad,
    the action expert's suffix mask; and SDPA's over [prefix expanded over
    the candidates | own suffix]."""
    from cover_vla_tpu_torch.ops.masks import make_att_2d_masks, suffix_att_masks
    pad = torch.zeros((b, p), dtype=torch.bool, device=dev)
    pad[:, :n_valid] = True
    smask = make_att_2d_masks(torch.ones((b, s), dtype=torch.bool, device=dev),
                              suffix_att_masks(b, s - 1, device=dev)).contiguous()
    args = (rnd(b, n, s, g, d), rnd(b, n, s, 1, d), rnd(b, n, s, 1, d),
            rnd(b, p, 1, d), rnd(b, p, 1, d), pad, smask)
    q, ks, vs, kp, vp = args[:5]
    k = torch.cat([kp[:, None].expand(b, n, p, 1, d), ks], dim=2)
    v = torch.cat([vp[:, None].expand(b, n, p, 1, d), vs], dim=2)
    mask = torch.cat([pad[:, None, :].expand(b, s, p), smask], dim=2)
    lib_args = (q.reshape(b * n, s, g, d).transpose(1, 2),
                k.reshape(b * n, p + s, 1, d).transpose(1, 2).expand(
                    b * n, g, p + s, d),
                v.reshape(b * n, p + s, 1, d).transpose(1, 2).expand(
                    b * n, g, p + s, d),
                mask[:, None, None].expand(b, n, 1, s, p + s).reshape(
                    b * n, 1, s, p + s))
    return args, lib_args


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device available", file=sys.stderr)
        return 1
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    kernels = sys.argv[2].split(",") if len(sys.argv) > 2 else ["k1", "k2", "k3"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def report(name, fn, args, lib, lib_args):
        print(f"{label} {name}: kernel {stream_ms(fn, args):.4f} ms in a "
              f"stream, {graph_ms(fn, args):.4f} ms in a graph, host enqueue "
              f"{host_us(fn, args):.1f} us; SDPA {stream_ms(lib, lib_args):.4f}"
              f" / {graph_ms(lib, lib_args):.4f} ms | {card}", flush=True)

    for tag, shape in K1_SHAPES.items():
        if "k1" not in kernels:
            break
        args, lib_args = k1_args(rnd, dev, *shape)
        report(f"shared_prefix_gqa[{tag}]", ca.shared_prefix_gqa, args,
               lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
                   qq, kk, vv, attn_mask=mm), lib_args)
    for tag, (b, s, h, d) in dict(so400m=(16, 256, 16, 72),
                                  vit_l16_384=(16, 576, 16, 64),
                                  text=(16, 64, 16, 64)).items():
        if "k2" not in kernels:
            break
        args = (rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d))
        report(f"mha_dense[{tag}]", ca.mha_dense, args,
               lambda q, k, v: F.scaled_dot_product_attention(q, k, v),
               tuple(x.transpose(1, 2).contiguous() for x in args))
    for tag, b in dict(bench=16, protocol=8).items():
        if "k3" not in kernels:
            break
        s, hq, d, n_valid = 328, 8, 256, 268
        pad = torch.zeros((b, s), dtype=torch.bool, device=dev)
        pad[:, :n_valid] = True
        mask = (pad[:, None, :] & pad[:, :, None]).contiguous()
        args = (rnd(b, s, hq, d), rnd(b, s, 1, d), rnd(b, s, 1, d), mask)
        q, k, v, _ = args
        lib_args = (q.transpose(1, 2).contiguous(),
                    k.expand(b, s, hq, d).transpose(1, 2).contiguous(),
                    v.expand(b, s, hq, d).transpose(1, 2).contiguous(),
                    mask[:, None])
        report(f"prefix_gqa[{tag}]", ca.prefix_gqa, args,
               lambda qq, kk, vv, mm: F.scaled_dot_product_attention(
                   qq, kk, vv, attn_mask=mm), lib_args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
