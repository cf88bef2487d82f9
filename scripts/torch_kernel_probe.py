#!/usr/bin/env python3
"""What a launch of the port's attention kernels is made of, on one NVIDIA
GPU: builds `cover_vla_tpu_torch/csrc` with parts of a kernel switched off
by its CVLA_PROBE_* flags (`flash_wgmma.cuh` for K2 and K3,
`decode_wgmma.cuh`'s CVLA_PROBE_DECODE_* for K1) and times the main shapes
inside a replayed CUDA graph.

    python3 scripts/torch_kernel_probe.py            # K2/K3's default variants
    python3 scripts/torch_kernel_probe.py k1         # K1's default variants
    python3 scripts/torch_kernel_probe.py full NO_KV_READS,NO_STORE ...

A variant is a comma-separated list of probe names without the prefix
(`WARPGROUPS=3` sets a value; `full` is the kernel as it is; `SPLIT=s`
makes K1 cut its prefix into s parts instead of its plan's). A variant
whose names all start with DECODE_ or SPLIT= times K1 at its three main
shapes, any other K2 and K3. Each variant is built and timed in a process
of its own; a probe build's results are wrong by construction, only its
time is read. Every line carries the card's name and power limit.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ["full", "NO_KV_READS", "NO_KV_READS,NO_SOFTMAX",
           "NO_KV_READS,NO_PRODUCTS", "NO_KV_READS,NO_PRODUCTS,NO_SOFTMAX",
           "NO_PRODUCTS,NO_SOFTMAX", "NO_PRODUCTS,NO_SOFTMAX,NO_STORE",
           "NO_KV_READS,NO_PRODUCTS,NO_SOFTMAX,NO_STORE",
           "WARPGROUPS=2", "WARPGROUPS=3", "WARPGROUPS=4",
           "WARPGROUPS=2,NO_PRODUCTS,NO_SOFTMAX,NO_STORE",
           "WARPGROUPS=4,NO_PRODUCTS,NO_SOFTMAX,NO_STORE"]
K1_DEFAULT = ["DECODE_full", "DECODE_NO_KV_READS", "DECODE_NO_PRODUCTS",
              "DECODE_NO_SOFTMAX", "DECODE_NO_COMBINE", "DECODE_NO_STORE",
              "DECODE_NO_PRODUCTS,DECODE_NO_SOFTMAX",
              "DECODE_NO_KV_READS,DECODE_NO_PRODUCTS,DECODE_NO_SOFTMAX",
              "DECODE_NO_KV_READS,DECODE_NO_PRODUCTS,DECODE_NO_SOFTMAX,"
              "DECODE_NO_COMBINE,DECODE_NO_STORE",
              "DECODE_EXIT_AT_START", "DECODE_NO_KV_READS,DECODE_EXIT_AFTER_Q",
              "SPLIT=1", "SPLIT=2", "SPLIT=3", "SPLIT=6"]


def is_k1(variant: str) -> bool:
    return all(name.startswith(("DECODE_", "SPLIT="))
               for name in variant.split(","))


def one(variant: str) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch
    from cover_vla_tpu_torch import _build
    names = variant.split(",")
    flags = tuple(f"-DCVLA_PROBE_{name}" for name in names
                  if name not in ("full", "DECODE_full")
                  and not name.startswith("SPLIT="))
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + flags     # part of the build's hash
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from torch_kernel_times import K1_SHAPES, graph_ms, k1_args

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    times = []
    if is_k1(variant):
        split = [int(n[6:]) for n in names if n.startswith("SPLIT=")]
        if split:
            plan = ca.decode_plan

            def forced(bh, rows, n_keys, sms=ca.H100_SMS):
                tiles = -(-n_keys // ca.DECODE_TILE_KEYS)
                per = -(-tiles // split[0])
                return ca.DecodePlan(split[0], per, plan(bh, rows, n_keys).row_blocks,
                                     0, 0.0)
            ca.decode_plan = forced
        for tag, shape in K1_SHAPES.items():
            args, _ = k1_args(rnd, dev, *shape)
            times.append(f"shared_prefix_gqa[{tag}] "
                         f"{graph_ms(ca.shared_prefix_gqa, args):.4f}")
        print(f"probe {variant}: ms in a graph: {', '.join(times)} | {card}",
              flush=True)
        return 0
    for tag, (b, s, h, d) in dict(vit_l16_384=(16, 576, 16, 64),
                                  so400m=(16, 256, 16, 72),
                                  text=(16, 64, 16, 64)).items():
        args = (rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d))
        times.append(f"mha_dense[{tag}] {graph_ms(ca.mha_dense, args):.4f}")
    b, s, hq, d, n_valid = 16, 328, 8, 256, 268
    pad = torch.zeros((b, s), dtype=torch.bool, device=dev)
    pad[:, :n_valid] = True
    mask = (pad[:, None, :] & pad[:, :, None]).contiguous()
    args = (rnd(b, s, hq, d), rnd(b, s, 1, d), rnd(b, s, 1, d), mask)
    times.append(f"prefix_gqa[bench] {graph_ms(ca.prefix_gqa, args):.4f}")
    print(f"probe {variant}: ms in a graph: {', '.join(times)} | {card}",
          flush=True)
    return 0


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        return one(sys.argv[2])
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device available", file=sys.stderr)
        return 1
    rc = 0
    variants = sys.argv[1:] or DEFAULT
    if variants == ["k1"]:
        variants = K1_DEFAULT
    for variant in variants:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", variant], cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
