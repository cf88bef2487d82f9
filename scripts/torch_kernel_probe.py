#!/usr/bin/env python3
"""What a launch of the port's warpgroup attention kernels (K2, K3) is made
of, on one NVIDIA GPU: builds `cover_vla_tpu_torch/csrc` with parts of
`flash_wgmma.cuh` switched off by its CVLA_PROBE_* flags and times the main
shapes inside a replayed CUDA graph.

    python3 scripts/torch_kernel_probe.py            # the default variants
    python3 scripts/torch_kernel_probe.py full NO_KV_READS,NO_STORE ...

A variant is a comma-separated list of probe names without the prefix
(`WARPGROUPS=3` sets a value; `full` is the kernel as it is). Each variant
is built and timed in a process of its own; a probe build's results are
wrong by construction, only its time is read. Every line carries the card's
name and power limit.
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


def one(variant: str) -> int:
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch
    from cover_vla_tpu_torch import _build
    flags = tuple(f"-DCVLA_PROBE_{name}" for name in variant.split(",")
                  if name != "full")
    _build.NVCC_FLAGS = _build.NVCC_FLAGS + flags     # part of the build's hash
    from cover_vla_tpu_torch.ops import cuda_attention as ca
    from torch_kernel_times import graph_ms

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    times = []
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
    for variant in sys.argv[1:] or DEFAULT:
        rc |= subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", variant], cwd=ROOT).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
