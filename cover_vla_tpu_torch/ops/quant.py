"""int8 (w8a8) quantized matmul path for serving.

Serving-only and opt-in: weights are quantized once per checkpoint load
(`quantize_pi0_policy`, `quantize_verifier`), activations per token at run
time; the default path stays bf16.

Scheme: symmetric per-output-channel weight scales, symmetric per-token
dynamic activation scales (absmax / 127), int8 x int8 -> int32
accumulation, fp32 rescale, cast back to the compute dtype. The parameter
tree itself carries the mode: a quantized Gemma stack stores `<name>` as
int8 plus `<name>_scale` fp32 [depth, 1, N], a quantized ViT matmul
`{kernel: int8, scale, bias}`; `gemma._mm` and `siglip._vmm` dispatch on
the scale's presence.

The grids are the reference package's bit for bit: fp32 absmax / 127 by
true division (never a multiplication by a rounded reciprocal, which the
CUDA division by a host scalar would be), a 1e-12 floor, round half to
even, clamp to +-127. The int8 product is exact: cuBLASLt's int8 GEMM
with int32 accumulation (`torch._int_mm`) on CUDA, a float64 product on
the CPU (every partial sum is an integer below 2^53). An int8 weight is
kept as the transpose of an [..., N, K] contiguous tensor: the same shape
and values as the reference's [..., K, N], and one layer's slice is the
column-major B operand that cuBLASLt's int8 path takes without a copy.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from cover_vla_tpu_torch.models.params import ParamTree

# weight names carrying the Gemma stack's matmuls
GEMMA_MATMUL_KEYS = ("q", "k", "v", "o", "gate", "up", "down")
# ViT block matmul sub-dicts ({kernel, bias}) relative to one block entry
VIT_MATMUL_PATHS = (("attn", "q"), ("attn", "k"), ("attn", "v"),
                    ("attn", "o"), ("mlp", "fc1"), ("mlp", "fc2"))

# torch._int_mm takes more than this many rows; fewer are zero-padded
_INT_MM_MIN_ROWS = 17

# int8 products run through torch._int_mm since the last reset
int_mm_calls = {"int_mm": 0}


def reset_int_mm_calls() -> None:
    int_mm_calls["int_mm"] = 0


def _absmax_scale(x32: torch.Tensor, dim: int) -> torch.Tensor:
    # a device tensor as divisor keeps the division true on CUDA
    div = x32.new_full((), 127.0)
    return (x32.abs().amax(dim=dim, keepdim=True) / div).clamp_min(1e-12)


def _to_int8(x32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.round(x32 / scale).clamp(-127, 127).to(torch.int8)


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K, N] weight -> (int8 weight [..., K, N], fp32 scale
    [..., 1, N]). Per-output-channel symmetric: scale = absmax / 127 over
    the contraction axis. The int8 weight is stored column-major (module
    docstring)."""
    w32 = w.float()
    scale = _absmax_scale(w32, -2)
    q = _to_int8(w32, scale)
    return q.transpose(-1, -2).contiguous().transpose(-1, -2), scale


def quant_act(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., K] activations -> (int8, fp32 per-token scale [..., 1])."""
    x32 = x.float()
    scale = _absmax_scale(x32, -1)
    return _to_int8(x32, scale), scale


def int8_accumulate(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int32 product of int8 [..., K] by int8 [K, N] -> [..., N]."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    a = xq.reshape(-1, k)
    if xq.device.type != "cuda":
        return (a.double() @ wq.double()).to(torch.int32).reshape(
            *lead, wq.shape[-1])
    m = a.shape[0]
    if m < _INT_MM_MIN_ROWS:
        a = F.pad(a, (0, 0, 0, _INT_MM_MIN_ROWS - m))
    int_mm_calls["int_mm"] += 1
    return torch._int_mm(a.contiguous(), wq)[:m].reshape(*lead, wq.shape[-1])


def int8_matmul(xq: torch.Tensor, xs: torch.Tensor, wq: torch.Tensor,
                ws: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """(int8 [..., K] @ int8 [K, N]) * scales -> out_dtype [..., N].

    The accumulation is exact; all quantization error lives in the
    rounding of x and w. The rescale keeps the reference's order,
    (acc * xs) * ws, so the result is bit-equal to it."""
    acc = int8_accumulate(xq, wq)
    return ((acc.float() * xs) * ws.reshape(-1)).to(out_dtype)


def _children(tree) -> dict:
    return {k: tree[k] for k in tree}


def quantize_gemma_stack(params) -> ParamTree:
    """Quantize one Gemma stack ({'layers', 'final_norm', optional
    'embed'}): each matmul weight [depth, K, N] becomes int8 with a fp32
    `<name>_scale` [depth, 1, N]. Norms and the embedding stay as they
    are (shared, not copied)."""
    layers = _children(params["layers"])
    for name in GEMMA_MATMUL_KEYS:
        layers[name], layers[name + "_scale"] = quantize_weight(layers[name])
    out = _children(params)
    out["layers"] = layers
    return ParamTree(out)


def _quantize_dense(sub) -> dict:
    """{kernel, bias} -> {kernel: int8, scale, bias} (`siglip._vmm`
    dispatches on the `scale` key)."""
    out = _children(sub)
    out["kernel"], out["scale"] = quantize_weight(sub["kernel"])
    return out


def quantize_vit_stack(params) -> ParamTree:
    """Quantize a ViT stack's block matmuls ([depth, K, N] stacked
    kernels, per-output-channel scales). Patch embed, norms, biases and
    positional embeddings stay as they are."""
    blocks = _children(params["blocks"])
    for outer, inner in VIT_MATMUL_PATHS:
        blocks[outer] = _children(blocks[outer])
        blocks[outer][inner] = _quantize_dense(blocks[outer][inner])
    out = _children(params)
    out["blocks"] = blocks
    return ParamTree(out)


def quantize_pi0_policy(params, vision: bool = True) -> ParamTree:
    """Serving-time transform of a full pi0 tree: int8-quantize the two
    Gemma stacks (PaliGemma LM and action expert) and, by default, the
    SigLIP vision tower's block matmuls. The fp32 action/state
    projections stay fp32; untouched subtrees are shared."""
    out = _children(params)
    out["paligemma"] = quantize_gemma_stack(params["paligemma"])
    out["expert"] = quantize_gemma_stack(params["expert"])
    if vision:
        out["vision"] = quantize_vit_stack(params["vision"])
    return ParamTree(out)


def quantize_verifier(params) -> ParamTree:
    """Serving-time transform of a verifier tree: int8-quantize the
    SigLIP2 backbone ViT's block matmuls. The text tower, trajectory
    encoder and ensemble heads stay in their trained dtypes."""
    out = _children(params)
    backbone = _children(params["backbone"])
    backbone["vision"] = quantize_vit_stack(params["backbone"]["vision"])
    out["backbone"] = backbone
    return ParamTree(out)


def is_quantized(layer: Mapping) -> bool:
    return "q_scale" in layer


def dequantize_weight(wq: torch.Tensor, ws: torch.Tensor,
                      dtype=torch.bfloat16) -> torch.Tensor:
    """Exact inverse of the grid mapping (for tests/debug)."""
    return (wq.float() * ws).to(dtype)


def quant_error_stats(w) -> Dict[str, float]:
    """Relative RMS error of the int8 grid for a weight tensor."""
    w32 = np.asarray(w, np.float32)
    q, s = quantize_weight(torch.from_numpy(w32))
    deq = q.float().numpy() * s.numpy()
    rms = float(np.sqrt(np.mean(w32 ** 2))) or 1.0
    return {"rel_rms_err": float(np.sqrt(np.mean((deq - w32) ** 2))) / rms}
