"""Blockwise 8-bit AdamW (the bitsandbytes AdamW8bit counterpart).

The Adam moments are stored as int8 with per-block fp32 absmax scales
(`block_size` consecutive elements share a scale); the update dequantises,
applies fp32 Adam math with bias correction and decoupled weight decay,
casts the update to the leaf's dtype, and requantises. The grids are
bit-equal to the JAX package's given the same gradients: every division
is a true division by a tensor on the leaf's device, and rounding is
half to even.
"""

from __future__ import annotations

from typing import Tuple

import torch

from cover_vla_tpu_torch.training.optim import (
    Consts, GradientTransformation, counter, sqrt)


def _quantize(x: torch.Tensor, block: int) -> dict:
    """{"values": int8 [-1, block] (zero-padded, flat), "scales": fp32
    [-1, 1]}: scale = max|x| / 127 per block, values round(x / max(scale,
    1e-20)) with ties to even."""
    flat = x.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % block))
    flat = flat.reshape(-1, block)
    scales = flat.abs().amax(dim=1, keepdim=True) / torch.tensor(
        127.0, dtype=flat.dtype, device=flat.device)
    q = torch.round(flat / scales.clamp_min(1e-20))
    return {"values": q.to(torch.int8), "scales": scales.float()}


def _dequantize(q: dict, shape: Tuple[int, ...]) -> torch.Tensor:
    flat = q["values"].float() * q["scales"]
    return flat.reshape(-1)[:shape.numel()].reshape(shape)


def adamw_8bit(learning_rate, b1: float = 0.9, b2: float = 0.95,
               eps: float = 1e-8, weight_decay: float = 1e-10,
               block_size: int = 256) -> GradientTransformation:
    """AdamW with int8 moments. The learning rate is read at the
    post-update count (count + 1), unlike optax's AdamW."""
    def init(params):
        def zeros(p):
            return _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                         device=p.device), block_size)
        return {"count": counter(),
                "mu": {k: zeros(p) for k, p in params.items()},
                "nu": {k: zeros(p) for k, p in params.items()}}

    @torch.no_grad()
    def update(grads, state, params):
        count = state["count"] + 1
        lr = learning_rate(int(count)) if callable(learning_rate) \
            else learning_rate
        f32 = torch.float32
        bc1 = Consts(1 - torch.tensor(b1, dtype=f32) ** count.float())
        bc2 = Consts(1 - torch.tensor(b2, dtype=f32) ** count.float())
        neg_lr = Consts(-torch.tensor(lr, dtype=f32))
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            g = g.float()
            m = b1 * _dequantize(state["mu"][k], g.shape) + (1 - b1) * g
            v = b2 * _dequantize(state["nu"][k], g.shape) + (1 - b2) * g * g
            v = v.clamp_min(0.0)
            step = (m / bc1.like(g)) / (sqrt(v / bc2.like(g)) + eps)
            step = step + weight_decay * params[k].float()
            updates[k] = (neg_lr.like(g) * step).to(params[k].dtype)
            mu[k] = _quantize(m, block_size)
            nu[k] = _quantize(v, block_size)
        return updates, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)
