"""Normalization ops.

Gemma RMSNorm computes in fp32 with a (1 + weight) scale and returns the
input dtype; the MLA + MoE stack's RMSNorm scales by the weight itself;
SigLIP LayerNorm is a standard affine LayerNorm computed in fp32 and
returned in the input dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Gemma-style RMSNorm: fp32 compute, (1 + w) scaling, cast back."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    x32 = x32 * torch.rsqrt(var + eps)
    return (x32 * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    """Standard LayerNorm, computed in fp32, returned in input dtype."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    out = (x32 - mean) * torch.rsqrt(var + eps)
    return (out * weight.float() + bias.float()).to(x.dtype)


def scaled_rms_norm(x: torch.Tensor, weight: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    """DeepSeek/Llama-style RMSNorm: weight * x / rms(x), fp32 compute,
    cast back to the input dtype."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
