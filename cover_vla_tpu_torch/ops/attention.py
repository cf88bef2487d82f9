"""Eager attention ops: GQA / MHA with fp32 scores and softmax.

Queries and keys are upcast to fp32, scores are scaled by head_dim**-0.5
and masked with a large negative constant, the softmax runs in fp32, and
the probabilities are cast back to the value dtype for the PV product.
Shapes are [B, S, H, D] throughout.
"""

from __future__ import annotations

import torch

BIG_NEG = -2.3819763e38  # the reference's masking constant

ATTN_BACKENDS = ("eager", "cuda")

# The JAX package's switch for reduced-precision score products. The port's
# eager attention computes its scores in full fp32 whatever it is set to
# (the JAX package does the same on the CPU); the switch and its reading
# keep the JAX package's interface.
_FAST_MATH = False


def set_fast_math(enabled: bool) -> None:
    """Record the JAX package's fast-math request. The port's eager score
    products stay full fp32 either way."""
    global _FAST_MATH
    _FAST_MATH = bool(enabled)


def score_precision() -> str:
    """The score-product precision the JAX package would pick under the
    current request, by its name: "default" when fast math was asked
    for, else "highest"."""
    return "default" if _FAST_MATH else "highest"


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Grouped-query attention. q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]
    (Hq % Hkv == 0); mask: bool[B, Sq, Skv], True = attend.
    Returns [B, Sq, Hq * D] in v.dtype."""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    q32 = q.float().reshape(b, sq, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q32, k.float()) * (d ** -0.5)
    scores = torch.where(mask[:, None, None], scores, BIG_NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, hq * d)


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None = None,
                  bias: torch.Tensor | None = None,
                  backend: str = "eager") -> torch.Tensor:
    """Multi-head attention for the ViT towers and the verifier heads.

    q: [B, Sq, H, D]; k, v: [B, Skv, H, D]; mask: optional bool[B, Sq, Skv]
    (True = attend); bias: optional float[B, Sq, Skv] added to the scores.
    backend "cuda" runs the dense flash kernel, for mask- and bias-free
    calls only; everything else is eager. Returns [B, Sq, H * D].
    """
    if backend not in ATTN_BACKENDS:
        raise ValueError(f"unknown attention backend {backend!r}")
    if backend == "cuda" and mask is None and bias is None:
        from cover_vla_tpu_torch.ops.cuda_attention import mha_dense
        return mha_dense(q, k, v)
    b, sq, h, d = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (d ** -0.5)
    if bias is not None:
        scores = scores + bias[:, None].float()
    if mask is not None:
        scores = torch.where(mask[:, None], scores, BIG_NEG)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v)
    return out.reshape(b, sq, h * d)
