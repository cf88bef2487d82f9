"""Sampling / embedding helpers for the flow-matching policy."""

from __future__ import annotations

import numpy as np
import torch

from cover_vla_tpu_torch.utils.monitor import to_device


def sinusoidal_time_embedding(time: torch.Tensor, dimension: int,
                              min_period: float = 4e-3,
                              max_period: float = 4.0) -> torch.Tensor:
    """[B] scalar times -> [B, dimension] sin/cos embedding (fp32)."""
    if dimension % 2 != 0:
        raise ValueError(f"dimension ({dimension}) must be even")
    # static constants computed in float64, then fp32
    fraction = np.linspace(0.0, 1.0, dimension // 2, dtype=np.float64)
    period = min_period * (max_period / min_period) ** fraction
    scaling = to_device((1.0 / period * 2 * np.pi).astype(np.float32),
                        time.device)
    sin_input = scaling[None, :] * time.float()[:, None]
    return torch.cat([torch.sin(sin_input), torch.cos(sin_input)], dim=1)


def sample_beta(alpha: float, beta: float, bsize: int, *,
                generator: torch.Generator | None = None,
                device: torch.device | str) -> torch.Tensor:
    """Beta(alpha, beta) samples via u1^(1/a) / (u1^(1/a) + u2^(1/b)),
    the two uniforms drawn from `generator` in that order."""
    u1 = torch.rand((bsize,), generator=generator, device=device)
    u2 = torch.rand((bsize,), generator=generator, device=device)
    g1 = u1 ** (1.0 / alpha)
    g2 = u2 ** (1.0 / beta)
    return g1 / (g1 + g2)


def sample_flow_time(bsize: int, *, generator: torch.Generator | None = None,
                     device: torch.device | str) -> torch.Tensor:
    """pi0 training time distribution: Beta(1.5, 1) * 0.999 + 0.001."""
    return sample_beta(1.5, 1.0, bsize, generator=generator,
                       device=device) * 0.999 + 0.001


def sample_noise(shape, noise_std: float = 1.0, *,
                 generator: torch.Generator | None = None,
                 device: torch.device | str) -> torch.Tensor:
    """fp32 Gaussian noise; noise_std drives best-of-N candidate
    diversity. Draws from `generator` (or the device's default one)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32,
                       device=device) * noise_std
