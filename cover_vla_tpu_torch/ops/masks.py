"""Prefix-LM / block attention mask construction (big_vision mask_ar
convention): tokens attend to valid tokens whose cumulative att_mask is
<= their own, so
  att = [0,0,0,1,1,1] -> prefix-LM (bidirectional prefix, causal tail)
  att = [1,0,1,0]     -> block-causal over 2 blocks.
"""

from __future__ import annotations

import torch

from cover_vla_tpu_torch.utils.monitor import to_device


def make_att_2d_masks(pad_masks: torch.Tensor,
                      att_masks: torch.Tensor) -> torch.Tensor:
    """pad_masks: bool[B, N] (True = real token); att_masks: int[B, N]
    (1 where previous tokens may NOT attend to it). Returns bool[B, N, N]."""
    if att_masks.ndim != 2 or pad_masks.ndim != 2:
        raise ValueError("expected 2D pad/att masks")
    cumsum = torch.cumsum(att_masks.to(torch.int32), dim=1)
    att_2d = cumsum[:, None, :] <= cumsum[:, :, None]
    pad_2d = pad_masks[:, None, :] & pad_masks[:, :, None]
    return att_2d & pad_2d


def prefix_att_masks(batch: int, num_img_tokens: int, num_lang_tokens: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """att_masks for the pi0 prefix: all-bidirectional (zeros)."""
    return torch.zeros((batch, num_img_tokens + num_lang_tokens),
                       dtype=torch.int32, device=device)


def suffix_att_masks(batch: int, chunk_size: int,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """att_masks for the pi0 suffix: [1] state + [1, 0...] actions. The
    state starts a block (the prefix cannot attend to it); the action
    chunk is a second block, bidirectional within itself."""
    m = [1] + [1] + [0] * (chunk_size - 1)
    return to_device(m, device, torch.int32).expand(batch, -1)
