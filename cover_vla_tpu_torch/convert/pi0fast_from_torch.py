"""Convert lerobot pi0-FAST torch checkpoints -> the port's parameters.

Source: PI0FAST (lerobot's modeling_pi0fast.py) — `pi0_paligemma` is a
plain PaliGemmaForConditionalGeneration; keys live under
model.pi0_paligemma.* (or pi0_paligemma.* for a bare module). Reuses the
Gemma/SigLIP converters of pi0_from_torch; the result is a `ParamTree` in
the layout of `pi0fast.init_pi0fast`, on `device` (CUDA unless given).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from cover_vla_tpu_torch.convert.pi0_from_torch import (
    StateDict, _c, _gemma, _siglip_vision, _t, find_prefix)
from cover_vla_tpu_torch.convert import from_jax
from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.models.pi0fast import Pi0FastConfig


def _pi0fast(sd: StateDict, cfg: Pi0FastConfig,
             dtype: torch.dtype) -> Dict[str, Any]:
    keys = list(sd.keys())
    root = find_prefix(keys, ("model.pi0_paligemma.", "pi0_paligemma.")) or ""
    lm_prefix = find_prefix(keys, (root + "language_model.model",
                                   root + "model.language_model",
                                   root + "language_model"), ".layers.0.")
    if lm_prefix is None:
        raise KeyError("could not locate the PaliGemma language model")
    vt_prefix = find_prefix(keys, (root + "vision_tower.vision_model",
                                   root + "model.vision_tower.vision_model"))
    mm_key = next((c for c in (root + "multi_modal_projector.linear",
                               root + "multi_modal_projector",
                               root + "model.multi_modal_projector.linear",
                               root + "model.multi_modal_projector")
                   if c + ".weight" in sd), None)
    if mm_key is None:
        raise KeyError("could not locate the multi-modal projector")
    return {
        "vision": _siglip_vision(sd, cfg.vision, vt_prefix, dtype),
        "mm_proj": {"kernel": _c(_t(sd, mm_key + ".weight").t(),
                                 torch.float32),
                    "bias": _c(_t(sd, mm_key + ".bias"), torch.float32)},
        "paligemma": _gemma(sd, cfg.paligemma, lm_prefix, True, dtype),
    }


def convert_pi0fast(sd: StateDict, cfg: Pi0FastConfig, dtype=torch.bfloat16,
                    device=None) -> ParamTree:
    return from_jax.pi0fast_from_jax(_pi0fast(sd, cfg, dtype), cfg, device)
