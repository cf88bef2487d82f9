"""Validation: rolled-out action accuracy against the ground truth.

Sample an action chunk with zero noise and compare it per element with
the ground-truth chunk at several tolerance thresholds (INT-ACT's
BaseTrainer.validate and get_action_accuracy).
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from cover_vla_tpu_torch.configs import Pi0Config
from cover_vla_tpu_torch.models import pi0

DEFAULT_THRESHOLDS = (0.01, 0.05, 0.1)


def action_accuracy(pred: np.ndarray, gt: np.ndarray,
                    thresholds: Sequence[float] = DEFAULT_THRESHOLDS
                    ) -> Dict[str, float]:
    """Fraction of action elements within each absolute-error threshold."""
    err = np.abs(np.asarray(pred) - np.asarray(gt))
    out = {f"acc@{t}": float((err < t).mean()) for t in thresholds}
    out["mae"] = float(err.mean())
    return out


@torch.no_grad()
def validate_pi0(params, cfg: Pi0Config, batch: Dict,
                 thresholds: Sequence[float] = DEFAULT_THRESHOLDS,
                 seed: int = 0) -> Dict[str, float]:
    """Deterministic (zero-noise) chunk sampling against the batch's
    ground-truth actions, on the batch's device and under the config's
    attention backends. `seed` is unused: the noise is zero."""
    state = batch["state"]
    noise = torch.zeros((state.shape[0], 1, cfg.chunk_size,
                         cfg.max_action_dim), dtype=torch.float32,
                        device=state.device)
    pred = pi0.sample_actions(
        params, cfg, batch["images"], batch["img_masks"],
        batch["lang_tokens"], batch["lang_masks"], state,
        num_candidates=1, noise=noise)[:, 0]
    gt = np.asarray(torch.as_tensor(batch["actions"]).cpu())
    pad = batch.get("actions_is_pad")
    mask = ~np.asarray(torch.as_tensor(pad).cpu()) if pad is not None \
        else np.ones(gt.shape[:2], bool)
    return action_accuracy(pred.cpu().numpy()[mask], gt[mask], thresholds)
