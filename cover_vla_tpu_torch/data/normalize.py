"""Feature normalization layers (lerobot Normalize/Unnormalize equivalent).

Mirrors lerobot_custom/lerobot/common/policies/normalize.py:116,186:
per-feature mean_std / min_max / identity modes with stats held as buffers
(here: a plain dict of numpy arrays, so converted torch checkpoints'
normalization buffers — convert.pi0_from_torch.extract_norm_stats — plug
straight in).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np

Mode = str  # "mean_std" | "min_max" | "identity"


class Normalizer:
    """stats: {feature_name: {"mean","std"} or {"min","max"}};
    modes: {feature_name: mode}. Unknown features pass through."""

    def __init__(self, stats: Optional[Mapping[str, Mapping[str, np.ndarray]]]
                 = None, modes: Optional[Mapping[str, Mode]] = None,
                 eps: float = 1e-8):
        self.stats = {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                      for k, v in (stats or {}).items()}
        self.modes = dict(modes or {})
        self.eps = eps

    def _mode(self, key: str) -> Mode:
        return self.modes.get(key, "identity")

    def normalize(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        for key, x in batch.items():
            mode, s = self._mode(key), self.stats.get(key)
            if s is None or mode == "identity":
                continue
            if mode == "mean_std":
                out[key] = (x - s["mean"]) / (s["std"] + self.eps)
            elif mode == "min_max":
                out[key] = 2 * (x - s["min"]) / \
                    (s["max"] - s["min"] + self.eps) - 1
            else:
                raise ValueError(f"unknown mode {mode!r}")
        return out

    def unnormalize(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        for key, x in batch.items():
            mode, s = self._mode(key), self.stats.get(key)
            if s is None or mode == "identity":
                continue
            if mode == "mean_std":
                out[key] = x * (s["std"] + self.eps) + s["mean"]
            elif mode == "min_max":
                out[key] = (x + 1) / 2 * (s["max"] - s["min"] + self.eps) \
                    + s["min"]
            else:
                raise ValueError(f"unknown mode {mode!r}")
        return out
