"""Dataset statistics and normalisation (bound / gaussian).

The vendored ``bridge_statistics.json`` beside this file is dataset
metadata (p01/p99/mean/std over 2.19M Bridge transitions), the same file
the reference package ships.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

_HERE = os.path.dirname(__file__)
BRIDGE_STATS_PATH = os.path.join(_HERE, "bridge_statistics.json")


@dataclass(frozen=True)
class FieldStats:
    mean: np.ndarray
    std: np.ndarray
    p01: np.ndarray
    p99: np.ndarray
    minimum: np.ndarray
    maximum: np.ndarray


@dataclass(frozen=True)
class DatasetStatistics:
    action: FieldStats
    proprio: FieldStats
    num_transitions: int
    num_trajectories: int

    @staticmethod
    def from_json(path: str = BRIDGE_STATS_PATH) -> "DatasetStatistics":
        with open(path) as f:
            raw = json.load(f)

        def field(d) -> FieldStats:
            return FieldStats(
                mean=np.asarray(d["mean"], np.float64),
                std=np.asarray(d["std"], np.float64),
                p01=np.asarray(d["p01"], np.float64),
                p99=np.asarray(d["p99"], np.float64),
                minimum=np.asarray(d["min"], np.float64),
                maximum=np.asarray(d["max"], np.float64),
            )

        return DatasetStatistics(
            action=field(raw["action"]),
            proprio=field(raw["proprio"]),
            num_transitions=int(raw.get("num_transitions", 0)),
            num_trajectories=int(raw.get("num_trajectories", 0)),
        )


# normalisation math on numpy arrays (the host adapters) ---------------------


def normalize_bound(data, data_min, data_max, clip_min=-1.0, clip_max=1.0,
                    eps=1e-8):
    ndata = 2 * (data - data_min) / (data_max - data_min + eps) - 1
    return np.clip(ndata, clip_min, clip_max)


def denormalize_bound(data, data_min, data_max, clip_min=-1.0, clip_max=1.0,
                      eps=1e-8):
    clip_range = clip_max - clip_min
    return (data - clip_min) / clip_range * (data_max - data_min) + data_min


def normalize_gaussian(data, mean, std, eps=1e-8):
    return (data - mean) / (std + eps)


def denormalize_gaussian(data, mean, std, eps=1e-8):
    return data * (std + eps) + mean
