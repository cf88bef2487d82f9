"""Host-side environment adapters (numpy).

Behavioural mirror of INT-ACT/src/experiments/env_adapters/
(base.py, simpler.py): observation preprocessing (LANCZOS4 resize ->
[-1, 1], proprio frame conversion + bound-normalisation) and action
postprocessing (bound-denormalise, euler -> axis-angle, gripper logic).

In the engine these transforms run on the device inside `verified_step`
(cover_vla_tpu_torch/engine); the host adapters feed the episode loops
their proprio, serve the google-robot gripper path, and are the golden
oracle the on-device versions are tested against.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, Optional

import numpy as np

from cover_vla_tpu_torch.data.stats import (
    DatasetStatistics, normalize_bound, denormalize_bound,
    normalize_gaussian, denormalize_gaussian, BRIDGE_STATS_PATH)
from cover_vla_tpu_torch.ops.image import resize_lanczos4_uint8
from cover_vla_tpu_torch.utils.geometry import quat2mat, mat2euler, euler2axangle


def lanczos4_resize_uint8(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """cv2.resize(..., INTER_LANCZOS4) on uint8, bit-exact (fixed-point
    path of imgproc/resize.cpp — see ops.image._lanczos4_fixed_tables)."""
    return resize_lanczos4_uint8(img, height, width)


class BaseEnvAdapter:
    """Normalization helpers (base.py:8-55)."""

    normalize_bound = staticmethod(normalize_bound)
    denormalize_bound = staticmethod(denormalize_bound)
    normalize_gaussian = staticmethod(normalize_gaussian)
    denormalize_gaussian = staticmethod(denormalize_gaussian)


class SimplerAdapter(BaseEnvAdapter):
    """SIMPLER observation/action adapter (simpler.py:19-181)."""

    def __init__(self, stats: Optional[DatasetStatistics] = None,
                 image_size=(224, 224),
                 action_normalization_type: str = "bound",
                 state_normalization_type: str = "bound"):
        self.stats = stats or DatasetStatistics.from_json(BRIDGE_STATS_PATH)
        self.image_size = tuple(image_size)
        assert action_normalization_type in ("bound", "gaussian")
        assert state_normalization_type in ("bound", "gaussian")
        self.action_normalization_type = action_normalization_type
        self.state_normalization_type = state_normalization_type

    def reset(self):
        pass

    # observations ---------------------------------------------------------

    def preprocess(self, obs: Dict) -> Dict:
        image = lanczos4_resize_uint8(obs["observation.images.top"],
                                      *self.image_size)
        # rescale 1/255 then (x - 0.5) / 0.5 -> [-1, 1] (pipeline.py:57-69)
        image_f = (image.astype(np.float32) / 255.0 - 0.5) / 0.5

        raw_proprio = self.preprocess_proprio(obs["observation.state"])
        st = self.stats.proprio
        if self.state_normalization_type == "bound":
            proprio = self.normalize_bound(raw_proprio, st.p01, st.p99)
        else:
            proprio = self.normalize_gaussian(raw_proprio, st.mean, st.std)

        return {
            "observation.images.top": image_f[None],     # [1, H, W, 3]
            "observation.state": proprio[None].astype(np.float32),
            "task": [obs["task"]],
        }

    # actions --------------------------------------------------------------

    def _denorm_except_gripper(self, actions: np.ndarray) -> np.ndarray:
        st = self.stats.action
        if self.action_normalization_type == "bound":
            body = self.denormalize_bound(actions[:, :-1], st.p01[:-1],
                                          st.p99[:-1])
        else:
            body = self.denormalize_gaussian(actions[:, :-1], st.mean[:-1],
                                             st.std[:-1])
        return np.concatenate([body, actions[:, -1:]], axis=1)

    def postprocess(self, actions: np.ndarray) -> np.ndarray:
        """Execution format: [dx dy dz | axis-angle | gripper ±1]."""
        raw = self._denorm_except_gripper(np.asarray(actions, np.float64))
        out = np.zeros((len(raw), 7))
        for i, a in enumerate(raw):
            axis, angle = euler2axangle(*a[3:6])
            out[i] = np.concatenate(
                [a[:3], axis * angle, [self.postprocess_gripper(a[-1])]])
        return out

    def postprocess_verifier(self, actions: np.ndarray) -> np.ndarray:
        """Verifier format: [dx dy dz | roll pitch yaw | gripper {0,1}]."""
        raw = self._denorm_except_gripper(np.asarray(actions, np.float64))
        out = np.zeros((len(raw), 7))
        for i, a in enumerate(raw):
            out[i] = np.concatenate(
                [a[:6], [self.postprocess_gripper_verifier(a[-1])]])
        return out

    def preprocess_proprio(self, obs) -> np.ndarray:
        raise NotImplementedError

    def postprocess_gripper(self, action: float) -> float:
        raise NotImplementedError

    def postprocess_gripper_verifier(self, action: float) -> float:
        raise NotImplementedError


class BridgeSimplerAdapter(SimplerAdapter):
    """WidowX Bridge adapter (simpler.py:184-243).

    Bridge EE pose is expressed relative to a top-down frame; proprio
    rotation is re-expressed by right-multiplying with default_rot^T.
    """

    DEFAULT_ROT = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])

    def preprocess_proprio(self, obs) -> np.ndarray:
        proprio = obs["agent"]["eef_pos"]
        rm = quat2mat(np.asarray(proprio[3:7], np.float64))
        rpy = mat2euler(rm @ self.DEFAULT_ROT.T)
        return np.concatenate([proprio[:3], rpy, [proprio[7]]])

    def postprocess_gripper(self, action: float, binarize: bool = False) -> float:
        # trained with [0,1] (0=close, 1=open) -> simpler wants -1 close / 1 open
        g = 2.0 * (action > 0.5) - 1.0
        return float(np.sign(g)) if binarize else float(g)

    def postprocess_gripper_verifier(self, action: float) -> float:
        return 0.0 if action < 0.5 else 1.0


class ActionEnsembler:
    """Temporal exponential action ensembling
    (simpler.py:528-555 ActionEnsembler, used by Octo-style adapters)."""

    def __init__(self, pred_horizon: int, ensemble_temp: float = -0.8):
        self.pred_horizon = pred_horizon
        self.ensemble_temp = ensemble_temp
        self.action_history = deque(maxlen=pred_horizon)

    def reset(self):
        self.action_history.clear()

    def ensemble(self, actions: np.ndarray) -> np.ndarray:
        """actions: [pred_horizon, action_dim] latest chunk prediction."""
        self.action_history.append(np.asarray(actions))
        num = len(self.action_history)
        # i-th oldest prediction contributes its (num-1-i)-th step
        curr = np.stack([pred[num - 1 - i]
                         for i, pred in enumerate(reversed(self.action_history))])
        weights = np.exp(self.ensemble_temp * np.arange(num))
        weights = weights / weights.sum()
        return (weights[:, None] * curr).sum(axis=0)


class BridgeSimplerStickyGripperAdapter(BridgeSimplerAdapter):
    """Sticky-gripper variant used by fractal-style adapters
    (simpler.py:394-526): the gripper only toggles after the command has
    persisted, debouncing chatter."""

    def __init__(self, *args, sticky_steps: int = 1, **kwargs):
        super().__init__(*args, **kwargs)
        self.sticky_steps = sticky_steps
        self.reset()

    def reset(self):
        super().reset()
        self._sticky_action = -1.0
        self._pending_action = -1.0
        self._pending_count = 0

    def postprocess_gripper(self, action: float, binarize: bool = False) -> float:
        g = 2.0 * (action > 0.5) - 1.0
        if g != self._sticky_action:
            if g == self._pending_action:
                self._pending_count += 1
            else:
                self._pending_action = g
                self._pending_count = 1
            if self._pending_count >= self.sticky_steps:
                self._sticky_action = g
        return float(self._sticky_action)
