"""Fractal / Google-robot (EDR) adapters with Octo-style sticky gripper.

Mirrors EDRSimplerAdapter / EDREulerSimplerAdapter
(INT-ACT/src/experiments/env_adapters/simpler.py:394-526): fractal proprio
uses xyzw quats (or euler) + gripper CLOSEDNESS; the gripper command is
converted [0,1] -> [-1,1], inverted, and held sticky for
sticky_gripper_num_repeat steps (15, ~5 s at 3 Hz).
"""

from __future__ import annotations

import numpy as np

from cover_vla_tpu_torch.eval.adapters import SimplerAdapter
from cover_vla_tpu_torch.utils.geometry import quat2mat, mat2euler


class _StickyGripperMixin:
    sticky_gripper_num_repeat = 15

    def reset(self):
        self.sticky_action_is_on = False
        self.gripper_action_repeat = 0
        self.sticky_gripper_action = 0.0
        super().reset()

    def postprocess_gripper(self, action: float) -> float:
        """[0,1] (0 close, 1 open) -> sticky relative command, -1 open /
        +1 close (simpler.py:427-459)."""
        action = (action * 2) - 1
        relative = -action
        if np.abs(relative) > 0.5 and not self.sticky_action_is_on:
            self.sticky_action_is_on = True
            self.sticky_gripper_action = relative
        if self.sticky_action_is_on:
            self.gripper_action_repeat += 1
            relative = self.sticky_gripper_action
        if self.gripper_action_repeat == self.sticky_gripper_num_repeat:
            self.sticky_action_is_on = False
            self.gripper_action_repeat = 0
            self.sticky_gripper_action = 0.0
        return float(relative)

    def postprocess_gripper_verifier(self, action: float) -> float:
        return 0.0 if action < 0.5 else 1.0


class EDRSimplerAdapter(_StickyGripperMixin, SimplerAdapter):
    """Fractal proprio: [xyz, quat xyzw, gripper closedness]."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reset()

    def preprocess_proprio(self, obs) -> np.ndarray:
        eef = np.asarray(obs["agent"]["eef_pos"], np.float64)
        quat_xyzw = np.roll(eef[3:7], -1)          # wxyz -> xyzw
        gripper_closedness = 1.0 - eef[7]
        return np.concatenate([eef[:3], quat_xyzw, [gripper_closedness]])


class EDREulerSimplerAdapter(_StickyGripperMixin, SimplerAdapter):
    """Fractal proprio, euler variant: [xyz, rpy, gripper closedness]."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.reset()

    def preprocess_proprio(self, obs) -> np.ndarray:
        eef = np.asarray(obs["agent"]["eef_pos"], np.float64)
        euler = mat2euler(quat2mat(eef[3:7]))
        gripper_closedness = 1.0 - eef[7]
        return np.concatenate([eef[:3], euler, [gripper_closedness]])
