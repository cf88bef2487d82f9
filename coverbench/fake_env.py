"""The benchmark's traffic source: a scripted WidowX environment with the
SIMPLER observation surface, and the Bridge adapter's proprio conversion.

Frozen copies, so that the traffic cannot move with the program:
`FakeWidowXEnv` of `cover_vla_tpu_torch/eval/fake_env.py` (the in-
distribution appearance only: square blobs, no distractors),
`TASK_INSTRUCTIONS` entries of `cover_vla_tpu_torch/eval/benchmark.py`,
and `BridgeSimplerAdapter.preprocess_proprio` of
`cover_vla_tpu_torch/eval/adapters.py` with `quat2mat` / `mat2euler` of
`cover_vla_tpu_torch/utils/geometry.py`, all at commit 5a2a5d9.

Observations: a 256x256x3 uint8 frame and agent.eef_pos [xyz, quat wxyz,
gripper]. Kinematics: a point end-effector integrates the xyz deltas; the
episode succeeds when the grasped object is released within a radius of
the target.
"""

from __future__ import annotations

import numpy as np

# the in-distribution WidowX tasks of the `simpler_widowx` suite
TASK_INSTRUCTIONS = {
    "widowx_put_eggplant_in_basket": "put eggplant into yellow basket",
    "widowx_spoon_on_towel": "put the spoon on the towel",
    "widowx_stack_cube": "stack the green block on the yellow block",
    "widowx_carrot_on_plate": "put carrot on plate",
}
ID_TASKS = tuple(TASK_INSTRUCTIONS)

_APPEARANCE = {"bg": 64, "target_color": (0, 160, 0), "target_r": 14,
               "obj_color": (200, 60, 60), "obj_r": 8,
               "ee_color": (60, 60, 220), "ee_r": 5}


class FakeWidowXEnv:
    """Deterministic scripted env with the SIMPLER observation surface."""

    def __init__(self, task_name: str, max_steps: int = 60,
                 success_radius: float = 0.05):
        self.task_name = task_name
        self.instruction = TASK_INSTRUCTIONS[task_name]
        self.max_steps = max_steps
        self.success_radius = success_radius

    def reset(self, seed: int):
        rng = np.random.default_rng(seed)
        self._t = 0
        self._ee = np.array([0.05, 0.0, 0.15])
        self._obj = rng.uniform([-0.1, -0.1, 0.02], [0.1, 0.1, 0.02])
        self._target = rng.uniform([-0.15, -0.15, 0.02], [0.15, 0.15, 0.02])
        self._gripper = 0.8  # open
        self._grasped = False
        self._was_grasped = False
        return self._obs()

    def step(self, action: np.ndarray):
        """action: [dx dy dz | axis-angle(3) | gripper +-1]. Returns the
        observation and whether the episode succeeded."""
        action = np.asarray(action, np.float64)
        self._t += 1
        self._ee = self._ee + np.clip(action[:3], -0.05, 0.05)
        closing = action[6] < 0  # -1 = close (simpler convention)
        near_obj = np.linalg.norm(self._ee - self._obj) < 0.06
        if closing and near_obj:
            self._grasped = self._was_grasped = True
        if not closing:
            self._grasped = False
        if self._grasped:
            self._obj = self._ee.copy()
        self._gripper = 0.1 if closing else 0.8
        success = bool(np.linalg.norm(self._obj[:2] - self._target[:2])
                       < self.success_radius) and not self._grasped \
            and self._was_grasped
        return self._obs(), success

    def _obs(self) -> dict:
        quat = np.array([1.0, 0.0, 0.0, 0.0])  # wxyz identity
        return {"image": self._frame(),
                "eef_pos": np.concatenate(
                    [self._ee, quat, [self._gripper]]).astype(np.float32)}

    def _frame(self) -> np.ndarray:
        ap = _APPEARANCE
        img = np.full((256, 256, 3), ap["bg"], np.uint8)

        def blob(center_xy, color, r):
            cx = int(128 + center_xy[0] * 400)
            cy = int(128 + center_xy[1] * 400)
            img[max(0, cy - r):min(256, cy + r),
                max(0, cx - r):min(256, cx + r)] = color

        blob(self._target[:2], ap["target_color"], ap["target_r"])
        blob(self._obj[:2], ap["obj_color"], ap["obj_r"])
        blob(self._ee[:2], ap["ee_color"], ap["ee_r"])
        return img


# --- the Bridge adapter's proprio: [xyz, rpy of R @ DEFAULT_ROT^T, gripper]

_DEFAULT_ROT = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])


def _quat2mat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def _mat2euler(r: np.ndarray) -> np.ndarray:
    cy = np.sqrt(r[0, 0] ** 2 + r[1, 0] ** 2)
    if cy > 1e-8:
        return np.array([np.arctan2(r[2, 1], r[2, 2]),
                         np.arctan2(-r[2, 0], cy),
                         np.arctan2(r[1, 0], r[0, 0])])
    return np.array([np.arctan2(-r[1, 2], r[1, 1]),
                     np.arctan2(-r[2, 0], cy), 0.0])


def proprio(eef_pos: np.ndarray) -> np.ndarray:
    """SIMPLER eef_pos -> the policy's raw 7-d proprio (float32)."""
    rm = _quat2mat(np.asarray(eef_pos[3:7], np.float64))
    rpy = _mat2euler(rm @ _DEFAULT_ROT.T)
    return np.concatenate([eef_pos[:3], rpy, [eef_pos[7]]]).astype(np.float32)
