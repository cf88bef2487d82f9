"""Scripted fake environment for CI / benchmarking without SAPIEN.

Implements the gym-style surface the evaluator consumes
(reset/step/render + get_language_instruction + episode_stats), with
deterministic kinematics: a point end-effector integrates the xyz deltas;
success when the (virtual) grasped object is brought within a tolerance of
the target while the gripper has closed at least once — a cartoon of
PutOnInSceneEnv.evaluate's containment check
(ManiSkill2 custom_scenes/put_on_in_scene.py:23-141). Observations follow
the SIMPLER WidowX layout: 256x256x3 uint8 frame + agent.eef_pos
[xyz, quat wxyz, gripper].
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS


# Appearance variants keyed by task name — the cartoon of the reference's
# custom OOD scenes (SURVEY §2.6: unseen objects redbull/zucchini/tennis,
# unseen lighting; ManiSkill2 custom_scenes/put_on_in_scene.py:455-620).
# Kinematics/success logic are IDENTICAL across variants; the rendered
# appearance shifts along THREE axes: color/size, object GEOMETRY (shape:
# square/circle/ellipse/triangle/ring — the cartoon of the reference's
# novel object meshes), and scene clutter (a distractor blob at a random
# position, never the pick target — the reference's cluttered OOD scenes).
# ID tasks are absent from this table and keep the exact default rendering
# (trained artifacts depend on those frame bytes): default shapes are
# "square" with no distractors, which reproduces the pre-round-5 frames
# byte-for-byte (tests/test_fake_env.py::test_id_frames_byte_stable).
_DEFAULT_APPEARANCE = {
    "bg": 64,
    "target_color": (0, 160, 0), "target_r": 14, "target_shape": "square",
    "obj_color": (200, 60, 60), "obj_r": 8, "obj_shape": "square",
    "ee_color": (60, 60, 220), "ee_r": 5,
    "distractors": (),   # ({"color","r","shape"}, ...) placed at reset
}
TASK_APPEARANCES = {
    # unseen object: gray-silver can (tall narrow ellipse), smaller than
    # the carrot; a dark round distractor (a mug) clutters the scene
    "widowx_redbull_on_plate": {
        "obj_color": (185, 185, 195), "obj_r": 6, "obj_shape": "ellipse_v",
        "distractors": ({"color": (95, 95, 95), "r": 7,
                         "shape": "circle"},)},
    # unseen object: dark-green zucchini (long horizontal ellipse), larger;
    # unseen purple towel; a yellow sponge distractor
    "widowx_zucchini_on_towel": {
        "obj_color": (80, 135, 45), "obj_r": 11, "obj_shape": "ellipse_h",
        "target_color": (150, 110, 190), "target_r": 16,
        "distractors": ({"color": (205, 195, 90), "r": 6,
                         "shape": "square"},)},
    # unseen object: yellow ball (circle); unseen brown basket rendered as
    # a RING (annulus — novel receptacle geometry); a pale triangular
    # distractor (a sock)
    "widowx_tennis_ball_in_basket": {
        "obj_color": (190, 205, 70), "obj_r": 6, "obj_shape": "circle",
        "target_color": (120, 80, 40), "target_r": 16,
        "target_shape": "ring",
        "distractors": ({"color": (210, 210, 205), "r": 5,
                         "shape": "triangle"},)},
    # same objects, brighter scene
    "widowx_carrot_on_plate_unseen_lighting": {"bg": 112},
}

# appearance-only tier of the OOD suite (the round-4 definition): unseen
# object/receptacle COLORS and SIZES with in-distribution geometry and no
# clutter. The base task names above add the round-5 hard axes on top
# (novel shapes — ellipses/ring — and distractor blobs); keeping both
# tiers separates "unseen appearance" transfer from the identity-
# grounding problem clutter introduces.
for _t in ("widowx_redbull_on_plate", "widowx_zucchini_on_towel",
           "widowx_tennis_ball_in_basket"):
    TASK_APPEARANCES[_t + "_appearance"] = {
        k: v for k, v in TASK_APPEARANCES[_t].items()
        if k in ("obj_color", "obj_r", "target_color", "target_r", "bg")}


class FakeWidowXEnv:
    """Deterministic scripted env with the SIMPLER observation surface."""

    def __init__(self, task_name: str, max_steps: int = 60,
                 success_radius: float = 0.05,
                 appearance: Optional[Dict] = None):
        self.task_name = task_name
        self.instruction = TASK_INSTRUCTIONS.get(
            task_name, task_name.replace("_", " "))
        self.max_steps = max_steps
        self.success_radius = success_radius
        self.appearance = dict(_DEFAULT_APPEARANCE)
        self.appearance.update(TASK_APPEARANCES.get(task_name, {}))
        self.appearance.update(appearance or {})
        self._rng = np.random.default_rng(0)

    # gym surface -----------------------------------------------------------

    def reset(self, seed: Optional[int] = None):
        self._rng = np.random.default_rng(seed if seed is not None else 0)
        self._t = 0
        self._ee = np.array([0.05, 0.0, 0.15])
        self._obj = self._rng.uniform([-0.1, -0.1, 0.02], [0.1, 0.1, 0.02])
        self._target = self._rng.uniform([-0.15, -0.15, 0.02],
                                         [0.15, 0.15, 0.02])
        # distractor clutter: random positions kept clear of the object and
        # target so the task stays solvable; draws happen only when the
        # appearance carries distractors, so ID streams consume the same
        # rng sequence as before (frame-byte and layout stability)
        self._distractors = []
        for d in self.appearance["distractors"]:
            for _ in range(8):   # rejection-sample a clear spot
                pos = self._rng.uniform([-0.14, -0.14], [0.14, 0.14])
                if (np.linalg.norm(pos - self._obj[:2]) > 0.07
                        and np.linalg.norm(pos - self._target[:2]) > 0.08):
                    break
            self._distractors.append((pos, d))
        self._gripper = 0.8  # open
        self._grasped = False
        self.episode_stats = {
            "moved_correct_obj": False,
            "is_src_obj_grasped": False,
            "consecutive_grasp": False,
            "success": False,
        }
        return self._obs(), {}

    def step(self, action: np.ndarray):
        """action: [dx dy dz | axis-angle(3) | gripper ±1]."""
        action = np.asarray(action, np.float64)
        self._t += 1
        self._ee = self._ee + np.clip(action[:3], -0.05, 0.05)
        closing = action[6] < 0  # -1 = close (simpler convention)
        near_obj = np.linalg.norm(self._ee - self._obj) < 0.06
        if closing and near_obj:
            self._grasped = True
            self.episode_stats["is_src_obj_grasped"] = True
            self.episode_stats["consecutive_grasp"] = True
        if not closing:
            self._grasped = False
        if self._grasped:
            self._obj = self._ee.copy()
            self.episode_stats["moved_correct_obj"] = True
        self._gripper = 0.1 if closing else 0.8

        on_target = (np.linalg.norm(self._obj[:2] - self._target[:2])
                     < self.success_radius) and not self._grasped \
            and self.episode_stats["is_src_obj_grasped"]
        self.episode_stats["success"] = bool(on_target)
        done = bool(on_target)
        trunc = self._t >= self.max_steps
        reward = 1.0 if done else 0.0
        return self._obs(), reward, done, trunc, {
            "episode_stats": dict(self.episode_stats)}

    def render(self) -> np.ndarray:
        return self._frame()

    # SIMPLER-compatible helpers -------------------------------------------

    def get_language_instruction(self) -> str:
        return self.instruction

    def _obs(self) -> Dict:
        quat = np.array([1.0, 0.0, 0.0, 0.0])  # wxyz identity
        return {
            "image": self._frame(),
            "agent": {"eef_pos": np.concatenate(
                [self._ee, quat, [self._gripper]]).astype(np.float32)},
        }

    def _frame(self) -> np.ndarray:
        """A deterministic 256x256 rendering: background + distractors +
        target + object + ee. The default "square" shape reproduces the
        pre-round-5 axis-aligned fill byte-for-byte; the other shapes are
        the geometry OOD axis (novel object meshes in the reference)."""
        ap = self.appearance
        img = np.full((256, 256, 3), ap["bg"], np.uint8)

        def blob(center_xy, color, r=10, shape="square"):
            cx = int(128 + center_xy[0] * 400)
            cy = int(128 + center_xy[1] * 400)
            if shape == "square":
                y0, y1 = max(0, cy - r), min(256, cy + r)
                x0, x1 = max(0, cx - r), min(256, cx + r)
                img[y0:y1, x0:x1] = color
                return
            rx, ry = {
                "circle": (r, r),
                "ring": (r, r),
                "ellipse_v": (max(2, int(r * 0.55)), int(r * 1.5)),
                "ellipse_h": (int(r * 1.5), max(2, int(r * 0.55))),
                "triangle": (r, r),
            }[shape]
            # bounding-box mask (a full-frame grid per blob is ~100x the
            # pixels and dominates synthetic-frame generation time)
            rr = max(rx, ry)
            y0, y1 = max(0, cy - rr), min(256, cy + rr + 1)
            x0, x1 = max(0, cx - rr), min(256, cx + rr + 1)
            if y0 >= y1 or x0 >= x1:
                return
            yy, xx = np.mgrid[y0:y1, x0:x1]
            dx, dy = xx - cx, yy - cy
            if shape == "triangle":       # upright isoceles triangle
                mask = (dy >= -r) & (dy <= r) & \
                       (np.abs(dx) <= (dy + r) * 0.6)
            else:
                rho = (dx / rx) ** 2 + (dy / ry) ** 2
                mask = rho <= 1.0
                if shape == "ring":       # annulus: hollow receptacle
                    mask &= rho >= 0.45
            img[y0:y1, x0:x1][mask] = color

        for pos, d in getattr(self, "_distractors", []):
            blob(pos, d["color"], r=d["r"], shape=d.get("shape", "square"))
        blob(self._target[:2], ap["target_color"], r=ap["target_r"],
             shape=ap["target_shape"])
        blob(self._obj[:2], ap["obj_color"], r=ap["obj_r"],
             shape=ap["obj_shape"])
        blob(self._ee[:2], ap["ee_color"], r=ap["ee_r"])
        return img


def make_fake_env(task_name: str, **kwargs) -> FakeWidowXEnv:
    return FakeWidowXEnv(task_name, **kwargs)


def get_image_from_obs_dict(env, obs: Dict) -> np.ndarray:
    """Obs -> RGB frame selector; stands in for the upstream
    get_image_from_maniskill2_obs_dict (missing from the vendored snapshot,
    SURVEY.md §2.6) which picks the robot's RGB camera (3rd_view_camera
    for WidowX)."""
    if "image" in obs:
        return obs["image"]
    cams = obs.get("image_dict") or obs.get("sensor_data") or {}
    for name in ("3rd_view_camera", "overhead_camera", "base_camera"):
        if name in cams:
            cam = cams[name]
            return cam["rgb"] if isinstance(cam, dict) else cam
    raise KeyError(f"no camera frame in obs keys {list(obs.keys())}")
