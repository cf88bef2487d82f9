"""Real SimplerEnv/ManiSkill2 integration (optional dependency).

When the `simpler_env` package (SIMPLER + ManiSkill2_real2sim + SAPIEN) is
installed, these helpers build the real benchmark environments; the
evaluator (eval/evaluator.py) drives them unchanged — it only needs
reset/step, `get_language_instruction`, and an RGB frame in the obs.

Environment names follow the reference registry
(CoVer_VLA/SimplerEnv/simpler_env/__init__.py:5-91), including the custom
OOD scenes (redbull/tennis/zucchini/dinosaur, unseen lighting, tablecloth).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from cover_vla_tpu_torch.eval.benchmark import TASK_INSTRUCTIONS

# The COMPLETE reference registry: env name -> (ManiSkill2 env id, kwargs)
# (simpler_env/__init__.py:43-91) — google-robot pick/move/drawer/place
# suites, the 4 WidowX ID tasks, and the 9 custom OOD scenes.
ENVIRONMENT_MAP: Dict[str, tuple] = {
    "google_robot_pick_coke_can": ("GraspSingleOpenedCokeCanInScene-v0", {}),
    "google_robot_pick_horizontal_coke_can": (
        "GraspSingleOpenedCokeCanInScene-v0", {"lr_switch": True}),
    "google_robot_pick_vertical_coke_can": (
        "GraspSingleOpenedCokeCanInScene-v0", {"laid_vertically": True}),
    "google_robot_pick_standing_coke_can": (
        "GraspSingleOpenedCokeCanInScene-v0", {"upright": True}),
    "google_robot_pick_object": ("GraspSingleRandomObjectInScene-v0", {}),
    "google_robot_move_near": ("MoveNearGoogleBakedTexInScene-v1", {}),
    "google_robot_move_near_v0": ("MoveNearGoogleBakedTexInScene-v0", {}),
    "google_robot_move_near_v1": ("MoveNearGoogleBakedTexInScene-v1", {}),
    "google_robot_open_drawer": ("OpenDrawerCustomInScene-v0", {}),
    "google_robot_open_top_drawer": ("OpenTopDrawerCustomInScene-v0", {}),
    "google_robot_open_middle_drawer": (
        "OpenMiddleDrawerCustomInScene-v0", {}),
    "google_robot_open_bottom_drawer": (
        "OpenBottomDrawerCustomInScene-v0", {}),
    "google_robot_close_drawer": ("CloseDrawerCustomInScene-v0", {}),
    "google_robot_close_top_drawer": ("CloseTopDrawerCustomInScene-v0", {}),
    "google_robot_close_middle_drawer": (
        "CloseMiddleDrawerCustomInScene-v0", {}),
    "google_robot_close_bottom_drawer": (
        "CloseBottomDrawerCustomInScene-v0", {}),
    "google_robot_place_in_closed_drawer": (
        "PlaceIntoClosedDrawerCustomInScene-v0", {}),
    "google_robot_place_in_closed_top_drawer": (
        "PlaceIntoClosedTopDrawerCustomInScene-v0", {}),
    "google_robot_place_in_closed_middle_drawer": (
        "PlaceIntoClosedMiddleDrawerCustomInScene-v0", {}),
    "google_robot_place_in_closed_bottom_drawer": (
        "PlaceIntoClosedBottomDrawerCustomInScene-v0", {}),
    "google_robot_place_apple_in_closed_top_drawer": (
        "PlaceIntoClosedTopDrawerCustomInScene-v0",
        {"model_ids": "baked_apple_v2"}),
    "widowx_spoon_on_towel": ("PutSpoonOnTableClothInScene-v0", {}),
    "widowx_carrot_on_plate": ("PutCarrotOnPlateInScene-v0", {}),
    "widowx_stack_cube": (
        "StackGreenCubeOnYellowCubeBakedTexInScene-v0", {}),
    "widowx_put_eggplant_in_basket": ("PutEggplantInBasketScene-v0", {}),
    # custom OOD scenes
    "widowx_carrot_on_plate_unseen_lighting": (
        "PutCarrotOnPlateUnseenLighting", {}),
    "widowx_spoon_on_towel_new_table_cloth": (
        "PutSpoonOnTableClothInSceneNewTableCloth", {}),
    "widowx_spoon_on_towel_google": ("PutSpoonOnTableClothInSceneGoogle", {}),
    "widowx_redbull_on_plate": ("PutRedbullOnPlateInScene", {}),
    "widowx_tennis_ball_in_basket": ("PutTennisBallInBasketScene", {}),
    "widowx_zucchini_on_towel": ("PutZucchiniOnTableClothInScene", {}),
    "widowx_tape_measure_in_basket": ("PutTapeMeasureInBasketScene-v0", {}),
    "widowx_toy_dinosaur_on_towel": ("PutToyDinosaurOnTowelInScene", {}),
    "widowx_stapler_on_paper": ("PutStaplerOnPaperInScene", {}),
}

ENVIRONMENTS = list(ENVIRONMENT_MAP)

# name -> env id only (backward-compatible view)
SIMPLER_ENV_IDS: Dict[str, str] = {k: v[0] for k, v in ENVIRONMENT_MAP.items()}


def simpler_available() -> bool:
    try:
        import simpler_env  # noqa: F401
        return True
    except Exception:
        return False


class SimplerEnvWrapper:
    """Adapts a real simpler_env gym env to the evaluator's surface."""

    def __init__(self, env, task_name: str):
        self.env = env
        self.task_name = task_name
        self.episode_stats: Dict = {}

    def reset(self, seed: Optional[int] = None):
        obs, info = self.env.reset(seed=seed)
        return self._convert_obs(obs), info

    def step(self, action: np.ndarray):
        obs, reward, done, trunc, info = self.env.step(np.asarray(action))
        self.episode_stats = info.get("episode_stats", {})
        return self._convert_obs(obs), reward, bool(done), bool(trunc), info

    def render(self):
        return self.env.render()

    def get_language_instruction(self) -> str:
        if hasattr(self.env, "get_language_instruction"):
            return self.env.get_language_instruction()
        return TASK_INSTRUCTIONS.get(self.task_name,
                                     self.task_name.replace("_", " "))

    def _convert_obs(self, obs: Dict) -> Dict:
        out = dict(obs)
        # WidowX: the 3rd-view camera RGB (the selector the vendored
        # snapshot is missing — SURVEY.md §2.6)
        cams = obs.get("image", obs.get("image_dict", {}))
        if isinstance(cams, dict):
            for name in ("3rd_view_camera", "overhead_camera", "base_camera"):
                if name in cams:
                    cam = cams[name]
                    out["image"] = np.asarray(
                        cam["rgb"] if isinstance(cam, dict) else cam)
                    break
        return out


def make_simpler_env(task_name: str, **kwargs):
    """Build the REAL simpler env when installed, else the fake env.

    Mirrors simpler_env.make (simpler_env/__init__.py:94-108): the env id
    and default kwargs come from ENVIRONMENT_MAP; explicit kwargs win."""
    if simpler_available():
        import simpler_env
        env = simpler_env.make(task_name, **kwargs)
        return SimplerEnvWrapper(env, task_name)
    try:
        # SIMPLER absent but ManiSkill2_real2sim importable: gym.make direct
        import gymnasium as gym
        import mani_skill2_real2sim.envs  # noqa: F401
        env_id, default_kw = ENVIRONMENT_MAP[task_name]
        env = gym.make(env_id, obs_mode="rgbd",
                       **{**default_kw, **kwargs})
        return SimplerEnvWrapper(env, task_name)
    except ImportError:
        pass
    from cover_vla_tpu_torch.eval.fake_env import make_fake_env
    return make_fake_env(task_name, **kwargs)
