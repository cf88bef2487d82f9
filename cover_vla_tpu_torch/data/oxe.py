"""Open-X-Embodiment dataset registry: configs, standardization, mixes.

Counterpart of INT-ACT/src/data/oxe/ (oxe_dataset_configs.py — 64 dataset
key layouts; oxe_standardization_transforms.py; oxe_dataset_mixes.py).
Each dataset declares its camera keys and proprio/action encodings; a
GENERIC encoding-driven standardizer maps raw trajectories into the
canonical layout consumed by cover_vla_tpu_torch.data.pipeline (images
[T,H,W,3] uint8, states [T,7] euler proprio, actions [T,7] = [dxyz, drpy,
gripper 0/1], task str), replacing the reference's 1,130 LoC of
per-dataset TF transforms with one table-driven path (datasets needing
bespoke math — bridge's top-down frame, fractal's xyzw/closedness — carry
an explicit `standardize` override).

The registry also derives `rlds.RldsSpec` objects so any OXE dataset's
TFRecord shards stream straight through data/rlds.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cover_vla_tpu_torch.utils.geometry import quat2mat, mat2euler

Trajectory = Dict[str, np.ndarray]


class ProprioEncoding(enum.IntEnum):
    """Proprio layout of the raw dataset (oxe_dataset_configs.py:18-28)."""
    NONE = -1            # no proprio provided
    POS_EULER = 1        # xyz + rpy + gripper
    POS_QUAT = 2         # xyz + quaternion + gripper
    JOINT = 3            # joint angles + gripper
    JOINT_BIMANUAL = 4   # 2x [6 joints + gripper]
    POS_NAV = 5          # xy + yaw


class ActionEncoding(enum.IntEnum):
    """Action layout (oxe_dataset_configs.py:31-40)."""
    EEF_POS = 1              # delta xyz + rpy + gripper
    JOINT_POS = 2            # 7 joint deltas + gripper
    JOINT_POS_BIMANUAL = 3
    NAV_2D = 4
    JOINT_POS_BIMANUAL_NAV = 5


@dataclass(frozen=True)
class OXEDatasetConfig:
    name: str
    image_key: str = "image"               # primary external RGB
    wrist_key: Optional[str] = None        # wrist RGB (if any)
    proprio: ProprioEncoding = ProprioEncoding.POS_EULER
    action: ActionEncoding = ActionEncoding.EEF_POS
    image_size: Tuple[int, int] = (256, 256)
    gripper_convention: str = "openness"   # "openness" (1=open)|"closedness"
    state_key: str = "state"
    action_key: str = "actions"
    language_key: str = "task"
    standardize: Optional[Callable[[Trajectory], Trajectory]] = None


# ---------------------------------------------------------------------------
# Standardization
# ---------------------------------------------------------------------------


def standardize_bridge(traj: Trajectory) -> Trajectory:
    """Bridge/WidowX: proprio [xyz, quat wxyz, gripper openness] -> euler in
    the top-down frame (BridgeSimplerAdapter.preprocess_proprio)."""
    default_rot = np.array([[0, 0, 1.0], [0, 1.0, 0], [-1.0, 0, 0]])
    states = np.asarray(traj["states"], np.float64)
    if states.shape[1] == 8:  # xyz + quat + gripper
        out = np.zeros((len(states), 7))
        for i, s in enumerate(states):
            rpy = mat2euler(quat2mat(s[3:7]) @ default_rot.T)
            out[i] = np.concatenate([s[:3], rpy, s[7:8]])
        states = out
    return {**traj, "states": states.astype(np.float32)}


def standardize_fractal(traj: Trajectory) -> Trajectory:
    """Fractal/EDR: xyzw quats + gripper closedness -> euler + openness."""
    states = np.asarray(traj["states"], np.float64)
    if states.shape[1] == 8:
        out = np.zeros((len(states), 7))
        for i, s in enumerate(states):
            quat_wxyz = np.roll(s[3:7], 1)
            rpy = mat2euler(quat2mat(quat_wxyz))
            out[i] = np.concatenate([s[:3], rpy, [1.0 - s[7]]])
        states = out
    return {**traj, "states": states.astype(np.float32)}


def standardize_generic(traj: Trajectory, cfg: OXEDatasetConfig
                        ) -> Trajectory:
    """Encoding-table-driven standardization: POS_QUAT proprio -> euler,
    JOINT/NONE -> zero-padded 7-dim placeholder, closedness grippers
    inverted. EEF_POS actions pass through; non-EEF encodings are kept
    as-is for model families that consume them (documented: π0 trains on
    EEF_POS datasets)."""
    states = np.asarray(traj.get("states", np.zeros((0, 7))), np.float64)
    t = len(traj["images"]) if "images" in traj else len(states)

    if cfg.proprio == ProprioEncoding.POS_QUAT and states.shape[-1] >= 8:
        out = np.zeros((len(states), 7))
        for i, s in enumerate(states):
            out[i] = np.concatenate(
                [s[:3], mat2euler(quat2mat(s[3:7])), s[7:8]])
        states = out
    elif cfg.proprio == ProprioEncoding.POS_EULER and states.shape[-1] >= 7:
        states = states[:, :7]
    elif cfg.proprio in (ProprioEncoding.NONE,) or states.size == 0:
        states = np.zeros((t, 7))
    else:  # JOINT / NAV / BIMANUAL: keep magnitude, pad/trim to 7
        pad = np.zeros((len(states), 7))
        k = min(7, states.shape[-1])
        pad[:, :k] = states[:, :k]
        states = pad

    out_traj = {**traj}
    if cfg.gripper_convention == "closedness":
        # invert only where index 6 IS a gripper: POS_* proprio layouts
        # (JOINT/NAV place a joint there) and EEF_POS actions — matching
        # the reference's per-dataset standardization transforms, which
        # flip BOTH proprio and action closedness grippers
        if cfg.proprio in (ProprioEncoding.POS_EULER,
                           ProprioEncoding.POS_QUAT) \
                and states.shape[-1] == 7:
            states = states.copy()
            states[:, 6] = 1.0 - states[:, 6]
        if cfg.action == ActionEncoding.EEF_POS and "actions" in traj:
            actions = np.asarray(traj["actions"], np.float64)
            if actions.ndim >= 2 and actions.shape[-1] == 7:
                actions = actions.copy()
                actions[..., 6] = 1.0 - actions[..., 6]
                out_traj["actions"] = actions.astype(np.float32)
    out_traj["states"] = states.astype(np.float32)
    return out_traj


def standardize(name: str, traj: Trajectory) -> Trajectory:
    cfg = OXE_DATASET_CONFIGS[name]
    if cfg.standardize is not None:
        return cfg.standardize(traj)
    return standardize_generic(traj, cfg)


# ---------------------------------------------------------------------------
# The registry (64 datasets; key layouts from oxe_dataset_configs.py)
# ---------------------------------------------------------------------------

_PE, _AE = ProprioEncoding, ActionEncoding

# (name, primary image key, wrist key, proprio encoding, action encoding)
_REGISTRY_ROWS = [
    ("fractal20220817_data", "image", None, _PE.POS_QUAT, _AE.EEF_POS),
    ("fractal_euler", "image", None, _PE.POS_EULER, _AE.EEF_POS),
    ("taco_play_libero", "rgb_static", "rgb_gripper", _PE.POS_EULER,
     _AE.EEF_POS),
    ("libero_spatial", "image", "wrist_image", _PE.POS_EULER, _AE.EEF_POS),
    ("libero_object", "image", "wrist_image", _PE.POS_EULER, _AE.EEF_POS),
    ("libero_goal", "image", "wrist_image", _PE.POS_EULER, _AE.EEF_POS),
    ("libero_10", "image", "wrist_image", _PE.POS_EULER, _AE.EEF_POS),
    ("libero_90", "image", "wrist_image", _PE.POS_EULER, _AE.EEF_POS),
    ("kuka", "image", None, _PE.POS_QUAT, _AE.EEF_POS),
    ("bridge_dataset", "image_0", None, _PE.POS_EULER, _AE.EEF_POS),
    ("taco_play", "rgb_static", "rgb_gripper", _PE.POS_EULER, _AE.EEF_POS),
    ("jaco_play", "image", "image_wrist", _PE.POS_EULER, _AE.EEF_POS),
    ("berkeley_cable_routing", "image", "wrist45_image", _PE.JOINT,
     _AE.EEF_POS),
    ("roboturk", "front_rgb", None, _PE.NONE, _AE.EEF_POS),
    ("nyu_door_opening_surprising_effectiveness", None, "image", _PE.NONE,
     _AE.EEF_POS),
    ("viola", "agentview_rgb", "eye_in_hand_rgb", _PE.JOINT, _AE.EEF_POS),
    ("berkeley_autolab_ur5", "image", "hand_image", _PE.POS_QUAT,
     _AE.EEF_POS),
    ("toto", "image", None, _PE.JOINT, _AE.EEF_POS),
    ("language_table", "rgb", None, _PE.POS_EULER, _AE.EEF_POS),
    ("columbia_cairlab_pusht_real", "image", "wrist_image", _PE.POS_EULER,
     _AE.EEF_POS),
    ("stanford_kuka_multimodal_dataset_converted_externally_to_rlds",
     "image", None, _PE.POS_QUAT, _AE.EEF_POS),
    ("nyu_rot_dataset_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("stanford_hydra_dataset_converted_externally_to_rlds", "image",
     "wrist_image", _PE.POS_EULER, _AE.EEF_POS),
    ("austin_buds_dataset_converted_externally_to_rlds", "image",
     "wrist_image", _PE.JOINT, _AE.EEF_POS),
    ("nyu_franka_play_dataset_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("maniskill_dataset_converted_externally_to_rlds", "image",
     "wrist_image", _PE.POS_QUAT, _AE.EEF_POS),
    ("furniture_bench_dataset_converted_externally_to_rlds", "image",
     "wrist_image", _PE.POS_QUAT, _AE.EEF_POS),
    ("cmu_franka_exploration_dataset_converted_externally_to_rlds",
     "highres_image", None, _PE.NONE, _AE.EEF_POS),
    ("ucsd_kitchen_dataset_converted_externally_to_rlds", "image", None,
     _PE.JOINT, _AE.EEF_POS),
    ("ucsd_pick_and_place_dataset_converted_externally_to_rlds", "image",
     None, _PE.POS_EULER, _AE.EEF_POS),
    ("austin_sailor_dataset_converted_externally_to_rlds", "image",
     "wrist_image", _PE.POS_QUAT, _AE.EEF_POS),
    ("austin_sirius_dataset_converted_externally_to_rlds", "image",
     "wrist_image", _PE.POS_QUAT, _AE.EEF_POS),
    ("bc_z", "image", None, _PE.POS_EULER, _AE.EEF_POS),
    ("utokyo_pr2_opening_fridge_converted_externally_to_rlds", "image",
     None, _PE.POS_EULER, _AE.EEF_POS),
    ("utokyo_pr2_tabletop_manipulation_converted_externally_to_rlds",
     "image", None, _PE.POS_EULER, _AE.EEF_POS),
    ("utokyo_xarm_pick_and_place_converted_externally_to_rlds", "image",
     "hand_image", _PE.POS_EULER, _AE.EEF_POS),
    ("utokyo_xarm_bimanual_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("robo_net", "image", None, _PE.POS_EULER, _AE.EEF_POS),
    ("berkeley_mvp_converted_externally_to_rlds", None, "hand_image",
     _PE.POS_QUAT, _AE.JOINT_POS),
    ("berkeley_rpt_converted_externally_to_rlds", None, "hand_image",
     _PE.JOINT, _AE.JOINT_POS),
    ("kaist_nonprehensile_converted_externally_to_rlds", "image", None,
     _PE.POS_QUAT, _AE.EEF_POS),
    ("stanford_mask_vit_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("tokyo_u_lsmo_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("dlr_sara_pour_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("dlr_sara_grid_clamp_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("dlr_edan_shared_control_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("asu_table_top_converted_externally_to_rlds", "image", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("stanford_robocook_converted_externally_to_rlds", "image_1", None,
     _PE.POS_EULER, _AE.EEF_POS),
    ("imperialcollege_sawyer_wrist_cam", "image", "wrist_image", _PE.NONE,
     _AE.EEF_POS),
    ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", "image",
     "wrist_image", _PE.JOINT, _AE.EEF_POS),
    ("uiuc_d3field", "image_1", None, _PE.NONE, _AE.EEF_POS),
    ("utaustin_mutex", "image", "wrist_image", _PE.JOINT, _AE.EEF_POS),
    ("berkeley_fanuc_manipulation", "image", "wrist_image", _PE.JOINT,
     _AE.EEF_POS),
    ("cmu_playing_with_food", "image", "finger_vision_1", _PE.POS_EULER,
     _AE.EEF_POS),
    ("cmu_play_fusion", "image", None, _PE.JOINT, _AE.EEF_POS),
    ("cmu_stretch", "image", None, _PE.POS_EULER, _AE.EEF_POS),
    ("gnm_dataset", "image", None, _PE.POS_NAV, _AE.NAV_2D),
    ("aloha_static_dataset", "cam_high", "cam_right_wrist",
     _PE.JOINT_BIMANUAL, _AE.JOINT_POS_BIMANUAL),
    ("aloha_dagger_dataset", "cam_high", "cam_right_wrist",
     _PE.JOINT_BIMANUAL, _AE.JOINT_POS_BIMANUAL),
    ("aloha_mobile_dataset", "cam_high", "cam_right_wrist",
     _PE.JOINT_BIMANUAL, _AE.JOINT_POS_BIMANUAL_NAV),
    ("fmb_dataset", "image_side_1", "image_wrist_1", _PE.POS_EULER,
     _AE.EEF_POS),
    ("dobbe", None, "wrist_image", _PE.POS_EULER, _AE.EEF_POS),
    ("roboset", "image_left", "image_wrist", _PE.JOINT, _AE.JOINT_POS),
    ("rh20t", "image_front", "image_wrist", _PE.POS_EULER, _AE.EEF_POS),
    ("mujoco_manip", "image", None, _PE.POS_EULER, _AE.EEF_POS),
]

_OVERRIDES: Dict[str, Dict] = {
    "bridge_dataset": {"standardize": standardize_bridge},
    "fractal20220817_data": {"gripper_convention": "closedness",
                             "standardize": standardize_fractal},
}

OXE_DATASET_CONFIGS: Dict[str, OXEDatasetConfig] = {
    name: OXEDatasetConfig(name=name, image_key=img or "image",
                           wrist_key=wrist, proprio=pe, action=ae,
                           **_OVERRIDES.get(name, {}))
    for name, img, wrist, pe, ae in _REGISTRY_ROWS
}


def rlds_spec_for(name: str):
    """Build the data.rlds.RldsSpec for one OXE dataset's TFDS shards."""
    from cover_vla_tpu_torch.data.rlds import RldsSpec
    cfg = OXE_DATASET_CONFIGS[name]
    return RldsSpec(
        image_key=f"steps/observation/{cfg.image_key}",
        state_key=f"steps/observation/{cfg.state_key}",
        action_key="steps/action",
        instruction_key="steps/language_instruction")


# ---------------------------------------------------------------------------
# Named mixture weights (oxe_dataset_mixes.py)
# ---------------------------------------------------------------------------

OXE_NAMED_MIXES: Dict[str, List[Tuple[str, float]]] = {
    "bridge": [("bridge_dataset", 1.0)],
    "fractal": [("fractal20220817_data", 1.0)],
    "fractal_euler": [("fractal_euler", 1.0)],
    "bridge_fractal": [("bridge_dataset", 0.5),
                       ("fractal20220817_data", 0.5)],
    "oxe_simple": [("fractal_euler", 1.0), ("bridge_dataset", 1.0)],
    "taco": [("taco_play", 1.0)],
    "libero": [("libero_10", 1.0), ("libero_90", 1.0),
               ("libero_goal", 1.0), ("libero_object", 1.0),
               ("libero_spatial", 1.0)],
    "rt_x": [
        ("fractal20220817_data", 0.54087122203), ("kuka", 0.8341046294),
        ("bridge_dataset", 1.0), ("taco_play", 2.0), ("jaco_play", 2.0),
        ("berkeley_cable_routing", 3.0), ("roboturk", 1.0),
        ("nyu_door_opening_surprising_effectiveness", 5.0), ("viola", 2.0),
        ("berkeley_autolab_ur5", 1.0), ("toto", 1.0),
    ],
    "oxe_magic_soup": [
        ("fractal20220817_data", 0.54087122203), ("kuka", 0.8341046294),
        ("bridge_dataset", 1.0), ("taco_play", 2.0), ("jaco_play", 1.0),
        ("berkeley_cable_routing", 1.0), ("roboturk", 2.0),
        ("nyu_door_opening_surprising_effectiveness", 1.0), ("viola", 2.0),
        ("berkeley_autolab_ur5", 2.0), ("toto", 1.0),
        ("language_table", 0.1),
        ("stanford_hydra_dataset_converted_externally_to_rlds", 2.0),
        ("austin_buds_dataset_converted_externally_to_rlds", 1.0),
        ("nyu_franka_play_dataset_converted_externally_to_rlds", 3.0),
        ("furniture_bench_dataset_converted_externally_to_rlds", 0.1),
        ("ucsd_kitchen_dataset_converted_externally_to_rlds", 2.0),
        ("austin_sailor_dataset_converted_externally_to_rlds", 1.0),
        ("austin_sirius_dataset_converted_externally_to_rlds", 1.0),
        ("bc_z", 0.2),
        ("dlr_edan_shared_control_converted_externally_to_rlds", 1.0),
        ("iamlab_cmu_pickup_insert_converted_externally_to_rlds", 1.0),
        ("utaustin_mutex", 1.0), ("berkeley_fanuc_manipulation", 2.0),
        ("cmu_stretch", 1.0),
    ],
}


def make_mix(mix_name: str, trajectories_by_dataset: Dict[str, Sequence],
             chunk_size: int = 4, paraphrase=None):
    """Named mix -> (FrameDataset list, weights) for pipeline.interleave,
    applying each dataset's standardization."""
    from cover_vla_tpu_torch.data.pipeline import FrameDataset
    datasets, weights = [], []
    for name, w in OXE_NAMED_MIXES[mix_name]:
        trajs = [standardize(name, t)
                 for t in trajectories_by_dataset.get(name, [])]
        if not trajs:
            continue
        datasets.append(FrameDataset(trajs, chunk_size=chunk_size,
                                     paraphrase=paraphrase))
        weights.append(w)
    return datasets, weights


def make_streaming_mix(mix_name: str, shard_dirs: Dict[str, str],
                       chunk_size: int = 4, paraphrase=None):
    """Named mix over on-disk RLDS shard directories -> streaming datasets
    (the full TorchRLDSInterleavedDataset path: shards -> decode ->
    standardize -> chunk -> interleave)."""
    from cover_vla_tpu_torch.data.pipeline import StreamingFrameDataset
    from cover_vla_tpu_torch.data.rlds import RldsShardDataset

    class _Standardized:
        def __init__(self, name, path):
            self.name = name
            self.src = RldsShardDataset(path, spec=rlds_spec_for(name))

        def __iter__(self):
            for traj in self.src:
                yield standardize(self.name, traj)

    datasets, weights = [], []
    for name, w in OXE_NAMED_MIXES[mix_name]:
        if name not in shard_dirs:
            continue
        datasets.append(StreamingFrameDataset(
            _Standardized(name, shard_dirs[name]), chunk_size=chunk_size,
            paraphrase=paraphrase))
        weights.append(w)
    return datasets, weights
