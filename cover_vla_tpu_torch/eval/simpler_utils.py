"""SIMPLER-side image/action helpers.

Mirrors CoVer_VLA/inference/experiments/robot/simpler/simpler_utils.py:
center-crop + resize observation prep (get_simpler_img :12-94), the
reward-image resize used for the verifier record (:97-152), the dummy
action (:161-166), and the euler->axis-angle action conversion
(convert_maniskill :169-184); plus robot_utils.py gripper helpers
(:56-83).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from cover_vla_tpu_torch.ops.image import _bilinear_matrix, _bicubic_matrix
from cover_vla_tpu_torch.utils.geometry import euler2axangle


def _resize_np(img: np.ndarray, h: int, w: int, matrix_fn) -> np.ndarray:
    x = img.astype(np.float32)
    if img.shape[0] != h:
        x = np.einsum("hs,swc->hwc", matrix_fn(img.shape[0], h), x)
    if img.shape[1] != w:
        x = np.einsum("ws,hsc->hwc", matrix_fn(img.shape[1], w), x)
    return x


def center_crop_resize(img: np.ndarray, size: int,
                       crop_scale: float = 0.9) -> np.ndarray:
    """Center-crop to crop_scale of the short side then resize to size**2
    (get_simpler_img center-crop path)."""
    h, w = img.shape[:2]
    ch, cw = int(h * crop_scale), int(w * crop_scale)
    y0, x0 = (h - ch) // 2, (w - cw) // 2
    crop = img[y0:y0 + ch, x0:x0 + cw]
    out = _resize_np(crop, size, size, _bilinear_matrix)
    return np.clip(np.round(out), 0, 255).astype(np.uint8) \
        if img.dtype == np.uint8 else out


def get_simpler_img(obs_image: np.ndarray, resize_size: int,
                    center_crop: bool = False) -> np.ndarray:
    if center_crop:
        return center_crop_resize(obs_image, resize_size)
    out = _resize_np(obs_image, resize_size, resize_size, _bilinear_matrix)
    return np.clip(np.round(out), 0, 255).astype(np.uint8) \
        if obs_image.dtype == np.uint8 else out


def resize_reward_image(img: np.ndarray, size: int = 256) -> np.ndarray:
    """Verifier-record resize (the reference also JPEG-roundtrips;
    compression is not reproduced)."""
    out = _resize_np(img, size, size, _bicubic_matrix)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def get_simpler_dummy_action(model_family: str = "openvla") -> np.ndarray:
    """No-op action during the settle-wait steps (simpler_utils.py:161-166):
    zero deltas, gripper open (+1)."""
    return np.array([0, 0, 0, 0, 0, 0, 1.0])


def convert_maniskill(action: np.ndarray) -> np.ndarray:
    """[xyz, euler rpy, gripper] -> [xyz, axis-angle, gripper]
    (simpler_utils.convert_maniskill :169-184)."""
    action = np.asarray(action, np.float64)
    axis, angle = euler2axangle(*action[3:6])
    return np.concatenate([action[:3], axis * angle, action[6:7]])


# robot_utils.py gripper helpers -------------------------------------------


def normalize_gripper_action(action: np.ndarray,
                             binarize: bool = True) -> np.ndarray:
    """[0,1] gripper -> [-1,1] (robot_utils.py:56-73); optional binarize."""
    out = action.copy()
    g = out[..., -1] * 2.0 - 1.0
    if binarize:
        g = np.sign(g)
    out[..., -1] = g
    return out


def invert_gripper_action(action: np.ndarray) -> np.ndarray:
    """Flip the gripper sign (robot_utils.py:76-83)."""
    out = action.copy()
    out[..., -1] = -out[..., -1]
    return out
