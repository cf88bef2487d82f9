"""Rotation conversions (sxyz Euler convention: R = Rz(yaw) Ry(pitch) Rx(roll)).

A numpy half for the host adapters and a torch half for the device step;
the Euler -> rotation-vector path goes through quaternions so it is robust
near zero rotation.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ----------------------------- numpy (host) --------------------------------


def quat2mat(q: np.ndarray) -> np.ndarray:
    """Unit quaternion [w, x, y, z] -> 3x3 rotation matrix."""
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ])


def mat2euler(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> (roll, pitch, yaw) in sxyz convention."""
    cy = np.sqrt(r[0, 0] ** 2 + r[1, 0] ** 2)
    if cy > 1e-8:
        roll = np.arctan2(r[2, 1], r[2, 2])
        pitch = np.arctan2(-r[2, 0], cy)
        yaw = np.arctan2(r[1, 0], r[0, 0])
    else:  # gimbal lock
        roll = np.arctan2(-r[1, 2], r[1, 1])
        pitch = np.arctan2(-r[2, 0], cy)
        yaw = 0.0
    return np.array([roll, pitch, yaw])


def euler2mat(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), \
        np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return rz @ ry @ rx


def euler2axangle(roll: float, pitch: float, yaw: float):
    """sxyz Euler -> (unit axis, angle). Matches transforms3d euler2axangle."""
    rv = np.asarray(euler_to_rotvec_np(np.array([roll, pitch, yaw])))
    angle = np.linalg.norm(rv)
    axis = rv / angle if angle > 1e-12 else np.array([1.0, 0.0, 0.0])
    return axis, float(angle)


def euler_to_rotvec_np(rpy: np.ndarray) -> np.ndarray:
    q = _quat_from_euler_np(rpy)
    return _quat_to_rotvec_np(q)


def _quat_from_euler_np(rpy):
    r, p, y = rpy
    qx = np.array([np.cos(r / 2), np.sin(r / 2), 0, 0])
    qy = np.array([np.cos(p / 2), 0, np.sin(p / 2), 0])
    qz = np.array([np.cos(y / 2), 0, 0, np.sin(y / 2)])
    return _qmul_np(qz, _qmul_np(qy, qx))


def _qmul_np(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ])


def _quat_to_rotvec_np(q):
    q = q / np.linalg.norm(q)
    w, v = q[0], q[1:]
    nv = np.linalg.norm(v)
    if nv < 1e-12:
        return np.zeros(3)
    angle = 2.0 * np.arctan2(nv, w)
    if angle > np.pi:
        angle -= 2 * np.pi
    return v / nv * angle


# ----------------------------- torch (device) -------------------------------


def euler_to_rotvec(rpy: torch.Tensor) -> torch.Tensor:
    """[..., 3] sxyz Euler -> [..., 3] rotation vectors (axis * angle).

    Goes through the quaternion qz(yaw) * qy(pitch) * qx(roll), which
    keeps it well-behaved at zero rotation.
    """
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r / 2), torch.sin(r / 2)
    cp, sp = torch.cos(p / 2), torch.sin(p / 2)
    cy, sy = torch.cos(y / 2), torch.sin(y / 2)
    w = cy * cp * cr + sy * sp * sr
    x = cy * cp * sr - sy * sp * cr
    yq = cy * sp * cr + sy * cp * sr
    z = sy * cp * cr - cy * sp * sr
    v = torch.stack([x, yq, z], dim=-1)
    nv = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(nv, w[..., None])
    angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
    scale = torch.where(nv > 1e-12, angle / torch.clamp(nv, min=1e-12),
                        torch.zeros_like(nv))
    return v * scale
