"""Aloha adaptation shims for the pi0 policy wrapper.

Behavioural mirrors of modeling_pi0.py:167-218 + the PI0Policy
adapt_to_pi_aloha paths (:411-436): Aloha exposes gripper positions in a
LINEAR space; pi0 is pretrained in ANGULAR space. These transforms convert
between them (Interbotix linear<->radian geometry + the measured Trossen
normalisation ranges), and the state/action encode/decode helpers flip
the joints Aloha runs with inverted signs.
"""

from __future__ import annotations

import numpy as np

# joints with flipped sign conventions on Aloha vs pi0's pretraining rig
# (modeling_pi0.py:412-417: left/right shoulder + elbow indices)
_FLIP_JOINTS = (1, 2, 8, 9)
_GRIPPER_IDX = (6, 13)


def _normalize(x, min_val, max_val):
    return (x - min_val) / (max_val - min_val)


def _unnormalize(x, min_val, max_val):
    return x * (max_val - min_val) + min_val


def _safe_arcsin(value):
    return np.arcsin(np.clip(value, -1.0, 1.0))


def aloha_gripper_to_angular(value):
    """Aloha linear gripper position -> pi0's normalised angular space
    (modeling_pi0.py:181-200)."""
    value = _unnormalize(value, min_val=0.01844, max_val=0.05800)

    def linear_to_radian(linear_position, arm_length, horn_radius):
        v = (horn_radius ** 2 + linear_position ** 2 - arm_length ** 2) / \
            (2 * horn_radius * linear_position)
        return _safe_arcsin(v)

    value = linear_to_radian(value, arm_length=0.036, horn_radius=0.022)
    return _normalize(value, min_val=0.4, max_val=1.5)


def aloha_gripper_from_angular(value):
    """pi0 angular gripper -> Aloha's joint-angle range
    (modeling_pi0.py:203-212)."""
    value = _unnormalize(value, min_val=0.4, max_val=1.5)
    return _normalize(value, min_val=-0.6213, max_val=1.4910)


def aloha_gripper_from_angular_inv(value):
    """Exact inverse of aloha_gripper_from_angular (:215-218)."""
    value = _unnormalize(value, min_val=-0.6213, max_val=1.4910)
    return _normalize(value, min_val=0.4, max_val=1.5)


def decode_state(state: np.ndarray) -> np.ndarray:
    """Aloha observation state -> pi0 convention (_pi_aloha_decode_state):
    flip the sign-inverted joints, map grippers linear -> angular."""
    state = np.array(state, np.float32, copy=True)
    for j in _FLIP_JOINTS:
        state[..., j] = -state[..., j]
    for j in _GRIPPER_IDX:
        state[..., j] = aloha_gripper_to_angular(state[..., j])
    return state


def encode_actions(actions: np.ndarray) -> np.ndarray:
    """pi0 action chunk -> Aloha convention (_pi_aloha_encode_actions)."""
    actions = np.array(actions, np.float32, copy=True)
    for j in _FLIP_JOINTS:
        actions[..., j] = -actions[..., j]
    for j in _GRIPPER_IDX:
        actions[..., j] = aloha_gripper_from_angular(actions[..., j])
    return actions


def encode_actions_inv(actions: np.ndarray) -> np.ndarray:
    """Aloha-space actions -> pi0 convention (training targets;
    _pi_aloha_encode_actions_inv)."""
    actions = np.array(actions, np.float32, copy=True)
    for j in _FLIP_JOINTS:
        actions[..., j] = -actions[..., j]
    for j in _GRIPPER_IDX:
        actions[..., j] = aloha_gripper_from_angular_inv(actions[..., j])
    return actions
