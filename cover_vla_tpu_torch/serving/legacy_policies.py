"""Legacy baseline policies: RT-1 (TF SavedModel) and Octo wrappers.

Counterparts of the reference's vendored baselines
(CoVer_VLA/SimplerEnv/simpler_env/policies/rt1/rt1_model.py and
policies/octo/octo_model.py, ~830 LoC): the model WEIGHTS are external
artifacts in both stacks; these wrappers reproduce the integration
behaviour — observation formatting, action-dict decoding, image history —
against any artifact on disk, and are test-covered with synthetic
stand-ins (a generated SavedModel / a fake sample_actions fn).
TensorFlow is imported only where an RT-1 SavedModel is loaded and run;
the Octo wrapper takes the model's sample function and imports nothing of
Octo's stack.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Dict, Optional, Sequence

import numpy as np


class RT1SavedModelPolicy:
    """RT-1 policy from a TF SavedModel directory (rt1_model.py:17-200).

    The SavedModel's serving callable consumes
      image uint8[B, 256, 320, 3] (RT-1's native resolution),
      natural_language_embedding fp32[B, 512]
    and emits an action dict with 'world_vector' [3], 'rotation_delta' [3],
    'gripper_closedness_action' [1], 'terminate_episode' [3]. Outputs are
    rescaled from the model's bounds to metric deltas and small actions are
    deadband-zeroed (rt1_model.py:72-146).
    """

    IMAGE_HW = (256, 320)

    def __init__(self, saved_model_path: str,
                 embed_fn: Optional[Callable[[str], np.ndarray]] = None,
                 signature: str = "serving_default",
                 action_scale: float = 1.0):
        import tensorflow as tf
        self._tf = tf
        loaded = tf.saved_model.load(saved_model_path)
        self._fn = (loaded.signatures[signature]
                    if hasattr(loaded, "signatures") and
                    signature in getattr(loaded, "signatures", {})
                    else loaded)
        # language embedding: a USE-style sentence encoder in the
        # reference; any str -> [512] fn here (hash-projection fallback)
        self._embed = embed_fn or _hash_sentence_embedding
        self.action_scale = action_scale
        self.reset("")

    def reset(self, task: str):
        self.task = task
        self._task_emb = np.asarray(self._embed(task), np.float32)

    @staticmethod
    def _rescale_with_bound(x, low, high, post_low, post_high):
        x = np.clip(x, low, high)
        return post_low + (x - low) * (post_high - post_low) / (high - low)

    def step(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        """uint8 frame -> raw action dict (reference-format keys)."""
        import tensorflow as tf
        img = tf.image.resize(image.astype(np.float32), self.IMAGE_HW)
        img = tf.cast(img, tf.uint8)
        out = self._fn(image=img[None],
                       natural_language_embedding=tf.constant(
                           self._task_emb[None]))
        action = {k: np.asarray(v)[0] for k, v in out.items()}
        # bounds: model emits [-1, 1]; world vector is metric ±0.05 m,
        # rotation ±0.25 rad (rt1_model.py:72-90)
        if "world_vector" in action:
            wv = self._rescale_with_bound(
                action["world_vector"], -1.0, 1.0, -0.05, 0.05)
            wv = np.where(np.abs(wv) < 5e-3, 0.0, wv)
            action["world_vector"] = wv * self.action_scale
        if "rotation_delta" in action:
            rd = self._rescale_with_bound(
                action["rotation_delta"], -1.0, 1.0, -0.25, 0.25)
            rd = np.where(np.abs(rd) < 5e-3, 0.0, rd)
            action["rotation_delta"] = rd * self.action_scale
        if "gripper_closedness_action" in action:
            g = action["gripper_closedness_action"]
            action["gripper_closedness_action"] = np.where(
                np.abs(g) < 1e-2, 0.0, g)
        return action

    def select_action(self, image: np.ndarray) -> np.ndarray:
        """Flat [7] simpler-format action: [dxyz, drpy, gripper ±1]."""
        a = self.step(image)
        grip = -np.sign(a.get("gripper_closedness_action",
                              np.zeros(1))).reshape(1)
        grip = np.where(grip == 0, 1.0, grip)  # no-op -> stay open
        return np.concatenate([
            a.get("world_vector", np.zeros(3)).reshape(3),
            a.get("rotation_delta", np.zeros(3)).reshape(3),
            grip]).astype(np.float32)


def _hash_sentence_embedding(text: str, dim: int = 512) -> np.ndarray:
    """Deterministic sentence embedding stand-in for the reference's
    Universal Sentence Encoder (external TF-hub artifact)."""
    import hashlib
    h = hashlib.sha256(text.strip().lower().encode()).digest()
    rng = np.random.default_rng(int.from_bytes(h[:8], "little"))
    v = rng.standard_normal(dim).astype(np.float32)
    return v / (np.linalg.norm(v) + 1e-8)


class OctoPolicyWrapper:
    """Octo-style inference wrapper (octo_model.py:23-180): a 2-frame image
    history window with a pad mask, chunked action predictions, optional
    temporal action ensembling, and an exec horizon.

    `sample_actions(images [1, H_hist, h, w, 3], pad_mask [1, H_hist],
    task, rng_seed) -> [pred_horizon, 7]` is the external Octo model's
    callable (the octo package in the reference); any conforming fn plugs
    in, keeping the integration test-covered without the dependency.
    """

    def __init__(self, sample_actions: Callable, image_size: int = 256,
                 horizon: int = 2, pred_action_horizon: int = 4,
                 exec_horizon: int = 1, action_ensemble_temp: float = 0.0):
        self.sample_actions = sample_actions
        self.image_size = image_size
        self.horizon = horizon
        self.pred_action_horizon = pred_action_horizon
        self.exec_horizon = exec_horizon
        self.action_ensemble_temp = action_ensemble_temp
        self.reset("")

    def reset(self, task: str):
        self.task = task
        self.image_history: deque = deque(maxlen=self.horizon)
        self.num_image_history = 0
        self._queue: list = []
        if self.action_ensemble_temp:
            from cover_vla_tpu_torch.eval.adapters import ActionEnsembler
            self.ensembler = ActionEnsembler(self.pred_action_horizon,
                                             self.action_ensemble_temp)
        else:
            self.ensembler = None

    def _history(self):
        self.num_image_history = min(self.num_image_history + 1,
                                     self.horizon)
        images = list(self.image_history)
        pad_len = self.horizon - len(images)
        images = [images[0]] * pad_len + images  # left-pad with oldest
        pad_mask = np.zeros(self.horizon, bool)
        pad_mask[self.horizon - self.num_image_history:] = True
        return np.stack(images)[None], pad_mask[None]

    def select_action(self, image: np.ndarray, seed: int = 0) -> np.ndarray:
        from cover_vla_tpu_torch.eval.simpler_utils import center_crop_resize
        frame = center_crop_resize(image, self.image_size)
        self.image_history.append(frame)
        if self.ensembler is not None or not self._queue:
            images, pad_mask = self._history()
            chunk = np.asarray(
                self.sample_actions(images, pad_mask, self.task, seed),
                np.float32)
            if self.ensembler is not None:
                return self.ensembler.ensemble(chunk)
            self._queue = [chunk[i] for i in range(self.exec_horizon)]
        return self._queue.pop(0)
