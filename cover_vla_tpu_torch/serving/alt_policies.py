"""Alternative policy-family wrappers.

The reference ships server-side wrappers for SpatialVLA, Magma (token-bin
decode), and Octo alongside the lerobot one
(INT-ACT/src/experiments/policies/policy_wrapper.py:187-371), each a thin
preprocess->model->postprocess shell over a HF/JAX model. The MODELS are
external checkpoints, not part of this framework, but the decode/postprocess
math between "model output" and "simpler execution action" is concrete and
self-contained — it is implemented here:

  * Magma token-bin detokenisation (policy_wrapper.py:236-268): the last 7
    generated token ids map to 256-bin centers over [-1, 1], then
    bound-denormalise against dataset statistics with the stats mask and
    convert euler->axis-angle with a binarised gripper
    (env_adapters/simpler.py:309-340 BridgeSimplerMagmaAdapter).
  * SpatialVLA postprocess (simpler.py:229-307): the model emits already
    UNNORMALISED action chunks (its processor applies norm_key stats);
    the adapter temporally ensembles chunks then converts euler->axangle
    with a non-binarised gripper — no denormalisation.

plus a working `ScriptedPolicyWrapper` used for serving tests and fake-env
demos, and the generic `HFModelPolicyWrapper` plug-in shell.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np

from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter, ActionEnsembler
from cover_vla_tpu_torch.utils.geometry import euler2axangle


# ---------------------------------------------------------------------------
# Magma token-bin decode (policy_wrapper.py:236-268)
# ---------------------------------------------------------------------------


def magma_bin_centers(n_action_bins: int = 256) -> np.ndarray:
    """Centers of the uniform action bins over [-1, 1] (255 centers for
    256 bin edges — policy_wrapper.py:236-238)."""
    bins = np.linspace(-1.0, 1.0, n_action_bins)
    return (bins[:-1] + bins[1:]) / 2.0


def magma_decode_tokens(output_ids: np.ndarray, vocab_size: int,
                        n_action_bins: int = 256,
                        action_dim: int = 7) -> np.ndarray:
    """Generated token ids -> normalised [-1, 1] action vector.

    Mirrors MagmaPolicyWrapper.select_action (policy_wrapper.py:252-268):
    the action tokens are the LAST `action_dim + 1` ids minus the trailing
    EOS (ids[-8:-1] for 7 dims); each id was emitted as
    `vocab_size - bin_index`, so decode inverts that and clips into the
    bin-center table.

    output_ids: int[..., >= action_dim + 1] full generation, or exactly
      [action_dim] pre-sliced action token ids.
    Returns: fp32[action_dim] normalised action.
    """
    ids = np.asarray(output_ids)
    if ids.ndim > 1:
        ids = ids.reshape(-1)
    if len(ids) != action_dim:
        ids = ids[-(action_dim + 1):-1]
    centers = magma_bin_centers(n_action_bins)
    discretized = vocab_size - ids.astype(np.int64)
    discretized = np.clip(discretized - 1, 0, len(centers) - 1)
    return centers[discretized].astype(np.float32)


def masked_denormalize_bound(normalized: np.ndarray,
                             stats: DatasetStatistics,
                             mask: Optional[np.ndarray] = None) -> np.ndarray:
    """p01/p99 bound-denormalisation with the dataset-statistics mask
    (BridgeSimplerMagmaAdapter.postprocess, simpler.py:330-340): masked-out
    dims (e.g. the gripper) pass through unchanged."""
    a = np.asarray(normalized, np.float64)
    p01 = np.asarray(stats.action.p01)[: a.shape[-1]]
    p99 = np.asarray(stats.action.p99)[: a.shape[-1]]
    if mask is None:
        mask = np.ones(a.shape[-1], bool)
        mask[-1] = False  # gripper dim is identity in the Bridge stats mask
    return np.where(mask, 0.5 * (a + 1.0) * (p99 - p01) + p01, a)


def euler_action_to_exec(action: np.ndarray,
                         binarize_gripper: bool = False) -> np.ndarray:
    """[dx dy dz | roll pitch yaw | gripper 0..1] -> simpler execution
    format [dx dy dz | axis-angle | gripper ±1]
    (BridgeSimplerSpatialVLAAdapter.postprocess_action, simpler.py:277-307)."""
    a = np.asarray(action, np.float64).reshape(-1)
    axis, angle = euler2axangle(*a[3:6])
    g = 2.0 * (a[6] > 0.5) - 1.0
    if binarize_gripper:
        g = np.sign(g)
    return np.concatenate([a[:3], axis * angle, [g]])


def hf_causal_generate_fn(model, build_inputs: Callable[[Dict], Dict],
                          max_new_tokens: int = 8,
                          allowed_token_range: Optional[tuple] = None
                          ) -> Callable[[Dict], np.ndarray]:
    """Bind a real `transformers` causal-LM into a `generate_fn(obs)->ids`.

    The reference's HF wrappers call `model.generate` on processor-built
    inputs and hand the raw id tensor to the decode step
    (policy_wrapper.py:187-223 SpatialVLA, :225-293 Magma). This helper is
    that seam: `build_inputs(obs)` maps an observation to the model's
    tensor kwargs (the task-specific processor), and the returned ids
    (prompt prefix + generated tail, exactly what `generate` yields) feed
    `magma_decode_tokens` / a custom `decode_fn` unchanged.

    allowed_token_range: optional (lo, hi) restricting generation to the
    action-token id range — how Magma-style heads keep `generate` inside
    the bin vocabulary.

    Generation runs on the model's own device under `torch.no_grad()`: the
    input tensors are moved there, and the ids come back as a host array.
    """
    import torch

    prefix_fn = None
    if allowed_token_range is not None:
        lo, hi = allowed_token_range
        allowed = list(range(lo, hi))

        def prefix_fn(batch_id, input_ids):  # noqa: ANN001
            return allowed

    def generate_fn(obs: Dict[str, Any]) -> np.ndarray:
        device = next(model.parameters()).device
        inputs = {k: v.to(device) if isinstance(v, torch.Tensor) else v
                  for k, v in build_inputs(obs).items()}
        with torch.no_grad():
            out = model.generate(
                **inputs, max_new_tokens=max_new_tokens, do_sample=False,
                prefix_allowed_tokens_fn=prefix_fn,
                pad_token_id=getattr(model.config, "pad_token_id", None)
                or getattr(model.config, "eos_token_id", 0))
        return out[0].cpu().numpy()

    return generate_fn


class ScriptedPolicyWrapper:
    """Deterministic proportional controller toward a target — a servable
    stand-in exercising the full RPC surface without a model."""

    def __init__(self, gain: float = 0.5):
        self.gain = gain
        self.adapter = BridgeSimplerAdapter()
        self.reset()

    def reset(self) -> None:
        self._target = np.array([0.05, 0.05, 0.02])

    def switch_model(self, path: str) -> None:
        pass

    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        eef = np.asarray(obs["agent"]["eef_pos"])[:3] if "agent" in obs \
            else np.zeros(3)
        delta = np.clip(self.gain * (self._target - eef), -0.05, 0.05)
        return {"actions": np.concatenate([delta, [0, 0, 0], [1.0]])}


class HFModelPolicyWrapper:
    """Generic wrapper for an autoregressive HF-style policy (the
    SpatialVLA/Magma pattern): caller supplies `generate_fn(obs)->tokens`
    and `decode_fn(tokens)->actions [chunk, 7]`; this class adds the
    adapter postprocess, optional temporal ensembling, and the queue."""

    def __init__(self, generate_fn: Callable, decode_fn: Callable,
                 chunk_size: int = 4, ensemble_temp: Optional[float] = None,
                 adapter: Optional[BridgeSimplerAdapter] = None):
        self.generate_fn = generate_fn
        self.decode_fn = decode_fn
        self.chunk_size = chunk_size
        self.adapter = adapter or BridgeSimplerAdapter()
        self.ensembler = (ActionEnsembler(chunk_size, ensemble_temp)
                          if ensemble_temp is not None else None)
        self.reset()

    def reset(self) -> None:
        self._queue = []
        self.adapter.reset()
        if self.ensembler:
            self.ensembler.reset()

    def switch_model(self, path: str) -> None:
        raise NotImplementedError("bind a new generate_fn instead")

    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        if self.ensembler is not None:
            chunk = self.decode_fn(self.generate_fn(obs))
            raw = self.ensembler.ensemble(np.asarray(chunk))
            return {"actions": self.adapter.postprocess(raw[None])[0]}
        if not self._queue:
            chunk = self.decode_fn(self.generate_fn(obs))
            self._queue = [a for a in self.adapter.postprocess(
                np.asarray(chunk))]
        return {"actions": self._queue.pop(0)}


class MagmaPolicyWrapper:
    """Magma-family wrapper: `generate_fn(obs) -> token ids`; this class
    owns the CONCRETE token-bin decode + masked denorm + exec conversion
    (policy_wrapper.py:225-293 + simpler.py:309-340). Magma emits one
    action per generation (no chunk queue, no proprio input)."""

    def __init__(self, generate_fn: Callable[[Dict], np.ndarray],
                 vocab_size: int,
                 stats: Optional[DatasetStatistics] = None,
                 n_action_bins: int = 256,
                 stats_mask: Optional[np.ndarray] = None):
        self.generate_fn = generate_fn
        self.vocab_size = vocab_size
        self.n_action_bins = n_action_bins
        self.stats = stats or DatasetStatistics.from_json()
        self.stats_mask = stats_mask

    def reset(self) -> None:
        pass

    def switch_model(self, path: str) -> None:
        raise NotImplementedError("bind a new generate_fn instead")

    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        ids = np.asarray(self.generate_fn(obs))
        normalized = magma_decode_tokens(ids, self.vocab_size,
                                         self.n_action_bins)
        raw = masked_denormalize_bound(normalized, self.stats,
                                       self.stats_mask)
        return {"actions": euler_action_to_exec(raw, binarize_gripper=True)}


class SpatialVLAPolicyWrapper:
    """SpatialVLA-family wrapper: `predict_fn(obs) -> [horizon, 7]` chunk
    of UNNORMALISED euler-format actions (the HF processor's decode_actions
    applies norm_key statistics inside the model — simpler.py:229-234);
    this class owns the temporal ensembling + exec conversion
    (simpler.py:236-307)."""

    def __init__(self, predict_fn: Callable[[Dict], np.ndarray],
                 chunk_size: int = 4,
                 ensemble_temp: Optional[float] = -0.8):
        self.predict_fn = predict_fn
        self.ensembler = (ActionEnsembler(chunk_size, ensemble_temp)
                          if ensemble_temp is not None else None)
        self._queue: list = []

    def reset(self) -> None:
        self._queue = []
        if self.ensembler is not None:
            self.ensembler.reset()

    def switch_model(self, path: str) -> None:
        raise NotImplementedError("bind a new predict_fn instead")

    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        if self.ensembler is not None:
            chunk = np.asarray(self.predict_fn(obs))
            raw = self.ensembler.ensemble(chunk)
            return {"actions": euler_action_to_exec(raw)}
        if not self._queue:
            chunk = np.asarray(self.predict_fn(obs))
            self._queue = [euler_action_to_exec(a) for a in chunk]
        return {"actions": self._queue.pop(0)}
