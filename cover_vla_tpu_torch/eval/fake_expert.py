"""Scripted expert + demonstration collection for the FakeWidowX env.

Support code for the verification-scaling experiment (the repo's analog of
the reference's headline success-rate table, README.md:136-155): a
privileged scripted controller produces demonstrations on the scriptable
fake env; a tiny pi0 is behaviour-cloned on them (flow matching) and a tiny
verifier is trained contrastively on (frame, instruction) vs trajectory
pairs — after which success rate vs candidate count N can be measured for
verifier / random / candidate-0 selection through the real batched engine.

Everything here is host-side numpy; the training batches it emits match the
exact tensor contracts of training.train_pi0.loss_fn and
training.train_verifier.make_ensemble_train_step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from cover_vla_tpu_torch.data.stats import DatasetStatistics, FieldStats
from cover_vla_tpu_torch.eval.fake_env import FakeWidowXEnv


def expert_action(env: FakeWidowXEnv,
                  rng: Optional[np.random.Generator] = None,
                  noise: float = 0.0) -> np.ndarray:
    """Privileged scripted controller: reach -> grasp -> carry -> release.

    Returns the execution-format action [dx dy dz | rotvec(=0) | grip ±1]
    (simpler convention: -1 closes, +1 opens)."""
    ee, obj, target = env._ee, env._obj, env._target
    if not env._grasped:
        d = obj - ee
        delta = np.clip(d, -0.05, 0.05)
        grip = -1.0 if np.linalg.norm(d) <= 0.045 else 1.0
    else:
        d = target - obj
        if np.linalg.norm(d[:2]) > 0.035:
            delta = np.clip(d, -0.05, 0.05)
            grip = -1.0          # keep holding
        else:
            delta = np.zeros(3)
            grip = 1.0           # release over the target
    if noise and rng is not None:
        delta = np.clip(delta + rng.normal(0, noise, 3), -0.05, 0.05)
    return np.concatenate([delta, np.zeros(3), [grip]]).astype(np.float32)


def exec_to_verifier_format(actions: np.ndarray) -> np.ndarray:
    """[.., 7] exec actions -> verifier format: euler in place of rotvec
    (identical for the fake expert's zero rotations) and gripper {0,1}
    (1 = open), mirroring the engine's on-device conversion."""
    out = np.asarray(actions, np.float32).copy()
    out[..., 6] = (out[..., 6] > 0).astype(np.float32)
    return out


def collect_demos(n_episodes: int = 200, max_steps: int = 60,
                  seed: int = 0, action_noise: float = 0.008,
                  task_name: str = "widowx_carrot_on_plate",
                  env_kwargs: Optional[Dict] = None) -> Dict[str, np.ndarray]:
    """Roll the scripted expert; returns flat per-step arrays + episode ids.

    frames: uint8[T,256,256,3]; proprios: fp32[T,7] (euler format, the
    BridgeSimplerAdapter.preprocess_proprio output); actions: fp32[T,7]
    exec format; episode: int32[T]; t_in_ep: int32[T]."""
    from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
    adapter = BridgeSimplerAdapter()
    rng = np.random.default_rng(seed)
    frames, proprios, actions, eps, ts = [], [], [], [], []
    n_success = 0
    for e in range(n_episodes):
        env = FakeWidowXEnv(task_name, max_steps=max_steps,
                            **(env_kwargs or {}))
        obs, _ = env.reset(seed=seed * 100_003 + e)
        for t in range(max_steps):
            a = expert_action(env, rng, noise=action_noise)
            frames.append(obs["image"])
            proprios.append(adapter.preprocess_proprio(
                {"agent": obs["agent"]}).astype(np.float32))
            actions.append(a)
            eps.append(e)
            ts.append(t)
            obs, _, done, trunc, _ = env.step(a)
            if done:
                n_success += 1
                break
            if trunc:
                break
    return {
        "frames": np.stack(frames),
        "proprios": np.stack(proprios),
        "actions": np.stack(actions),
        "episode": np.asarray(eps, np.int32),
        "t_in_ep": np.asarray(ts, np.int32),
        "n_episodes": n_episodes,
        "expert_success_rate": n_success / n_episodes,
    }


def fit_statistics(demos: Dict[str, np.ndarray]) -> DatasetStatistics:
    """Fit p01/p99/mean/std bounds on the demo distribution (the experiment
    analog of bridge_statistics.json)."""
    def field(x):
        x = np.asarray(x, np.float64)
        return FieldStats(
            mean=x.mean(0), std=x.std(0),
            p01=np.percentile(x, 1, axis=0),
            p99=np.percentile(x, 99, axis=0),
            minimum=x.min(0), maximum=x.max(0))
    return DatasetStatistics(
        action=field(demos["actions"]),
        proprio=field(demos["proprios"]),
        num_transitions=len(demos["actions"]),
        num_trajectories=int(demos["n_episodes"]))


def normalize_action(a: np.ndarray, stats: DatasetStatistics) -> np.ndarray:
    """Exec-format raw action -> the policy's training target space: dims
    0-5 bound-normalized to [-1,1] (inverse of the engine's on-device
    denorm), gripper ±1 -> {0,1} (engine thresholds the [0,1] output at
    0.5)."""
    p01 = stats.action.p01[:6]
    p99 = stats.action.p99[:6]
    out = np.asarray(a, np.float32).copy()
    out[..., :6] = np.clip(
        2 * (out[..., :6] - p01) / (p99 - p01 + 1e-8) - 1, -1, 1)
    out[..., 6] = (out[..., 6] > 0).astype(np.float32)
    return out


def normalize_proprio(p: np.ndarray, stats: DatasetStatistics) -> np.ndarray:
    p01, p99 = stats.proprio.p01, stats.proprio.p99
    return np.clip(2 * (np.asarray(p, np.float64) - p01)
                   / (p99 - p01 + 1e-8) - 1, -1, 1).astype(np.float32)


def build_policy_dataset(demos: Dict[str, np.ndarray],
                         stats: DatasetStatistics, chunk_size: int,
                         max_state_dim: int = 32, max_action_dim: int = 32
                         ) -> Dict[str, np.ndarray]:
    """Flat demo steps -> pi0 training tuples (state + action-chunk
    targets); only steps with a full future chunk inside the episode are
    kept. Images stay raw uint8 (preprocessing is jitted separately so it
    matches the engine's on-device chain exactly)."""
    eps, ts = demos["episode"], demos["t_in_ep"]
    T = len(eps)
    # index of the first step of each episode for boundary checks
    keep, chunks = [], []
    for i in range(T):
        j = i + chunk_size - 1
        if j < T and eps[j] == eps[i] and ts[j] == ts[i] + chunk_size - 1:
            keep.append(i)
            chunks.append(demos["actions"][i:i + chunk_size])
    keep = np.asarray(keep, np.int64)
    chunks = np.stack(chunks)                      # [M, chunk, 7]

    state = np.zeros((len(keep), max_state_dim), np.float32)
    state[:, :7] = normalize_proprio(demos["proprios"][keep], stats)
    targets = np.zeros((len(keep), chunk_size, max_action_dim), np.float32)
    targets[..., :7] = normalize_action(chunks, stats)
    return {
        "frames": demos["frames"][keep],           # uint8 [M, 256, 256, 3]
        "state": state,
        "actions": targets,
    }


def build_verifier_dataset(demos: Dict[str, np.ndarray], chunk_size: int,
                           max_history: int, padding_value: float = -5.0
                           ) -> Dict[str, np.ndarray]:
    """Flat demo steps -> verifier contrastive tuples: the frame at t with
    the verifier-format trajectory [<=max_history past | chunk future],
    top-padded to (max_history + chunk) with the padding value — the exact
    layout the engine assembles on-device."""
    eps, ts = demos["episode"], demos["t_in_ep"]
    T = len(eps)
    H = max_history + chunk_size
    vactions = exec_to_verifier_format(demos["actions"])
    keep, trajs = [], []
    for i in range(T):
        j = i + chunk_size - 1
        if not (j < T and eps[j] == eps[i]
                and ts[j] == ts[i] + chunk_size - 1):
            continue
        n_past = min(int(ts[i]), max_history)
        traj = np.full((H, 7), padding_value, np.float32)
        if n_past:
            traj[max_history - n_past:max_history] = \
                vactions[i - n_past:i]
        traj[max_history:] = vactions[i:i + chunk_size]
        keep.append(i)
        trajs.append(traj)
    return {
        "frames": demos["frames"][np.asarray(keep, np.int64)],
        "action_histories": np.stack(trajs),
    }


def task_potential(env: FakeWidowXEnv) -> float:
    """Privileged progress potential: higher = closer to success. Used to
    label candidate chunks by the true progress they would make."""
    if env.episode_stats["success"]:
        return 10.0
    if env._grasped:
        return 2.0 - float(np.linalg.norm(env._obj[:2] - env._target[:2]))
    return -float(np.linalg.norm(env._ee - env._obj))


def chunk_quality(env: FakeWidowXEnv, exec_chunk: np.ndarray) -> float:
    """True quality of an execution-format action chunk from the env's
    CURRENT state: step a copy of the env through the chunk and measure
    the potential gain (the oracle the verifier is trained to imitate)."""
    import copy
    sim = copy.deepcopy(env)
    before = task_potential(sim)
    for a in exec_chunk:
        _, _, done, trunc, _ = sim.step(np.asarray(a, np.float64))
        if done or trunc:
            break
    return task_potential(sim) - before


def build_ranking_negatives(trajs: np.ndarray, max_history: int,
                            rng: np.random.Generator,
                            n_other: int = 2) -> np.ndarray:
    """Corrupted-future negatives for the ranking loss: same history, wrong
    future chunk. [B, H, 7] -> [B, M, H, 7] with M = n_other + 3.

    Corruptions mirror how bad candidates actually differ from good ones
    at engine time: wrong direction (sign-flipped xyz), wrong gripper
    timing (flipped open/close), shuffled step order, and futures lifted
    from other frames."""
    b = len(trajs)
    negs = []
    for _ in range(n_other):                     # other frames' futures
        perm = rng.permutation(b)
        other = trajs.copy()
        other[:, max_history:] = trajs[perm][:, max_history:]
        negs.append(other)
    flip = trajs.copy()                          # reversed direction
    flip[:, max_history:, :3] *= -1.0
    negs.append(flip)
    grip = trajs.copy()                          # wrong gripper timing
    grip[:, max_history:, 6] = 1.0 - grip[:, max_history:, 6]
    negs.append(grip)
    rot = trajs.copy()                           # sideways direction
    rot[:, max_history:, 0], rot[:, max_history:, 1] = \
        trajs[:, max_history:, 1], -trajs[:, max_history:, 0]
    negs.append(rot)
    return np.stack(negs, axis=1)
