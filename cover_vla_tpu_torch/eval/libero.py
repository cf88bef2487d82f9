"""LIBERO benchmark evaluation (optional dependency).

Counterpart of INT-ACT's LIBERO evaluator
(src/experiments/envs/libero/libero_evaluator.py): task-suite registry
(libero_spatial/object/goal/long/90), env construction via the
`libero` package when installed, and an episode loop reusing the generic
evaluator surface. Without the package, a fake env stands in so the loop
is CI-testable.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

LIBERO_SUITES = ["libero_spatial", "libero_object", "libero_goal",
                 "libero_10", "libero_90"]


def libero_available() -> bool:
    try:
        import libero  # noqa: F401
        return True
    except Exception:
        return False


class LiberoEnvWrapper:
    """Adapts a LIBERO OffScreenRenderEnv to the evaluator surface."""

    def __init__(self, env, instruction: str):
        self.env = env
        self.instruction = instruction

    def reset(self, seed: Optional[int] = None):
        self.env.seed(seed or 0)
        obs = self.env.reset()
        return self._convert(obs), {}

    def step(self, action: np.ndarray):
        obs, reward, done, info = self.env.step(np.asarray(action))
        return self._convert(obs), reward, bool(done), False, info

    def get_language_instruction(self) -> str:
        return self.instruction

    def _convert(self, obs: Dict) -> Dict:
        out = dict(obs)
        if "agentview_image" in obs:
            out["image"] = obs["agentview_image"][::-1]  # libero flips
        if "robot0_eef_pos" in obs:
            quat = obs.get("robot0_eef_quat", np.array([0, 0, 0, 1.0]))
            grip = obs.get("robot0_gripper_qpos", np.array([0.04]))[:1]
            # wxyz ordering for the adapters
            out["agent"] = {"eef_pos": np.concatenate(
                [obs["robot0_eef_pos"], np.roll(quat, 1), grip])}
        return out


def make_libero_env(suite: str, task_id: int = 0, **kwargs):
    if not libero_available():
        from cover_vla_tpu_torch.eval.fake_env import make_fake_env
        return make_fake_env(f"{suite}_task{task_id}", **kwargs)
    from libero.libero import benchmark as lb
    from libero.libero.envs import OffScreenRenderEnv
    suite_obj = lb.get_benchmark_dict()[suite]()
    task = suite_obj.get_task(task_id)
    env = OffScreenRenderEnv(
        bddl_file_name=suite_obj.get_task_bddl_file_path(task_id), **kwargs)
    return LiberoEnvWrapper(env, task.language)


def list_tasks(suite: str) -> List[str]:
    if not libero_available():
        return [f"{suite}_task{i}" for i in range(3)]
    from libero.libero import benchmark as lb
    suite_obj = lb.get_benchmark_dict()[suite]()
    return [suite_obj.get_task(i).language
            for i in range(suite_obj.n_tasks)]


# Per-suite episode caps (libero_evaluator.py:230-244: longest training
# demo + margin)
LIBERO_MAX_STEPS: Dict[str, int] = {
    "libero_spatial": 220,
    "libero_object": 280,
    "libero_goal": 300,
    "libero_10": 520,
    "libero_90": 400,
}

# no-op action while objects settle after reset (libero_evaluator.py:126-131)
LIBERO_DUMMY_ACTION = np.asarray([0.0, 0, 0, 0, 0, 0, -1.0])
LIBERO_SETTLE_STEPS = 10


class LiberoEvaluator:
    """Suite-level LIBERO evaluation loop (libero_evaluator.py:39-220).

    Drives any policy exposing reset(task)/select_action(image, state,
    task) over every task of a suite: per-episode deterministic initial
    states (env.set_init_state when available), 10 settle steps with the
    dummy action, the 180-degree agentview frame flip, and per-suite step
    caps. env_fn defaults to make_libero_env (fake-env fallback)."""

    def __init__(self, policy, suite: str, n_eval_episodes: int = 10,
                 env_fn=None, max_steps: Optional[int] = None):
        if suite not in LIBERO_SUITES:
            raise ValueError(f"unknown LIBERO suite {suite!r}")
        self.policy = policy
        self.suite = suite
        self.n_eval_episodes = n_eval_episodes
        self.env_fn = env_fn or make_libero_env
        self.max_steps = max_steps or LIBERO_MAX_STEPS[suite]

    def evaluate_task(self, task_id: int) -> Dict:
        env = self.env_fn(self.suite, task_id)
        instruction = env.get_language_instruction() \
            if hasattr(env, "get_language_instruction") else str(task_id)
        successes = 0
        init_states = getattr(env, "get_task_init_states", lambda: None)()
        for ep in range(self.n_eval_episodes):
            obs, _ = env.reset(seed=ep)
            if init_states is not None and hasattr(env, "set_init_state"):
                obs = env.set_init_state(init_states[ep % len(init_states)])
            self.policy.reset(instruction)
            t, done = 0, False
            while t < self.max_steps + LIBERO_SETTLE_STEPS and not done:
                if t < LIBERO_SETTLE_STEPS:
                    obs, _, done, _, _ = env.step(LIBERO_DUMMY_ACTION)[:5]
                    t += 1
                    continue
                frame = obs.get("image")
                if frame is None and "agentview_image" in obs:
                    # rotate 180 (libero frames arrive upside down)
                    frame = np.ascontiguousarray(
                        obs["agentview_image"][::-1, ::-1])
                state = obs.get("agent", {}).get("eef_pos",
                                                 np.zeros(8, np.float32))
                action = self.policy.select_action(frame, state, instruction)
                obs, _, done, trunc, _ = env.step(np.asarray(action))
                t += 1
                if trunc:
                    break
            successes += bool(done)
        return {"task_id": task_id, "instruction": instruction,
                "episodes": self.n_eval_episodes,
                "success_rate": successes / self.n_eval_episodes}

    def evaluate(self, n_tasks: Optional[int] = None) -> Dict:
        tasks = list_tasks(self.suite)
        n = n_tasks or len(tasks)
        results = [self.evaluate_task(i) for i in range(n)]
        return {
            "suite": self.suite,
            "per_task": results,
            "success_rate": float(np.mean([r["success_rate"]
                                           for r in results])),
        }
