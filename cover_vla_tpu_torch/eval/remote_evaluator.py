"""Process-split evaluation: env loop in this process, policy over RPC.

The simulator and the GPU policy server run in different processes or
machines; observations go out and actions come back as msgpack-numpy
frames (`serving/policy_service.py`).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from cover_vla_tpu_torch.eval.fake_env import get_image_from_obs_dict
from cover_vla_tpu_torch.serving import WebsocketPolicyClient


class RemoteEvaluator:
    def __init__(self, client: WebsocketPolicyClient,
                 max_steps: int = 150):
        self.client = client
        self.max_steps = max_steps

    def run_episode(self, env, seed: int = 0) -> Dict:
        obs, _ = env.reset(seed=seed)
        task = env.get_language_instruction() \
            if hasattr(env, "get_language_instruction") else ""
        self.client.reset()
        success, t = False, 0
        while t < self.max_steps:
            payload = {
                "image": get_image_from_obs_dict(env, obs),
                "state": {"agent": obs["agent"]} if "agent" in obs else {},
                "task": task,
            }
            out = self.client.infer(payload)
            action = np.asarray(out["actions"])
            obs, reward, done, trunc, info = env.step(action)
            t += 1
            if done:
                success = True
                break
            if trunc:
                break
        return {"success": success, "steps": t, "task": task}

    def evaluate(self, envs: Sequence, seeds: Optional[Sequence[int]] = None
                 ) -> Dict:
        seeds = seeds or list(range(len(envs)))
        eps = [self.run_episode(env, seed) for env, seed in zip(envs, seeds)]
        return {
            "episodes": eps,
            "success_rate": float(np.mean([e["success"] for e in eps])),
        }


def switch_and_evaluate(client: WebsocketPolicyClient,
                        checkpoints: Sequence[str], envs_fn,
                        **kwargs) -> Dict[str, Dict]:
    """Per-checkpoint iteration: switch the served model, re-evaluate."""
    results = {}
    for ckpt in checkpoints:
        client.switch_model(ckpt)
        results[ckpt] = RemoteEvaluator(client, **kwargs).evaluate(envs_fn())
    return results
