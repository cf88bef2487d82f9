"""Closed-loop episode evaluator over the CoVer engines.

Mirrors the reference evaluation loops (eval_simpler,
run_simpler_eval_with_openpi.py:106-520, and SimplerEvaluator.evaluate_task,
INT-ACT/.../simpler_evaluator.py:69-255): per-task trial loop, wait-steps
for physics settling, per-episode record (verifier scores, selected
instructions, executed actions, frames), success aggregation and
episode_stats partial metrics, optional MP4/pickle sinks.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from cover_vla_tpu_torch.engine import CoVerEngine
from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
from cover_vla_tpu_torch.eval.benchmark import get_benchmark, TASK_INSTRUCTIONS
from cover_vla_tpu_torch.eval.fake_env import get_image_from_obs_dict


@dataclass
class EpisodeResult:
    task: str
    trial: int
    seed: int
    success: bool
    num_steps: int
    episode_stats: Dict
    verifier_scores: List[float]
    selected_instructions: List[str]
    execute_actions: List[np.ndarray]
    wall_s: float
    frames: Optional[List[np.ndarray]] = None


@dataclass
class EvalConfig:
    task_suite: str = "simpler_widowx"
    num_trials_per_task: int = 10
    max_steps: int = 150
    num_steps_wait: int = 0          # physics settling steps (dummy actions)
    seed: int = 7
    seed_period: int = 50            # reference cycles seeds every 50 trials
    save_frames: bool = False
    out_dir: Optional[str] = None


class CoVerEvaluator:
    def __init__(self, engine: CoVerEngine, cfg: EvalConfig,
                 env_fn=None, stats=None, fractal_stats=None):
        """stats: DatasetStatistics for the Bridge adapter (defaults to the
        vendored bridge_statistics.json — should match the ENGINE's stats).
        fractal_stats: statistics for google_robot (EDR) tasks; the
        reference loads these from dataset_statistics_path (simpler.py:33).
        Running a google_robot task without them raises — Bridge bounds
        would silently mis-normalize fractal-trained checkpoints."""
        self.engine = engine
        self.cfg = cfg
        bench = get_benchmark(cfg.task_suite)()
        self.tasks = bench.tasks
        self.env_fn = env_fn or bench.make
        self.adapter = BridgeSimplerAdapter(stats=stats) if stats is not None \
            else BridgeSimplerAdapter()
        # google-robot (fractal) tasks use the EDR euler adapter with the
        # Octo-style sticky gripper (simpler.py:394-526)
        from cover_vla_tpu_torch.eval.fractal_adapters import EDREulerSimplerAdapter
        self._fractal_adapter = (
            EDREulerSimplerAdapter(stats=fractal_stats)
            if fractal_stats is not None else None)

    def _task_adapter(self, task: str):
        if task.startswith("google_robot"):
            if self._fractal_adapter is None:
                raise ValueError(
                    f"task {task!r} needs fractal dataset statistics "
                    "(--eval.dataset_statistics pointing at fractal stats); "
                    "refusing to silently normalize with Bridge bounds")
            return self._fractal_adapter
        return self.adapter

    def run_episode(self, env, task: str, trial: int, seed: int
                    ) -> EpisodeResult:
        t0 = time.time()
        adapter = self._task_adapter(task)
        is_fractal = adapter is self._fractal_adapter
        adapter.reset()
        obs, _ = env.reset(seed=seed)
        instruction = env.get_language_instruction() \
            if hasattr(env, "get_language_instruction") \
            else TASK_INSTRUCTIONS.get(task, task)
        self.engine.reset(instruction)

        frames = [] if self.cfg.save_frames else None
        success, t, stats = False, 0, {}
        dummy = np.zeros(7)
        while t < self.cfg.max_steps + self.cfg.num_steps_wait:
            if t < self.cfg.num_steps_wait:
                obs, _, done, trunc, info = env.step(dummy)
                t += 1
                continue
            raw_img = get_image_from_obs_dict(env, obs)
            if frames is not None:
                frames.append(raw_img)
            proprio = adapter.preprocess_proprio(
                {"agent": obs["agent"]})
            action = self.engine.step(raw_img, proprio.astype(np.float32))
            if is_fractal:
                # sticky-gripper postprocess on the winner's RAW [0,1]
                # gripper (simpler.py:427-459); the on-device binarise/vote
                # is the WidowX convention only
                action = np.asarray(action).copy()
                action[6] = adapter.postprocess_gripper(
                    self.engine.last_raw_gripper)
            obs, reward, done, trunc, info = env.step(action)
            stats = info.get("episode_stats", {})
            t += 1
            if done:
                success = True
                break
            if trunc:
                break

        recs = self.engine.records
        return EpisodeResult(
            task=task, trial=trial, seed=seed, success=success,
            num_steps=t - self.cfg.num_steps_wait, episode_stats=stats,
            verifier_scores=[r.max_score for r in recs],
            selected_instructions=[r.selected_instruction for r in recs],
            execute_actions=[r.execute_action for r in recs],
            wall_s=time.time() - t0, frames=frames)

    def evaluate(self) -> Dict:
        results: List[EpisodeResult] = []
        for task in self.tasks:
            env = self.env_fn(task)
            for trial in range(self.cfg.num_trials_per_task):
                seed = self.cfg.seed + (trial % self.cfg.seed_period)
                ep = self.run_episode(env, task, trial, seed)
                results.append(ep)
                if self.cfg.out_dir:
                    save_episode(ep, self.cfg.out_dir)

        summary = summarize(results)
        return {"summary": summary, "episodes": results}


def evaluate_suite_batched(policy_params, verifier_params, pcfg, vcfg, ccfg,
                           cfg: EvalConfig, n_parallel: int,
                           env_fn=None, stats=None, rephrases=None,
                           pipelined: bool = False, seed: int = 0,
                           policy_tokenizer=None, verifier_tokenizer=None,
                           out_dir: Optional[str] = None,
                           score_fn_factory=None, device=None) -> Dict:
    """Suite evaluation through the lockstep-batched engine (the fast
    path): trials of each task run in cohorts of `n_parallel` episodes, one
    verified step serving the whole cohort per chunk — the reference's
    n_parallel_eval mode (configuration_pipeline.py:125,
    simplerMS3_evaluator.py:32). With `pipelined=True`, cohorts run in
    pairs whose host sim-stepping overlaps the other cohort's device
    step. The parameters must live on `device` (CUDA unless given).

    Cohorts are padded to `n_parallel` with extra seeds so every cohort
    has the same shape; padding episodes are dropped from the results. WidowX convention only (google_robot tasks need the sticky
    gripper host path — use the per-episode evaluator).

    score_fn_factory (requires ccfg.selection == "injected"):
    `factory(envs) -> score_fn(exec_chunks [E,K*N,chunk,7]) -> [E,K*N]` —
    an external candidate scorer bound to each cohort's live envs; the
    selection machinery (gate + group-mean + gripper vote) still runs
    on-device through the same program as the verifier arm."""
    from cover_vla_tpu_torch.engine.batched_engine import (
        BatchedCoVerEngine, evaluate_batched, evaluate_batched_pipelined)
    from cover_vla_tpu_torch.engine.verified_step import (
        make_propose_step_batched, make_select_step_batched,
        make_verified_step_batched)
    from cover_vla_tpu_torch.data.stats import DatasetStatistics
    from cover_vla_tpu_torch.device import resolve_device

    bench = get_benchmark(cfg.task_suite)()
    env_fn = env_fn or bench.make
    for task in bench.tasks:
        if task.startswith("google_robot"):
            raise ValueError(
                f"{task!r}: google_robot suites need the per-episode "
                "evaluator (sticky-gripper host postprocess); use "
                "--eval.n_parallel 1")
    dev = resolve_device(device)
    stats = stats or DatasetStatistics.from_json()
    adapter = BridgeSimplerAdapter(stats=stats)
    if ccfg.selection == "injected":
        if score_fn_factory is None:
            raise ValueError("selection='injected' needs score_fn_factory")
        step_fn = (make_propose_step_batched(pcfg, vcfg, ccfg, stats,
                                             device=dev),
                   make_select_step_batched(ccfg, device=dev))
    else:
        step_fn = make_verified_step_batched(pcfg, vcfg, ccfg, stats,
                                             device=dev)

    def make_engine(s):
        engine = BatchedCoVerEngine(
            policy_params, verifier_params, pcfg, vcfg, ccfg,
            num_episodes=n_parallel, stats=stats, rephrases=rephrases,
            seed=s, step_fn=step_fn, device=dev,
            policy_tokenizer=policy_tokenizer,
            verifier_tokenizer=verifier_tokenizer)
        engine.score_fn_factory = score_fn_factory
        return engine

    engine_a = make_engine(seed)
    engine_b = make_engine(seed + 1) if pipelined else None

    per_task: Dict[str, Dict] = {}
    t_start = time.time()
    total_control_steps = 0
    for task in bench.tasks:
        trials = list(range(cfg.num_trials_per_task))
        seeds = [cfg.seed + (tr % cfg.seed_period) for tr in trials]
        # pad the final cohort with fresh seeds; results dropped below
        pad = (-len(trials)) % n_parallel
        seeds += [cfg.seed + cfg.seed_period + i for i in range(pad)]
        cohorts = [seeds[i:i + n_parallel]
                   for i in range(0, len(seeds), n_parallel)]

        succ: List[bool] = []
        steps: List[int] = []
        sel_instr: List[List[str]] = []

        def run_single(cohort_seeds):
            envs = [env_fn(task) for _ in cohort_seeds]
            return evaluate_batched(engine_a, envs, adapter,
                                    max_steps=cfg.max_steps,
                                    seeds=list(cohort_seeds))

        i = 0
        while i < len(cohorts):
            if pipelined and i + 1 < len(cohorts):
                envs_a = [env_fn(task) for _ in cohorts[i]]
                envs_b = [env_fn(task) for _ in cohorts[i + 1]]
                out = evaluate_batched_pipelined(
                    engine_a, engine_b, envs_a, envs_b, adapter,
                    max_steps=cfg.max_steps,
                    seeds_a=list(cohorts[i]), seeds_b=list(cohorts[i + 1]))
                i += 2
            else:
                out = run_single(cohorts[i])
                i += 1
            succ += [bool(s) for s in out["success"]]
            steps += [int(s) for s in out["steps"]]
            sel_instr += out.get("selected_instructions",
                                 [[] for _ in out["success"]])
        succ, steps = succ[:len(trials)], steps[:len(trials)]
        sel_instr = sel_instr[:len(trials)]
        total_control_steps += sum(steps)
        # selected_instructions at the payload's top level — the same
        # layout save_episode() pickles, which analyze.load_episodes wraps
        # under "record" for instruction_switch_stats
        episodes = [{"task": task, "trial": tr, "seed": seeds[tr],
                     "success": succ[tr], "num_steps": steps[tr],
                     "selected_instructions": sel_instr[tr]}
                    for tr in trials]
        if out_dir:  # analyzer-compatible per-episode records
            os.makedirs(out_dir, exist_ok=True)
            for ep in episodes:
                stem = (f"episode_{task}_trial{ep['trial']}_"
                        f"seed{ep['seed']}_"
                        f"{'success' if ep['success'] else 'failure'}")
                with open(os.path.join(out_dir, stem + ".pkl"), "wb") as f:
                    pickle.dump(ep, f)
        per_task[task] = {
            "success_rate": float(np.mean(succ)) if succ else 0.0,
            "episodes": len(succ),
            "mean_steps": float(np.mean(steps)) if steps else 0.0,
            "per_episode": episodes,
        }

    all_succ = [s for t in per_task.values()
                for s in [t["success_rate"]] * t["episodes"]]
    wall = time.time() - t_start
    return {
        "summary": {
            "per_task": per_task,
            "overall_success_rate": float(np.mean(all_succ))
            if all_succ else 0.0,
            "total_episodes": int(sum(t["episodes"]
                                      for t in per_task.values())),
        },
        "wall_s": wall,
        "actions_per_sec": total_control_steps / wall if wall > 0 else 0.0,
    }


def summarize(results: List[EpisodeResult]) -> Dict:
    by_task: Dict[str, List[EpisodeResult]] = {}
    for r in results:
        by_task.setdefault(r.task, []).append(r)
    per_task = {
        task: {
            "success_rate": float(np.mean([r.success for r in rs])),
            "episodes": len(rs),
            "mean_steps": float(np.mean([r.num_steps for r in rs])),
        }
        for task, rs in by_task.items()}
    return {
        "per_task": per_task,
        "overall_success_rate": float(np.mean([r.success for r in results]))
        if results else 0.0,
        "total_episodes": len(results),
    }


def save_episode(ep: EpisodeResult, out_dir: str) -> str:
    """Pickle episode record (+ MP4 if frames were kept), with the
    success-encoded filename convention the analyzer parses
    (eval_utils.py:333-391)."""
    os.makedirs(out_dir, exist_ok=True)
    stem = (f"episode_{ep.task}_trial{ep.trial}_seed{ep.seed}_"
            f"{'success' if ep.success else 'failure'}")
    payload = dataclasses.asdict(ep)
    frames = payload.pop("frames", None)
    with open(os.path.join(out_dir, stem + ".pkl"), "wb") as f:
        pickle.dump(payload, f)
    if frames:
        try:
            import imageio.v2 as imageio
            imageio.mimsave(os.path.join(out_dir, stem + ".mp4"),
                            frames, fps=5)
        except Exception:
            pass
    return stem
