"""Episode-batched CoVer engine + lockstep multi-env evaluator.

The equivalent of the reference's GPU-parallel evaluation mode
(SimplerMS3Evaluator with n_parallel_eval,
INT-ACT/src/experiments/envs/simplerMS3/simplerMS3_evaluator.py): E
environments advance in lockstep and ONE verified step per chunk serves
all of them, filling the card with E*K prefills and E*K*N candidate
decodes.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cover_vla_tpu_torch.configs import CoVerConfig, Pi0Config, VerifierConfig
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.data.tokenizer import (
    Tokenizer, make_policy_tokenizer, make_verifier_tokenizer)
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.engine.verified_step import (
    make_propose_step_batched, make_select_step_batched,
    make_verified_step_batched)
from cover_vla_tpu_torch.utils import monitor

_ENGINE_SEQ = itertools.count()


class BatchedCoVerEngine:
    """E lockstep episodes, one device call per chunk_size control ticks.

    With `ccfg.selection == "injected"` the chunk-boundary device work
    splits into propose (sample + decode all candidates) and select (the
    engine's two-stage gate + group-mean + gripper vote over an externally
    supplied score vector); between them the host `score_fn`
    (exec_chunks [E, K*N, chunk, 7] -> scores [E, K*N]) ranks the
    candidates. Every selection arm therefore runs the identical on-device
    selection program, differing only in where the scores come from.

    The parameters (and a shared `step_fn`) must live on `device` (CUDA
    unless given); the flow's noise comes from a `torch.Generator` on that
    device, seeded from `seed`.
    """

    def __init__(self, policy_params, verifier_params,
                 pcfg: Pi0Config, vcfg: VerifierConfig, ccfg: CoVerConfig,
                 num_episodes: int,
                 stats: Optional[DatasetStatistics] = None,
                 policy_tokenizer: Optional[Tokenizer] = None,
                 verifier_tokenizer: Optional[Tokenizer] = None,
                 rephrases: Optional[Dict[str, List[str]]] = None,
                 seed: int = 0, step_fn=None, score_fn=None, device=None):
        self.device = resolve_device(device)
        self.policy_params = policy_params
        self.verifier_params = verifier_params
        self.pcfg, self.vcfg, self.ccfg = pcfg, vcfg, ccfg
        self.E = num_episodes
        self.stats = stats or DatasetStatistics.from_json()
        self.policy_tok = policy_tokenizer or make_policy_tokenizer(
            pcfg.paligemma.vocab_size)
        self.verifier_tok = verifier_tokenizer or make_verifier_tokenizer(
            vcfg.text.vocab_size)
        self.rephrases = rephrases or {}
        self.score_fn = score_fn
        self.score_fn_factory = None   # optional: factory(envs) -> score_fn
        if ccfg.selection == "injected":
            # step_fn (when shared between cohort engines) is the
            # (propose, select) pair for this mode
            self._propose_fn, self._select_fn = step_fn or (
                make_propose_step_batched(pcfg, vcfg, ccfg, self.stats,
                                          device=self.device),
                make_select_step_batched(ccfg, device=self.device))
            self._step_fn = None
        else:
            # step_fn lets cohort engines share one step function
            self._step_fn = step_fn or make_verified_step_batched(
                pcfg, vcfg, ccfg, self.stats, device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._seq = next(_ENGINE_SEQ)   # the span ids of its boundaries
        self._boundaries = 0
        self.reset([""] * num_episodes)

    def reset(self, tasks: Sequence[str]):
        assert len(tasks) == self.E
        self.tasks = list(tasks)
        self.original_tasks = list(tasks)
        self._tick = 0
        self._history = np.zeros((self.E, self.ccfg.max_history, 7),
                                 np.float32)
        self._history_len = np.zeros((self.E,), np.int32)
        self._exec_queue: List[np.ndarray] = []
        self._verif_queue: List[np.ndarray] = []
        self.last_scores = np.zeros((self.E,), np.float32)
        # per-episode winning instruction at each chunk boundary (the
        # reference's per-step selected_instructions pickle record,
        # run_simpler_eval_with_openpi.py:238-247) — analyze.
        # instruction_switch_stats consumes these
        self.selected_instructions = [[] for _ in range(self.E)]
        # episodes the caller has marked finished: their engine state
        # (history ring, instruction switches) freezes so lockstep padding
        # ticks cannot diverge from the per-episode reference records
        self.done = np.zeros((self.E,), bool)

    def mark_done(self, e: int) -> None:
        self.done[e] = True

    def _prompts(self, e: int) -> List[str]:
        k = self.ccfg.n_rephrases
        reph = self.rephrases.get(self.original_tasks[e], [])
        return ([self.tasks[e]] + list(reph))[:k] + \
            [self.tasks[e]] * max(0, k - 1 - len(reph))

    def step(self, raw_images: np.ndarray, proprios: np.ndarray) -> np.ndarray:
        """raw_images: uint8[E,H,W,3]; proprios: fp32[E,7] -> actions [E,7]."""
        return self.step_async(raw_images, proprios)()

    def step_async(self, raw_images: np.ndarray, proprios: np.ndarray):
        """Enqueue the device work for this tick WITHOUT blocking; returns
        a resolver () -> actions [E,7]. The verified step is enqueued on
        the current CUDA stream and ends in no host read, so the caller can
        overlap host work (e.g. stepping another cohort's simulators) with
        it; the resolver's device-to-host copies are the one
        synchronisation. A chunk boundary and its resolver are the spans
        `engine.step_async` and `engine.resolve`, both with this engine's
        sequence number and the boundary's index as their ids."""
        chunk = self.pcfg.chunk_size
        if self._tick % chunk == 0:
            ids = dict(engine=self._seq, boundary=self._boundaries)
            self._boundaries += 1
            with monitor.span("engine.step_async", **ids):
                resolve = self._boundary_async(raw_images, proprios, ids)
        else:
            def resolve(actions=self._exec_queue.pop(0),
                        verif=self._verif_queue.pop(0)):
                self._push_history(verif)
                return actions
        self._tick += 1
        return resolve

    def _tokenize(self):
        k, t = self.ccfg.n_rephrases, self.pcfg.tokenizer_max_length
        lang_tokens = np.zeros((self.E, k, t), np.int32)
        lang_masks = np.zeros((self.E, k, t), bool)
        vtoks = np.zeros((self.E, self.vcfg.text.context_length), np.int32)
        for e in range(self.E):
            toks, masks = self.policy_tok.encode_batch(self._prompts(e), t)
            lang_tokens[e], lang_masks[e] = toks, masks
            vt, _ = self.verifier_tok.encode_batch(
                [self.tasks[e]], self.vcfg.text.context_length)
            vtoks[e] = vt[0]
        return lang_tokens, lang_masks, vtoks

    def _boundary_async(self, raw_images, proprios, ids):
        """A chunk boundary's device work, enqueued; -> its resolver."""
        chunk = self.pcfg.chunk_size
        with monitor.span("engine.tokenize"):
            lang_tokens, lang_masks, vtoks = self._tokenize()

        if self.ccfg.selection == "injected":
            if self.score_fn is None:
                raise ValueError(
                    "selection='injected' needs engine.score_fn "
                    "(exec_chunks [E,K*N,chunk,7] -> scores [E,K*N])")
            proposal = self._propose_fn(
                self.policy_params,
                np.ascontiguousarray(raw_images),
                np.asarray(proprios, np.float32),
                lang_tokens, lang_masks,
                self._history, self._history_len,
                generator=self._generator)

            def res_thunk():
                import inspect
                exec_np = monitor.to_host(proposal.exec_chunks).numpy()
                # collectors/diagnostic scorers may also want the
                # engine-exact trajectories etc. — opt in by declaring
                # a `proposal` parameter
                sig = inspect.signature(self.score_fn)
                if "proposal" in sig.parameters:
                    scores = self.score_fn(exec_np, proposal=proposal)
                else:
                    scores = self.score_fn(exec_np)
                return self._select_fn(
                    np.asarray(scores, np.float32),
                    proposal.exec_chunks,
                    proposal.verifier_chunks, proposal.raw_grippers)
        else:
            # enqueued only: res0 holds device tensors; no host sync yet
            res0 = self._step_fn(
                self.policy_params, self.verifier_params,
                np.ascontiguousarray(raw_images),
                np.asarray(proprios, np.float32),
                lang_tokens, lang_masks, vtoks,
                self._history, self._history_len,
                generator=self._generator)

            def res_thunk():
                return res0
        prompts_at_dispatch = [self._prompts(e) for e in range(self.E)]

        def resolve():
            with monitor.span("engine.resolve", **ids):
                res = res_thunk()
                exec_chunks = monitor.to_host(res.exec_chunk).numpy()
                verif_chunks = monitor.to_host(res.verifier_chunk).numpy()
                groups = monitor.to_host(res.winner_group).numpy()
                stage2 = monitor.to_host(res.used_stage2).numpy()
                self.last_scores = monitor.to_host(res.max_score).numpy()
                for e in range(self.E):
                    if self.done[e]:
                        continue
                    self.selected_instructions[e].append(
                        prompts_at_dispatch[e][int(groups[e])])
                    if stage2[e]:
                        self.tasks[e] = prompts_at_dispatch[e][int(groups[e])]
                self._exec_queue = [exec_chunks[:, i]
                                    for i in range(1, chunk)]
                self._verif_queue = [verif_chunks[:, i]
                                     for i in range(1, chunk)]
                self._push_history(verif_chunks[:, 0])
                return exec_chunks[:, 0]
        return resolve

    def _push_history(self, verif_actions: np.ndarray):
        live = ~self.done
        rolled = np.roll(self._history, -1, axis=1)
        rolled[:, -1] = verif_actions
        self._history[live] = rolled[live]
        self._history_len[live] = np.minimum(
            self._history_len[live] + 1, self.ccfg.max_history)


def evaluate_batched_pipelined(engine_a: BatchedCoVerEngine,
                               engine_b: BatchedCoVerEngine,
                               envs_a: Sequence, envs_b: Sequence,
                               adapter, max_steps: int = 150,
                               seeds_a: Optional[Sequence[int]] = None,
                               seeds_b: Optional[Sequence[int]] = None) -> Dict:
    """Two-cohort pipelined evaluation: while cohort A's verified step runs
    on the card (enqueued, not awaited), cohort B's simulators step on the
    host, and vice versa, hiding CPU physics time behind device compute.
    Produces the same trajectories as running each cohort with
    evaluate_batched."""
    from cover_vla_tpu_torch.eval.fake_env import get_image_from_obs_dict

    def setup(engine, envs, seeds):
        seeds = seeds or list(range(len(envs)))
        obs, tasks = [], []
        for env, seed in zip(envs, seeds):
            o, _ = env.reset(seed=seed)
            obs.append(o)
            tasks.append(env.get_language_instruction())
        engine.reset(tasks)
        if getattr(engine, "score_fn_factory", None) is not None:
            engine.score_fn = engine.score_fn_factory(envs)
        return {"obs": obs, "done": np.zeros(len(envs), bool),
                "success": np.zeros(len(envs), bool),
                "steps": np.zeros(len(envs), np.int32)}

    def inputs(state, envs):
        imgs = np.stack([get_image_from_obs_dict(env, o)
                         for env, o in zip(envs, state["obs"])])
        props = np.stack([adapter.preprocess_proprio({"agent": o["agent"]})
                          for o in state["obs"]]).astype(np.float32)
        return imgs, props

    def advance(state, envs, actions, t, engine):
        for e, env in enumerate(envs):
            if state["done"][e]:
                continue
            o, r, d, trunc, info = env.step(actions[e])
            state["obs"][e] = o
            state["steps"][e] = t + 1
            if d:
                state["done"][e] = state["success"][e] = True
            elif trunc:
                state["done"][e] = True
            if state["done"][e]:
                engine.mark_done(e)   # freeze its history/instruction state

    sa = setup(engine_a, envs_a, seeds_a)
    sb = setup(engine_b, envs_b, seeds_b)
    actions_b = None
    for t in range(max_steps):
        ra = engine_a.step_async(*inputs(sa, envs_a))
        if actions_b is not None:               # host work under A's step
            advance(sb, envs_b, actions_b, t - 1, engine_b)
        actions_a = ra()
        rb = engine_b.step_async(*inputs(sb, envs_b))
        advance(sa, envs_a, actions_a, t, engine_a)  # host work under B's step
        actions_b = rb()
        if sa["done"].all() and sb["done"].all():
            break
    if actions_b is not None and not sb["done"].all():
        advance(sb, envs_b, actions_b, t, engine_b)

    success = np.concatenate([sa["success"], sb["success"]])
    return {
        "success": success.tolist(),
        "success_rate": float(success.mean()),
        "steps": np.concatenate([sa["steps"], sb["steps"]]).tolist(),
        "selected_instructions": (engine_a.selected_instructions
                                  + engine_b.selected_instructions),
    }


def evaluate_batched(engine: BatchedCoVerEngine, envs: Sequence,
                     adapter, max_steps: int = 150,
                     seeds: Optional[Sequence[int]] = None) -> Dict:
    """Run E environments to completion in lockstep; finished envs keep
    receiving actions (ignored) until all are done or max_steps."""
    from cover_vla_tpu_torch.eval.fake_env import get_image_from_obs_dict

    e_count = len(envs)
    seeds = seeds or list(range(e_count))
    obs = []
    tasks = []
    for env, seed in zip(envs, seeds):
        o, _ = env.reset(seed=seed)
        obs.append(o)
        tasks.append(env.get_language_instruction())
    engine.reset(tasks)
    # injected-score selection: bind the external scorer to THIS cohort's
    # envs (e.g. the privileged progress oracle closes over the live envs)
    if getattr(engine, "score_fn_factory", None) is not None:
        engine.score_fn = engine.score_fn_factory(envs)

    done = np.zeros(e_count, bool)
    success = np.zeros(e_count, bool)
    steps = np.zeros(e_count, np.int32)
    for t in range(max_steps):
        imgs = np.stack([get_image_from_obs_dict(env, o)
                         for env, o in zip(envs, obs)])
        proprios = np.stack([
            adapter.preprocess_proprio({"agent": o["agent"]})
            for o in obs]).astype(np.float32)
        actions = engine.step(imgs, proprios)
        for e, env in enumerate(envs):
            if done[e]:
                continue
            o, r, d, trunc, info = env.step(actions[e])
            obs[e] = o
            steps[e] = t + 1
            if d:
                done[e] = success[e] = True
            elif trunc:
                done[e] = True
            if done[e]:
                engine.mark_done(e)
        if done.all():
            break

    return {
        "success": success.tolist(),
        "success_rate": float(success.mean()),
        "steps": steps.tolist(),
        "selected_instructions": engine.selected_instructions,
    }
