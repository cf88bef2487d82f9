"""Host-side episode loop around the on-device verified step.

Owns the small per-episode state the device program is stateless over:
the action-history ring, the current instruction (which can switch to a
rephrase mid-episode), the remaining actions of the selected chunk, and
prompt tokenization.

Per control tick the host does O(1) numpy work; the device is invoked once
every `chunk_size` ticks and returns only the winner's chunk + metadata.
The flow's noise comes from a `torch.Generator` on the engine's device,
seeded from `seed`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from cover_vla_tpu_torch.configs import CoVerConfig, Pi0Config, VerifierConfig
from cover_vla_tpu_torch.data.stats import DatasetStatistics
from cover_vla_tpu_torch.data.tokenizer import (
    Tokenizer, make_policy_tokenizer, make_verifier_tokenizer)
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.engine.verified_step import make_verified_step


@dataclass
class StepRecord:
    """Per-verified-step diagnostics (the reference's episode_data fields)."""
    t: int
    max_score: float
    used_stage2: bool
    winner_idx: int
    selected_instruction: str
    execute_action: np.ndarray


class CoVerEngine:
    def __init__(self, policy_params, verifier_params,
                 pcfg: Pi0Config, vcfg: VerifierConfig, ccfg: CoVerConfig,
                 stats: Optional[DatasetStatistics] = None,
                 policy_tokenizer: Optional[Tokenizer] = None,
                 verifier_tokenizer: Optional[Tokenizer] = None,
                 rephrases: Optional[Dict[str, List[str]]] = None,
                 seed: int = 0, device=None):
        """The parameters must live on `device` (CUDA unless given)."""
        self.device = resolve_device(device)
        self.policy_params = policy_params
        self.verifier_params = verifier_params
        self.pcfg, self.vcfg, self.ccfg = pcfg, vcfg, ccfg
        self.stats = stats or DatasetStatistics.from_json()
        self.policy_tok = policy_tokenizer or make_policy_tokenizer(
            pcfg.paligemma.vocab_size)
        self.verifier_tok = verifier_tokenizer or make_verifier_tokenizer(
            vcfg.text.vocab_size)
        self.rephrases = rephrases or {}
        self._step_fn = make_verified_step(pcfg, vcfg, ccfg, self.stats,
                                           device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.reset("")

    # ------------------------------------------------------------------

    def reset(self, task: str):
        self.task = task
        self.original_task = task
        self._tick = 0
        self._history = np.zeros((self.ccfg.max_history, 7), np.float32)
        self._history_len = 0
        self._exec_queue: List[np.ndarray] = []
        self._verif_queue: List[np.ndarray] = []
        self._raw_grip_queue: List[float] = []
        self.last_raw_gripper: float = 1.0  # raw [0,1] gripper of the tick
        self.records: List[StepRecord] = []

    def _prompts(self) -> List[str]:
        """[current task] + (K-1) rephrases of the ORIGINAL task."""
        k = self.ccfg.n_rephrases
        reph = self.rephrases.get(self.original_task, [])
        return ([self.task] + list(reph))[:k] + \
            [self.task] * max(0, k - 1 - len(reph))

    def _push_history(self, verifier_action: np.ndarray):
        self._history = np.roll(self._history, -1, axis=0)
        self._history[-1] = verifier_action
        self._history_len = min(self._history_len + 1, self.ccfg.max_history)

    # ------------------------------------------------------------------

    def step(self, raw_image: np.ndarray, proprio7: np.ndarray) -> np.ndarray:
        """One control tick.

        raw_image: uint8[H, W, 3]; proprio7: fp32[7] raw euler-format
        proprio (use BridgeSimplerAdapter.preprocess_proprio upstream).
        Returns the execution-format action [7] for the simulator.
        """
        chunk = self.pcfg.chunk_size
        if self._tick % chunk == 0:
            prompts = self._prompts()
            lang_tokens, lang_masks = self.policy_tok.encode_batch(
                prompts, self.pcfg.tokenizer_max_length)
            vtoks, _ = self.verifier_tok.encode_batch(
                [self.task], self.vcfg.text.context_length)

            res = self._step_fn(
                self.policy_params, self.verifier_params,
                np.ascontiguousarray(raw_image),
                np.asarray(proprio7, np.float32),
                lang_tokens, lang_masks, vtoks[0],
                self._history, np.int32(self._history_len),
                generator=self._generator)

            exec_chunk = res.exec_chunk.cpu().numpy()
            verif_chunk = res.verifier_chunk.cpu().numpy()
            raw_grip = res.raw_gripper.cpu().numpy()
            self._exec_queue = [exec_chunk[i] for i in range(1, chunk)]
            self._verif_queue = [verif_chunk[i] for i in range(1, chunk)]
            self._raw_grip_queue = [float(raw_grip[i])
                                    for i in range(1, chunk)]
            self.last_raw_gripper = float(raw_grip[0])

            winner_group = int(res.winner_group)
            used_stage2 = bool(res.used_stage2)
            if used_stage2:
                self.task = prompts[winner_group]
            self.records.append(StepRecord(
                t=self._tick, max_score=float(res.max_score),
                used_stage2=used_stage2, winner_idx=int(res.winner_idx),
                selected_instruction=self.task,
                execute_action=exec_chunk[0].copy()))
            self._push_history(verif_chunk[0])
            action = exec_chunk[0]
        else:
            action = self._exec_queue.pop(0)
            self.last_raw_gripper = self._raw_grip_queue.pop(0)
            self._push_history(self._verif_queue.pop(0))
        self._tick += 1
        return np.asarray(action)
