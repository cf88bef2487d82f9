"""Policy wrappers served over the websocket RPC.

Preprocess obs -> model -> postprocess, exposed through the BasePolicy
verbs. Two wrappers:

  * `Pi0PolicyWrapper`: plain pi0 action-chunk inference with a host-side
    action queue.
  * `CoVerPolicyWrapper`: the full verified engine behind the same verbs.

Both take a serving mode `quantize`: "none", "int8" (w8a8 policy: both
Gemma stacks and the SigLIP tower) or "int8_full" (the verifier's ViT
backbone too, where there is one). `switch_model` loads any format of
`convert/loaders.py` onto the wrapper's device and re-applies the
transform to a switched policy; the served parameters change only after a
successful load.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from cover_vla_tpu_torch.configs import Pi0Config
from cover_vla_tpu_torch.convert.loaders import (
    load_policy_params, load_verifier_params)
from cover_vla_tpu_torch.data.tokenizer import Tokenizer, make_policy_tokenizer
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.engine import CoVerEngine
from cover_vla_tpu_torch.eval.adapters import BridgeSimplerAdapter
from cover_vla_tpu_torch.models import pi0
from cover_vla_tpu_torch.ops import quant

QUANTIZE_MODES = ("none", "int8", "int8_full")


def _check_mode(quantize: str) -> None:
    if quantize not in QUANTIZE_MODES:
        raise ValueError(f"unknown quantize mode {quantize!r} "
                         f"({' | '.join(QUANTIZE_MODES)})")


class Pi0PolicyWrapper:
    """obs {image uint8[H,W,3], state raw, task str} -> {actions [7]},
    one action of the current chunk per call. The parameters must live on
    `device` (CUDA unless given); the flow's noise comes from a
    `torch.Generator` there, seeded from `seed`."""

    def __init__(self, params, cfg: Pi0Config,
                 tokenizer: Optional[Tokenizer] = None,
                 adapter: Optional[BridgeSimplerAdapter] = None,
                 noise_std: float = 1.0, seed: int = 0,
                 quantize: str = "none", device=None):
        _check_mode(quantize)
        self.device = resolve_device(device)
        self.quantize = quantize
        self.params = self._maybe_quantize(params)
        self.cfg = cfg
        self.tok = tokenizer or make_policy_tokenizer(cfg.paligemma.vocab_size)
        # the default adapter resizes to the POLICY's input size
        self.adapter = adapter or BridgeSimplerAdapter(
            image_size=(cfg.vision.image_size, cfg.vision.image_size))
        self.noise_std = noise_std
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self.reset()

    def _maybe_quantize(self, params):
        """The serving-time int8 transform (ops/quant.py) for quantize !=
        'none'; re-applied on every switch_model."""
        if self.quantize == "none":
            return params
        return quant.quantize_pi0_policy(params)

    def reset(self) -> None:
        self._queue: List[np.ndarray] = []
        self.adapter.reset()

    def switch_model(self, path: str) -> None:
        """Swap the served checkpoint (any format of convert/loaders.py):
        the parameters change only after a successful load (and
        quantization), then the queue and adapter reset."""
        self.params = self._maybe_quantize(
            load_policy_params(path, self.cfg, device=self.device))
        self.reset()

    @torch.no_grad()
    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        if not self._queue:
            pre = self.adapter.preprocess({
                "observation.images.top": np.asarray(obs["image"], np.uint8),
                "observation.state": obs["state"],
                "task": obs.get("task", ""),
            })
            toks, masks = self.tok.encode_batch(
                pre["task"], self.cfg.tokenizer_max_length)
            state = np.zeros((1, self.cfg.max_state_dim), np.float32)
            state[:, :pre["observation.state"].shape[1]] = \
                pre["observation.state"]
            dev = self.device
            actions = pi0.sample_actions(
                self.params, self.cfg,
                torch.as_tensor(pre["observation.images.top"][:, None],
                                device=dev),
                torch.ones((1, 1), dtype=torch.bool, device=dev),
                torch.as_tensor(np.asarray(toks), device=dev),
                torch.as_tensor(np.asarray(masks), device=dev),
                torch.as_tensor(state, device=dev), num_candidates=1,
                noise_std=self.noise_std, generator=self._generator)
            raw_chunk = actions[0, 0, :, :7].cpu().numpy()
            self._queue = [a for a in self.adapter.postprocess(raw_chunk)]
        return {"actions": np.asarray(self._queue.pop(0))}


class CoVerPolicyWrapper:
    """The verified engine behind the same RPC verbs. obs may also carry
    'reset_task' to (re)bind the instruction. int8 quantizes the engine's
    policy, int8_full the verifier's ViT backbone as well."""

    def __init__(self, engine: CoVerEngine, quantize: str = "none"):
        _check_mode(quantize)
        self.engine = engine
        self.quantize = quantize
        self.adapter = BridgeSimplerAdapter()
        if quantize != "none":
            engine.policy_params = quant.quantize_pi0_policy(
                engine.policy_params)
        if quantize == "int8_full":
            engine.verifier_params = quant.quantize_verifier(
                engine.verifier_params)

    def reset(self) -> None:
        self.engine.reset(self.engine.original_task)

    def switch_model(self, path: str) -> None:
        """Swap the engine's POLICY checkpoint (the verifier stays); a
        "verifier:<path>" prefix switches the verifier ensemble instead (a
        heads-only merged .pt reuses the current backbone). Parameters
        change only after a successful load. Only the policy is
        re-quantized in the int8 modes: under int8_full the backbone a
        heads-only .pt reuses is already quantized, and a verifier
        checkpoint that brings its own backbone is served as loaded (as in
        the JAX package)."""
        eng = self.engine
        if path.startswith("verifier:"):
            eng.verifier_params = load_verifier_params(
                path[len("verifier:"):], eng.vcfg,
                backbone_params=eng.verifier_params.get("backbone"),
                device=eng.device)
        else:
            pp = load_policy_params(path, eng.pcfg, device=eng.device)
            if self.quantize != "none":
                pp = quant.quantize_pi0_policy(pp)
            eng.policy_params = pp
        self.reset()

    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        if "reset_task" in obs:
            self.engine.reset(str(obs["reset_task"]))
        proprio = self.adapter.preprocess_proprio(
            {"agent": obs["agent"]}) if "agent" in obs else \
            np.asarray(obs["proprio"], np.float32)
        action = self.engine.step(np.asarray(obs["image"], np.uint8),
                                  np.asarray(proprio, np.float32))
        rec = self.engine.records[-1] if self.engine.records else None
        return {
            "actions": action,
            "score": rec.max_score if rec else None,
            "instruction": self.engine.task,
        }
