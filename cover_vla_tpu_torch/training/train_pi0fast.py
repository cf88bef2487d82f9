"""pi0-FAST training: teacher-forced CE over FAST action tokens.

The host prepares the token batch (prompt build, then DCT+BPE action
tokenization, `make_fast_batch`); the step differentiates
`pi0fast.token_ce_loss` with respect to every leaf of the tree and applies
the optimizer of `train_pi0.make_optimizer` in place. Sharding over
several devices waits for ROADMAP A.4: every `mesh=` argument raises.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from cover_vla_tpu_torch.data.fast_tokenizer import (
    FastActionTokenizer, normalize_actions_minmax)
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import pi0fast
from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.training import optim
from cover_vla_tpu_torch.training.train_pi0 import _no_mesh
from cover_vla_tpu_torch.utils.tree import flatten


class FastTrainState(NamedTuple):
    params: ParamTree
    opt_state: dict
    step: torch.Tensor      # 0-d int32, on the CPU


def make_fast_batch(frames: Dict, text_tokenizer,
                    cfg: pi0fast.Pi0FastConfig,
                    fast_tokenizer: Optional[FastActionTokenizer] = None
                    ) -> Dict[str, np.ndarray]:
    """Collated frames -> token_ce_loss batch (numpy).

    frames: image uint8[B,H,W,3] (or [B,n,H,W,3]), state [B,<=32],
    actions [B,chunk,D], task list[str]. The action chunk is min-max
    normalised per sample, DCT+BPE tokenized, mapped into the tail of the
    PaliGemma vocabulary, and appended to the prompt tokens with an eos;
    suffix_mask marks the causal action-token span the CE loss trains
    on."""
    fast = fast_tokenizer or FastActionTokenizer(
        time_horizon=cfg.chunk_size,
        action_dim=np.asarray(frames["actions"]).shape[-1])
    images = np.asarray(frames["image"], np.float32) / 255.0 * 2.0 - 1.0
    if images.ndim == 4:
        images = images[:, None]
    state = np.asarray(frames["state"], np.float32)
    actions = np.asarray(frames["actions"], np.float64)

    prompts = pi0fast.build_prompts(state, list(frames["task"]))
    ptoks, pmasks = text_tokenizer.encode_batch(prompts,
                                                cfg.max_input_seq_len)
    act_tok_lists = fast.encode(normalize_actions_minmax(actions))

    b, t = ptoks.shape
    tokens = np.full((b, t), cfg.pad_token_id, np.int32)
    pad_mask = np.zeros((b, t), bool)
    suffix_mask = np.zeros((b, t), bool)
    for i in range(b):
        p = ptoks[i][pmasks[i]].tolist()
        a = pi0fast.act_tokens_to_paligemma(
            np.asarray(act_tok_lists[i], np.int64), cfg).tolist()
        seq = (p + a + [cfg.eos_token_id])[:t]
        tokens[i, :len(seq)] = seq
        pad_mask[i, :len(seq)] = True
        suffix_mask[i, len(p):len(seq)] = True

    return {
        "images": images.astype(np.float32),
        "img_masks": np.ones((b, images.shape[1]), bool),
        "tokens": tokens,
        "pad_mask": pad_mask,
        "suffix_mask": suffix_mask,
    }


def loss_fn(params, cfg: pi0fast.Pi0FastConfig, batch
            ) -> Tuple[torch.Tensor, Dict]:
    loss = pi0fast.token_ce_loss(
        params, cfg, batch["images"], batch["img_masks"], batch["tokens"],
        batch["pad_mask"], batch["suffix_mask"])
    return loss, {"loss": loss}


def make_train_step(cfg: pi0fast.Pi0FastConfig,
                    tx: optim.GradientTransformation, mesh=None):
    """Step over every leaf of the tree: step(state, batch) -> (state,
    {"loss"})."""
    _no_mesh(mesh)

    def train_step(state: FastTrainState, batch):
        loss, _, _, opt_state = optim.grad_step(
            tx, state.opt_state, flatten(state.params),
            lambda: loss_fn(state.params, cfg, batch))
        return FastTrainState(state.params, opt_state,
                              state.step + 1), {"loss": loss}

    return train_step


def init_train_state(seed: int, cfg: pi0fast.Pi0FastConfig, tx, mesh=None,
                     device=None) -> FastTrainState:
    """A random pi0-FAST on `device` (CUDA unless given), every leaf
    trainable, and its optimizer state."""
    _no_mesh(mesh)
    params = pi0fast.init_pi0fast(seed, cfg, device=resolve_device(device))
    leaves = {k: p.requires_grad_(True) for k, p in flatten(params).items()}
    return FastTrainState(params, tx.init(leaves), optim.counter())
