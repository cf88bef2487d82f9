"""pi0-FAST training: teacher-forced CE over FAST action tokens.

The host prepares the token batch (prompt build, then DCT+BPE action
tokenization, `make_fast_batch`); the step differentiates
`pi0fast.token_ce_loss` with respect to every leaf of the tree and applies
the optimizer of `train_pi0.make_optimizer` in place. With `mesh=` the
tree and its optimizer state are FSDP-sharded (`train_pi0`'s sharded
step): a step takes the global batch, and each rank divides its rows'
summed token losses by the global batch's count, so the mean over ranks is
the global token mean.
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
from cover_vla_tpu_torch.parallel.mesh import (
    fsdp_sharding, mesh_size, shard_params)
from cover_vla_tpu_torch.training import optim
from cover_vla_tpu_torch.training.train_pi0 import (
    shard_batch, sharded_grad_step)
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


def loss_fn(params, cfg: pi0fast.Pi0FastConfig, batch, weight_total=None
            ) -> Tuple[torch.Tensor, Dict]:
    loss = pi0fast.token_ce_loss(
        params, cfg, batch["images"], batch["img_masks"], batch["tokens"],
        batch["pad_mask"], batch["suffix_mask"], weight_total)
    return loss, {"loss": loss}


def make_train_step(cfg: pi0fast.Pi0FastConfig,
                    tx: optim.GradientTransformation, mesh=None):
    """Step over every leaf of the tree: step(state, batch) -> (state,
    {"loss"}); with `mesh` the state is a sharded one and the batch
    global."""

    def train_step(state: FastTrainState, batch):
        if mesh is None:
            loss, _, _, opt_state = optim.grad_step(
                tx, state.opt_state, flatten(state.params),
                lambda: loss_fn(state.params, cfg, batch))
        else:
            weight = (batch["suffix_mask"][:, 1:]
                      & batch["pad_mask"][:, 1:]).float()
            total = weight.sum().clamp_min(1.0)
            n = mesh_size(mesh)
            local = shard_batch(batch, mesh)

            def loss_on(params):
                # n x this rank's share: the mean over ranks is the loss
                loss, aux = loss_fn(params, cfg, local, total)
                return loss * n, aux

            opt_state, loss, _ = sharded_grad_step(
                state, tx, list(flatten(state.params)), mesh, loss_on)
        return FastTrainState(state.params, opt_state,
                              state.step + 1), {"loss": loss}

    return train_step


def init_train_state(seed: int, cfg: pi0fast.Pi0FastConfig, tx, mesh=None,
                     device=None) -> FastTrainState:
    """A random pi0-FAST on `device` (CUDA unless given), every leaf
    trainable, and its optimizer state; sharded over `mesh` when given."""
    params = pi0fast.init_pi0fast(seed, cfg, device=resolve_device(device))
    if mesh is not None:
        params = shard_params(params, fsdp_sharding(params, mesh))
        return FastTrainState(params, tx.init(flatten(params)),
                              optim.counter())
    leaves = {k: p.requires_grad_(True) for k, p in flatten(params).items()}
    return FastTrainState(params, tx.init(leaves), optim.counter())
