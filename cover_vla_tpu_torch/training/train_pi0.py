"""pi0 finetuning: freeze masks, the optimizers, the flow matching loss,
and the train steps over a full or a partitioned state, on one device or
FSDP-sharded over a ('dp', 'fsdp') mesh of processes.

The counterpart of INT-ACT's BaseTrainer: bf16 weights with the
optimizer's moments in each leaf's dtype (AdamW) or int8 (AdamW 8-bit),
gradient accumulation, cosine-warmup AdamW, frozen parameter masks
(freeze the vision encoder / train the expert only). A step updates its
state's tensors in place and returns the state with its new optimizer
state and step count; the trainable leaves carry requires_grad=True and
the frozen ones get no gradient buffer (the partitioned state: no
moments either).

With `mesh=` (`parallel.make_mesh`) the parameters and the optimizer
state are sharded at rest (`parallel.mesh`: each rank owns a flat,
block-aligned range of every large leaf). A step takes the GLOBAL batch,
the same on every rank, and draws the noise and flow times for all of its
rows before taking this rank's rows, so a W-rank step is the 1-rank step
up to the order of the reductions. It gathers the whole tree, computes the
loss on the rank's rows, reduce-scatters the gradients in fp32 over
'fsdp', averages them over 'dp', clips by the global norm over every
shard and updates the rank's shards in place.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Tuple

import torch

from cover_vla_tpu_torch.configs import Pi0Config
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import pi0
from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.ops.sampling import sample_flow_time, sample_noise
from cover_vla_tpu_torch.parallel.mesh import (
    batch_sharding, fsdp_sharding, gather_params, mean_over_mesh,
    norm_counts, reduce_gradients, shard_params, shard_plan)
from cover_vla_tpu_torch.training import optim
from cover_vla_tpu_torch.utils.tree import flatten


class TrainState(NamedTuple):
    params: ParamTree
    opt_state: dict
    step: torch.Tensor      # 0-d int32, on the CPU


class PartitionedTrainState(NamedTuple):
    """The full parameter tree with an optimizer state over ONLY the
    trainable leaves: frozen weights get no gradient buffers and no
    moments."""
    params: ParamTree
    opt_state: dict
    step: torch.Tensor


def freeze_mask(params, train_expert_only: bool = True,
                freeze_vision: bool = True,
                train_state_proj: bool = True) -> dict:
    """A tree of bools mirroring `params`, True = trainable (the pi0
    freeze flags)."""
    def rule(top: str) -> bool:
        if top == "vision" and (freeze_vision or train_expert_only):
            return False
        if top in ("paligemma", "mm_proj") and train_expert_only:
            return False
        if top == "state_proj":
            return train_state_proj
        return True

    def fill(tree, value):
        return {k: fill(tree[k], value)
                if isinstance(tree[k], (Mapping, ParamTree)) else value
                for k in tree}

    return {k: fill(params[k], rule(k))
            if isinstance(params[k], (Mapping, ParamTree)) else rule(k)
            for k in params}


def make_optimizer(lr_schedule, mask=None, optimizer: str = "adamw",
                   accumulate_steps: int = 1,
                   **kw) -> optim.GradientTransformation:
    """optimizer: "adamw" | "adamw_8bit" (block-quantised moments, the
    bnb AdamW8bit counterpart). With `mask` (a `freeze_mask` tree),
    frozen leaves get zero updates."""
    if optimizer == "adamw_8bit":
        from cover_vla_tpu_torch.training.quantized_optim import adamw_8bit
        tx = optim.chain(optim.clip_by_global_norm(kw.pop("grad_clip", 1.0)),
                         adamw_8bit(lr_schedule, **kw))
        if accumulate_steps > 1:
            tx = optim.multi_steps(tx, accumulate_steps)
    elif optimizer == "adamw":
        tx = optim.make_adamw(lr_schedule, accumulate_steps=accumulate_steps,
                              **kw)
    else:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if mask is not None:
        tx = optim.masked(tx, flatten(mask))
    return tx


def loss_fn(params, cfg: Pi0Config, generator: Optional[torch.Generator],
            batch: Dict[str, torch.Tensor], noise=None, time=None
            ) -> Tuple[torch.Tensor, Dict]:
    """batch: images [B,n,H,W,3], img_masks [B,n], lang_tokens [B,T],
    lang_masks [B,T], state [B,32], actions [B,chunk,32], optional
    actions_is_pad bool[B, chunk] (padded steps count as zero loss in the
    mean over every element)."""
    losses = pi0.flow_matching_loss(
        params, cfg, batch["images"], batch["img_masks"],
        batch["lang_tokens"], batch["lang_masks"], batch["state"],
        batch["actions"], noise=noise, time=time, generator=generator)
    if "actions_is_pad" in batch:
        losses = losses * (~batch["actions_is_pad"].bool())[..., None]
    loss = losses.mean()
    return loss, {"loss": loss}


def sharded_grad_step(state, tx, names, mesh, loss_on) -> tuple:
    """One FSDP optimizer step of a sharded state over the leaves `names`:
    gather the whole tree, differentiate `loss_on(params) -> (loss, aux)`
    (this rank's rows) with respect to those leaves, reduce the gradients
    (`parallel.mesh.reduce_gradients`), update this rank's shards in place
    under the sharded global norm. Returns (new optimizer state, the
    loss's mean over the mesh, the global gradient norm)."""
    plan = shard_plan(state.params)
    full = gather_params(state.params)
    leaves = flatten(full)
    loss, _, grads = optim.value_and_grad(
        {k: leaves[k] for k in names}, lambda: loss_on(full))
    del full, leaves
    grads = reduce_gradients(grads, plan, mesh)
    shards = flatten(state.params)
    with optim.sharded_norm(norm_counts(plan, names), mesh.get_group("fsdp")):
        opt_state = optim.update_in_place(tx, state.opt_state, grads,
                                          {k: shards[k] for k in names})
        norm = optim.global_norm(grads)
    return opt_state, mean_over_mesh(loss, mesh), norm


def _step(state, tx, cfg: Pi0Config, names, generator, batch, noise, time,
          mesh=None):
    if mesh is None:
        leaves = flatten(state.params)
        # a leaf the loss does not reach (PaliGemma's final norm) gets zeros
        loss, _, grads, opt_state = optim.grad_step(
            tx, state.opt_state, {k: leaves[k] for k in names},
            lambda: loss_fn(state.params, cfg, generator, batch, noise, time))
        norm = optim.global_norm(grads)
    else:
        # the global batch's draws, in flow_matching_loss's order, then
        # this rank's rows of everything
        actions = batch["actions"]
        if noise is None:
            noise = sample_noise(actions.shape, generator=generator,
                                 device=actions.device)
        if time is None:
            time = sample_flow_time(actions.shape[0], generator=generator,
                                    device=actions.device)
        rows = batch_sharding(mesh)
        local = {k: rows(v) for k, v in batch.items()}
        noise, time = rows(noise), rows(time)
        opt_state, loss, norm = sharded_grad_step(
            state, tx, names, mesh,
            lambda p: loss_fn(p, cfg, None, local, noise, time))
    metrics = {"loss": loss, "grad_norm": norm}
    return type(state)(state.params, opt_state, state.step + 1), metrics


def make_partitioned_train_step(cfg: Pi0Config,
                                tx: optim.GradientTransformation, mask,
                                mesh=None):
    """Train step differentiating only the mask=True leaves; `tx` is a
    plain optimizer over those leaves (no freeze wrapper needed).

    step(state, generator, batch, noise=None, time=None) -> (state,
    {"loss", "grad_norm"}), grad_norm before clipping. noise and time are
    drawn from `generator` unless given (for the whole batch). With `mesh`
    the state is a sharded one and the batch global."""
    names = [k for k, m in flatten(mask).items() if m]

    def train_step(state: PartitionedTrainState, generator, batch,
                   noise=None, time=None):
        return _step(state, tx, cfg, names, generator, batch, noise, time,
                     mesh)

    return train_step


def _train_leaves(params, mask) -> Dict[str, torch.Tensor]:
    m = flatten(mask)
    return {k: p.requires_grad_(True) for k, p in flatten(params).items()
            if m[k]}


def init_partitioned_state(params, tx, mask,
                           mesh=None) -> PartitionedTrainState:
    """A partitioned state of `params`; with `mesh`, of their shards (the
    parameters are copied)."""
    if mesh is None:
        return PartitionedTrainState(
            params, tx.init(_train_leaves(params, mask)), optim.counter())
    params = shard_params(params, fsdp_sharding(params, mesh))
    m = flatten(mask)
    return PartitionedTrainState(
        params, tx.init({k: v for k, v in flatten(params).items() if m[k]}),
        optim.counter())


def init_partitioned_train_state(seed: int, cfg: Pi0Config, tx, mask=None,
                                 mesh=None, device=None
                                 ) -> Tuple[PartitionedTrainState, dict]:
    """A random pi0 on `device` (CUDA unless given) with the optimizer
    state over its trainable leaves (expert only by default), the whole
    tree and the state sharded over `mesh` when given (frozen leaves carry
    no gradients and no moments at any mesh shape); returns (state,
    mask)."""
    params = pi0.init_pi0(seed, cfg, device=resolve_device(device))
    if mask is None:
        mask = freeze_mask(params, train_expert_only=True)
    return init_partitioned_state(params, tx, mask, mesh), mask


def make_train_step(cfg: Pi0Config, tx: optim.GradientTransformation,
                    mesh=None):
    """Train step over every leaf (a freeze is `make_optimizer`'s mask);
    the same call as `make_partitioned_train_step`'s, sharded with
    `mesh`."""

    def train_step(state: TrainState, generator, batch, noise=None,
                   time=None):
        return _step(state, tx, cfg, list(flatten(state.params)), generator,
                     batch, noise, time, mesh)

    return train_step


def init_train_state(seed: int, cfg: Pi0Config, tx, mesh=None,
                     device=None) -> TrainState:
    """A random pi0 on `device` (CUDA unless given), every leaf
    trainable, and its optimizer state; sharded over `mesh` when given."""
    params = pi0.init_pi0(seed, cfg, device=resolve_device(device))
    if mesh is not None:
        params = shard_params(params, fsdp_sharding(params, mesh))
        return TrainState(params, tx.init(flatten(params)), optim.counter())
    leaves = {k: p.requires_grad_(True) for k, p in flatten(params).items()}
    return TrainState(params, tx.init(leaves), optim.counter())


def shard_batch(batch, mesh) -> dict:
    """This rank's rows of every entry of a global batch (split over both
    mesh dims); a batch that does not divide raises ValueError."""
    rows = batch_sharding(mesh)
    return {k: rows(v) for k, v in batch.items()}
