"""Verifier contrastive training: symmetric InfoNCE over (image+text,
trajectory) pairs with a frozen SigLIP2 backbone and trainable heads, the
ensemble step, from-scratch training of the whole verifier, and the
candidate-ranking objectives.

The members' heads carry the member axis first (`models/verifier.py`),
so every loss here is computed for all M members in one batched call and
returns an [M] vector; the ensemble objective is its mean, so each
member's gradient is 1/M of its own loss's. Metrics are [M] vectors from
the losses and member means from the steps.

The frozen backbone's features are computed under `torch.no_grad()` (the
reference's stop_gradient): only there may the towers run kernel K2 (a
kernel config, `configs.fast_verifier_config`). A step that
differentiates the backbone (`make_full_train_step`, or
`train_backbone=True`) under a kernel config raises through the kernel
wrapper's autograd refusal. A step updates its state's tensors in place
and returns the state with its new optimizer state and step count.

With `mesh=` the ensemble step is the reference's NCCL DDP: it takes the
global batch, each rank computes the symmetric InfoNCE over its LOCAL rows
(local negatives: DDP never gathers logits across ranks), and gradients
and metrics are averaged over the ranks; members and optimizer state stay
replicated. A W-rank step is therefore not the 1-rank step.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Tuple

import torch

from cover_vla_tpu_torch.configs import VerifierConfig
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import verifier
from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.parallel.mesh import batch_sharding, mean_over_mesh
from cover_vla_tpu_torch.training import optim
from cover_vla_tpu_torch.utils.tree import flatten

Metrics = Dict[str, torch.Tensor]


class VerifierTrainState(NamedTuple):
    members: ParamTree      # trainable heads, member axis first
    opt_state: dict
    step: torch.Tensor      # 0-d int32, on the CPU


class FullVerifierTrainState(NamedTuple):
    """Joint state when the backbone trains too: params holds the whole
    verifier tree ({"backbone", "members"})."""
    params: ParamTree
    opt_state: dict
    step: torch.Tensor


class VerifierCheckpoint(NamedTuple):
    """What the `train_verifier` role saves and resumes from: the members,
    their optimizer state and the frozen backbone."""
    members: ParamTree
    opt_state: dict
    backbone: ParamTree


# ---------------------------------------------------------------------------
# losses (every member at once: [M] losses, [M] metrics)
# ---------------------------------------------------------------------------


def _ce_int(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.softmax_cross_entropy_with_integer_labels over the last axis:
    log-sum-exp of the max-shifted logits minus the label's."""
    shifted = logits - logits.amax(dim=-1, keepdim=True).detach()
    label = shifted.gather(-1, labels.expand(logits.shape[:-1])[..., None])
    return torch.log(torch.exp(shifted).sum(dim=-1)) - label[..., 0]


def _scaled(members, it: torch.Tensor, ac: torch.Tensor,
            eq: str) -> torch.Tensor:
    """exp(logit_scale) * einsum(eq, it, ac), per member."""
    scale = torch.exp(members["logit_scale"])
    prod = torch.einsum(eq, it, ac)
    return scale.reshape(-1, *([1] * (prod.ndim - 1))) * prod


def _scale_metric(members) -> torch.Tensor:
    """The members' logit scales as the loss saw them: a copy, since a
    step then updates the parameter in place."""
    return members["logit_scale"].detach().clone()


def retrieval_metrics(logits: torch.Tensor, ks=(1, 5)) -> Metrics:
    """Top-k retrieval accuracy, image->action and action->image, of
    [..., B, B] logits (label i is column i): a row's rank counts the
    logits strictly above its label's, so ties count as hits."""
    out = {}
    for name, l in (("i2a", logits), ("a2i", logits.transpose(-1, -2))):
        diag = torch.diagonal(l, dim1=-2, dim2=-1)[..., None]
        ranks = (l > diag).sum(dim=-1)
        for k in ks:
            out[f"top{k}_{name}"] = (ranks < k).float().mean(dim=-1)
    return out


def info_nce_loss(members, cfg: VerifierConfig, feats,
                  action_histories: torch.Tensor
                  ) -> Tuple[torch.Tensor, Metrics]:
    """Symmetric InfoNCE of every member given the backbone's features:
    fp32 logits exp(logit_scale) * it @ ac^T [M, B, B], the mean of the
    row and column cross-entropies. Returns ([M] losses, [M] metrics)."""
    it = verifier.member_image_text_embed(members, cfg, feats)
    ac = verifier.member_action_embed(members, cfg, action_histories)
    logits = _scaled(members, it, ac, "mbd,mnd->mbn")
    labels = torch.arange(logits.shape[-1], device=logits.device)
    loss = 0.5 * (_ce_int(logits, labels).mean(dim=-1)
                  + _ce_int(logits.transpose(-1, -2), labels).mean(dim=-1))
    return loss, {"loss": loss, "logit_scale": _scale_metric(members),
                  **retrieval_metrics(logits)}


def _candidate_embeds(members, cfg: VerifierConfig, feats,
                      trajs: torch.Tensor):
    """(it [M, B, d], ac [M, B, N, d]) for candidates trajs [B, N, H, 7]."""
    it = verifier.member_image_text_embed(members, cfg, feats)
    b, n = trajs.shape[:2]
    ac = verifier.member_action_embed(members, cfg,
                                      trajs.reshape(b * n, *trajs.shape[2:]))
    return it, ac.reshape(ac.shape[0], b, n, -1)


def _pick_metrics(scores: torch.Tensor, qualities: torch.Tensor) -> Metrics:
    """rank_acc (the argmax pick is the best candidate) and regret (the
    quality lost by the pick), per member; scores [M, B, N]."""
    pick = scores.argmax(dim=-1)                                   # [M, B]
    q = qualities.expand(scores.shape)
    picked = q.gather(-1, pick[..., None])[..., 0]
    return {"rank_acc": (pick == qualities.argmax(dim=-1)).float().mean(-1),
            "regret": (q.amax(dim=-1) - picked).mean(dim=-1)}


def ranking_loss(members, cfg: VerifierConfig, feats, pos_traj: torch.Tensor,
                 neg_trajs: torch.Tensor) -> Tuple[torch.Tensor, Metrics]:
    """Candidate-ranking CE: the expert future must outscore M corrupted
    futures under the same frame and history (the decision the CoVer
    engine makes at every control step). pos_traj: [B, H, 7]; neg_trajs:
    [B, M, H, 7]."""
    trajs = torch.cat([pos_traj[:, None], neg_trajs], dim=1)
    it, ac = _candidate_embeds(members, cfg, feats, trajs)
    logits = _scaled(members, it, ac, "mbd,mbkd->mbk")
    zeros = torch.zeros((), dtype=torch.long, device=logits.device)
    loss = _ce_int(logits, zeros).mean(dim=-1)
    acc = (logits.argmax(dim=-1) == 0).float().mean(dim=-1)
    return loss, {"loss": loss, "rank_acc": acc,
                  "logit_scale": _scale_metric(members)}


def listwise_ranking_loss(members, cfg: VerifierConfig, feats,
                          cand_trajs: torch.Tensor, qualities: torch.Tensor,
                          tau: float = 1.0) -> Tuple[torch.Tensor, Metrics]:
    """Listwise candidate ranking: the scores of all N candidates of each
    state against soft targets softmax(q / tau). cand_trajs: [B, N, H, 7];
    qualities: [B, N]."""
    it, ac = _candidate_embeds(members, cfg, feats, cand_trajs)
    logits = _scaled(members, it, ac, "mbd,mbnd->mbn")
    targets = torch.softmax(qualities / tau, dim=-1)
    loss = -(targets * torch.log_softmax(logits, dim=-1)).sum(-1).mean(-1)
    return loss, {"loss": loss, **_pick_metrics(logits, qualities),
                  "logit_scale": _scale_metric(members)}


def quality_regression_loss(members, cfg: VerifierConfig, feats,
                            cand_trajs: torch.Tensor, qualities: torch.Tensor,
                            q_scale: float = 5.0
                            ) -> Tuple[torch.Tensor, Metrics]:
    """Dense distillation of a progress oracle into the verifier score:
    the MSE between every candidate's scaled-cosine score and its quality
    / q_scale. The scoring is unchanged, so the trained heads drop into the
    engine."""
    it, ac = _candidate_embeds(members, cfg, feats, cand_trajs)
    scores = _scaled(members, it, ac, "mbd,mbnd->mbn")
    loss = ((scores - qualities / q_scale) ** 2).mean(dim=(-2, -1))
    return loss, {"loss": loss, **_pick_metrics(scores, qualities),
                  "logit_scale": _scale_metric(members)}


# ---------------------------------------------------------------------------
# steps
# ---------------------------------------------------------------------------


def _features(params, cfg: VerifierConfig, batch, grad: bool):
    """The backbone's features; under no_grad unless the backbone trains."""
    with torch.set_grad_enabled(grad and torch.is_grad_enabled()):
        return verifier.extract_features(params, cfg, batch["images"],
                                         batch["text_tokens"])


def _mean_metrics(per_member: Metrics) -> Metrics:
    return {k: v.detach().mean() for k, v in per_member.items()}


def _update(state, tx, tree_name: str, loss_fn: Callable):
    """One optimizer step over every leaf of the state's `tree_name` tree;
    loss_fn() -> ([M] losses, [M] metrics). Returns (state, member-mean
    metrics with grad_norm, [M] metrics)."""
    def objective():
        losses, per_member = loss_fn()
        return losses.mean(), per_member

    tree = getattr(state, tree_name)
    _, per_member, grads, opt_state = optim.grad_step(
        tx, state.opt_state, flatten(tree), objective)
    metrics = _mean_metrics(per_member)
    metrics["grad_norm"] = optim.global_norm(grads)
    state = state._replace(opt_state=opt_state, step=state.step + 1)
    return state, metrics, per_member


def make_train_step(cfg: VerifierConfig, tx: optim.GradientTransformation,
                    member_idx: int = 0):
    """Step updating ONE member's heads (the others get zero gradients);
    the backbone is a frozen input. step(state, backbone, batch) ->
    (state, metrics of that member with grad_norm)."""
    def step(state: VerifierTrainState, backbone, batch):
        feats = _features({"backbone": backbone}, cfg, batch, grad=False)

        def loss_fn():
            one = verifier.member_slice(state.members, member_idx)
            return info_nce_loss(one, cfg, feats, batch["action_histories"])

        state, metrics, _ = _update(state, tx, "members", loss_fn)
        return state, metrics

    return step


def make_ensemble_train_step(cfg: VerifierConfig,
                             tx: optim.GradientTransformation, mesh=None):
    """Step updating ALL members at once (one batched pass over the
    member axis; member diversity comes from independent
    initialisations). The objective is the mean of the member losses.
    step(state, backbone, batch) -> (state, metrics): member means,
    `member_loss` [M] and `grad_norm`, the global norm before clipping.
    With `mesh`, the DDP step over the global batch (module docstring)."""

    def step(state: VerifierTrainState, backbone, batch):
        if mesh is not None:
            batch = shard_verifier_batch(batch, mesh)
        feats = _features({"backbone": backbone}, cfg, batch, grad=False)

        def loss_fn():
            return info_nce_loss(state.members, cfg, feats,
                                 batch["action_histories"])

        if mesh is None:
            state, metrics, per_member = _update(state, tx, "members",
                                                 loss_fn)
        else:
            state, metrics, per_member = _ddp_update(state, tx, mesh,
                                                     loss_fn)
        metrics["member_loss"] = per_member["loss"].detach()
        return state, metrics

    return step


def _ddp_update(state: VerifierTrainState, tx, mesh, loss_fn: Callable):
    """`_update` of the members with the gradients and the [M] metrics
    averaged over the mesh's ranks before the update: one fp32 all-reduce
    of them all, concatenated (DDP's bucket)."""
    def objective():
        losses, per_member = loss_fn()
        return losses.mean(), per_member

    leaves = flatten(state.members)
    _, per_member, grads = optim.value_and_grad(leaves, objective)
    parts = [t.detach().float().reshape(-1)
             for t in (*grads.values(), *per_member.values())]
    mean = mean_over_mesh(torch.cat(parts), mesh).split(
        [t.numel() for t in parts])
    grads = {k: m.view_as(g).to(g.dtype)
             for (k, g), m in zip(grads.items(), mean)}
    per_member = dict(zip(per_member, mean[len(grads):]))
    opt_state = optim.update_in_place(tx, state.opt_state, grads, leaves)
    metrics = _mean_metrics(per_member)
    metrics["grad_norm"] = optim.global_norm(grads)
    return (state._replace(opt_state=opt_state, step=state.step + 1),
            metrics, per_member)


def shard_verifier_batch(batch, mesh) -> dict:
    """This rank's rows of every array of a global batch; lists (the
    instructions) pass through."""
    rows = batch_sharding(mesh)
    return {k: v if isinstance(v, list) else rows(v)
            for k, v in batch.items()}


@torch.no_grad()
def ensemble_eval_metrics(members, cfg: VerifierConfig, backbone,
                          batch) -> Metrics:
    """Validation retrieval metrics averaged over members."""
    feats = verifier.extract_features({"backbone": backbone}, cfg,
                                      batch["images"], batch["text_tokens"])
    _, per_member = info_nce_loss(members, cfg, feats,
                                  batch["action_histories"])
    return _mean_metrics(per_member)


def _trainable(tree) -> None:
    for v in flatten(tree).values():
        v.requires_grad_(True)


def init_train_state(seed: int, cfg: VerifierConfig, tx,
                     num_members: int = 1, device=None
                     ) -> Tuple[ParamTree, VerifierTrainState]:
    """A random verifier on `device` (CUDA unless given). Returns (the
    frozen backbone, the trainable state over the members)."""
    params = verifier.init_verifier(seed, cfg, num_members,
                                    device=resolve_device(device))
    members = params["members"]
    _trainable(members)
    return params["backbone"], VerifierTrainState(
        members, tx.init(flatten(members)), optim.counter())


# ---------------------------------------------------------------------------
# From-scratch training (backbone unfrozen) and the ranking objectives
# ---------------------------------------------------------------------------


def _whole_tree_step(cfg: VerifierConfig, tx, train_backbone: bool,
                     member_loss: Callable):
    """Step over the whole verifier tree: member_loss(members, feats,
    batch) -> ([M] losses, [M] metrics). Without train_backbone the
    features come from under no_grad, the backbone's gradients are zero
    and its leaves still get the optimizer's update (weight decay), as
    the reference's stop_gradient gives."""
    def step(state: FullVerifierTrainState, batch):
        def loss_fn():
            feats = _features(state.params, cfg, batch, grad=train_backbone)
            return member_loss(state.params["members"], feats, batch)

        state, metrics, _ = _update(state, tx, "params", loss_fn)
        return state, metrics

    return step


def make_full_train_step(cfg: VerifierConfig,
                         tx: optim.GradientTransformation):
    """Contrastive step over the WHOLE verifier, backbone included (a
    frozen random tower collapses all images to near-identical features,
    so training from scratch needs backbone gradients).
    step(state, batch) -> (state, member-mean metrics with grad_norm)."""
    return _whole_tree_step(
        cfg, tx, True, lambda m, feats, batch: info_nce_loss(
            m, cfg, feats, batch["action_histories"]))


def init_full_train_state(seed: int, cfg: VerifierConfig, tx,
                          num_members: int = 1,
                          device=None) -> FullVerifierTrainState:
    params = verifier.init_verifier(seed, cfg, num_members,
                                    device=resolve_device(device))
    _trainable(params)
    return FullVerifierTrainState(params, tx.init(flatten(params)),
                                  optim.counter())


def make_ranking_train_step(cfg: VerifierConfig,
                            tx: optim.GradientTransformation,
                            train_backbone: bool = True):
    """Ranking step over the whole verifier (all members). batch: images
    [B,H,W,3], text_tokens [B,T], pos_traj [B,H,7], neg_trajs
    [B,M,H,7]."""
    return _whole_tree_step(
        cfg, tx, train_backbone, lambda m, feats, batch: ranking_loss(
            m, cfg, feats, batch["pos_traj"], batch["neg_trajs"]))


def make_listwise_train_step(cfg: VerifierConfig,
                             tx: optim.GradientTransformation,
                             tau: float = 1.0, train_backbone: bool = True):
    """Listwise step over the whole verifier. batch: images [B,H,W,3],
    text_tokens [B,T], cand_trajs [B,N,H,7], qualities [B,N]."""
    return _whole_tree_step(
        cfg, tx, train_backbone, lambda m, feats, batch: listwise_ranking_loss(
            m, cfg, feats, batch["cand_trajs"], batch["qualities"], tau=tau))


def make_regression_train_step(cfg: VerifierConfig,
                               tx: optim.GradientTransformation,
                               q_scale: float = 5.0,
                               train_backbone: bool = True):
    """Quality-regression step (the listwise step's batch)."""
    return _whole_tree_step(
        cfg, tx, train_backbone,
        lambda m, feats, batch: quality_regression_loss(
            m, cfg, feats, batch["cand_trajs"], batch["qualities"],
            q_scale=q_scale))
