"""Optimizers and learning-rate schedules, written out with optax's
arithmetic so a step here is a step of the reference trainer.

An optimizer is a `GradientTransformation`: ``init(leaves) -> state`` and
``update(grads, state, leaves) -> (updates, state)`` over flat dicts of
tensors named by their tree path (``trees.flatten``). Its state is a
nested dict of tensors, so a train state saves as one blob. Counters are
0-d int32 CPU tensors: the host reads them without a device sync.

Numerics kept from optax (the reference trainer's): AdamW's moments live
in the leaf's dtype (bf16 moments for a bf16 leaf) and its update is
applied in that dtype; there are no fp32 master weights. The learning
rate is read at the count before the update, so the first update under
`warmup_cosine` is zero. The global-norm clip scales by max_norm / norm
only when norm >= max_norm. Accumulation over k calls averages the
gradients as a running mean and advances the inner optimizer (and its
schedule) once per k calls.

Over sharded leaves (`parallel/mesh.py`) the transformations run on each
rank's shards; the global norm then sums each rank's part under
`sharded_norm` and all-reduces it over the 'fsdp' group.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

Leaves = Dict[str, torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    init: Callable[[Leaves], dict]
    update: Callable[[Leaves, dict, Leaves], Tuple[Leaves, dict]]


def counter() -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32)


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


class Consts:
    """A host scalar tensor moved once to each (device, dtype) that asks
    for it. Arithmetic with it stays a device tensor operation: a host
    scalar divisor would become a multiplication by a rounded reciprocal
    on CUDA."""

    def __init__(self, value: torch.Tensor):
        self.value, self._on = value, {}

    def like(self, t: torch.Tensor) -> torch.Tensor:
        key = (t.device, t.dtype)
        if key not in self._on:
            self._on[key] = self.value.to(t.device, t.dtype)
        return self._on[key]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded fp32 square root (then rounded to x's dtype),
    as XLA and CUDA compute it. PyTorch's vectorised fp32 sqrt on the CPU
    is off by one ulp for some inputs; through float64 it is exact."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float().to(x.dtype)
    return torch.sqrt(x)


# ---------------------------------------------------------------------------
# schedules (fp32, op for op as optax computes them)
# ---------------------------------------------------------------------------


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  end_lr_ratio: float = 0.1) -> Schedule:
    """Linear warmup from 0 to `lr`, then cosine decay to lr * end_lr_ratio
    at `total_steps` (optax.warmup_cosine_decay_schedule)."""
    warmup_steps = min(warmup_steps, max(0, total_steps - 1))
    decay_steps = max(total_steps, warmup_steps + 1) - warmup_steps
    end_value = lr * end_lr_ratio
    alpha = 0.0 if lr == 0.0 else end_value / lr

    def schedule(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            c = _f32(min(max(count, 0), warmup_steps))
            frac = 1 - c / float(warmup_steps)
            return float((0.0 - lr) * frac + lr)
        c = _f32(min(count - warmup_steps, decay_steps))
        cosine = 0.5 * (1 + torch.cos(math.pi * c / float(decay_steps)))
        return float(lr * ((1 - alpha) * cosine + alpha))

    return schedule


def linear_warmup(lr: float, warmup_steps: int) -> Schedule:
    """Linear ramp from 0 to `lr` over `warmup_steps`, then constant."""
    def schedule(count: int) -> float:
        if warmup_steps > 0 and count < warmup_steps:
            c = _f32(min(max(count, 0), warmup_steps))
            frac = 1 - c / float(warmup_steps)
            return float((0.0 - lr) * frac + lr)
        return float(_f32(lr))

    return schedule


# ---------------------------------------------------------------------------
# transformations
# ---------------------------------------------------------------------------


class _ShardedNorm(NamedTuple):
    counts: Dict[str, int]      # elements of each gradient this rank sums
    group: object               # the 'fsdp' process group


_SHARDED_NORM: contextvars.ContextVar[Optional[_ShardedNorm]] = \
    contextvars.ContextVar("sharded_norm", default=None)


@contextlib.contextmanager
def sharded_norm(counts: Dict[str, int], group):
    """Inside, `global_norm` (and so the clip) is the norm over every
    rank's shards: of each gradient it sums the first counts[name]
    elements (-1: all of them; `parallel.mesh.norm_counts`), then
    all-reduces the sum over `group`."""
    token = _SHARDED_NORM.set(_ShardedNorm(counts, group))
    try:
        yield
    finally:
        _SHARDED_NORM.reset(token)


def global_norm(grads: Leaves) -> torch.Tensor:
    """sqrt of the sum of squares over every leaf (fp32 sums, summed in
    leaf order)."""
    scope = _SHARDED_NORM.get()
    total = None
    for k, g in grads.items():
        if scope is not None and scope.counts[k] >= 0:
            g = g.reshape(-1)[:scope.counts[k]]
        s = g.float().square().sum()
        total = s if total is None else total + s
    if scope is not None:
        dist.all_reduce(total, group=scope.group)
    return sqrt(total)


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale every gradient by max_norm / norm when norm >= max_norm (no
    epsilon, unlike torch.nn.utils.clip_grad_norm_)."""
    def init(params):
        return {}

    def update(grads, state, params=None):
        norm = global_norm(grads)
        keep = norm < max_norm
        return {k: torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)
                for k, g in grads.items()}, state

    return GradientTransformation(init, update)


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4
          ) -> GradientTransformation:
    """optax.adamw: moments in the leaf dtype, bias correction, decoupled
    weight decay, then the learning rate read at the pre-update count."""
    def init(params):
        return {"count": counter(),
                "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params):
        count = state["count"]
        lr = learning_rate(int(count)) if callable(learning_rate) \
            else learning_rate
        count_inc = count + 1
        bc1 = Consts(1 - _f32(b1) ** count_inc.float())
        bc2 = Consts(1 - _f32(b2) ** count_inc.float())
        step_size = Consts(_f32(-lr))
        # the Python constants enter in the leaf's dtype, as JAX's weakly
        # typed scalars do (a bf16 leaf multiplies by bf16(0.9))
        c = {x: Consts(_f32(x)) for x in (1 - b1, b1, 1 - b2, b2, eps,
                                          weight_decay)}
        mu, nu, updates = {}, {}, {}
        for k, g in grads.items():
            mu[k] = c[1 - b1].like(g) * g + c[b1].like(g) * state["mu"][k]
            nu[k] = (c[1 - b2].like(g) * (g * g)
                     + c[b2].like(g) * state["nu"][k])
            u = (mu[k] / bc1.like(g)) / (
                sqrt(nu[k] / bc2.like(g)) + c[eps].like(g))
            u = u + c[weight_decay].like(g) * params[k]
            updates[k] = step_size.like(g) * u
        return updates, {"count": count_inc, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return {str(i): tx.init(params) for i, tx in enumerate(txs)}

    def update(grads, state, params):
        new = {}
        for i, tx in enumerate(txs):
            grads, new[str(i)] = tx.update(grads, state[str(i)], params)
        return grads, new

    return GradientTransformation(init, update)


def multi_steps(tx: GradientTransformation, every_k: int
                ) -> GradientTransformation:
    """optax.MultiSteps(tx, every_k) with gradient means: the running mean
    of the micro-batch gradients goes to `tx` on every k-th call; the calls
    between return zero updates and leave `tx`'s state as it was."""
    def init(params):
        return {"mini_step": counter(), "gradient_step": counter(),
                "inner": tx.init(params),
                "acc_grads": {k: torch.zeros_like(p)
                              for k, p in params.items()}}

    def update(grads, state, params):
        n = state["mini_step"]
        n_acc = Consts((n + 1).float())
        acc = {k: a + (grads[k] - a) / n_acc.like(a)
               for k, a in state["acc_grads"].items()}
        if int(n) == every_k - 1:
            updates, inner = tx.update(acc, state["inner"], params)
            return updates, {
                "mini_step": counter(), "inner": inner,
                "gradient_step": state["gradient_step"] + 1,
                "acc_grads": {k: torch.zeros_like(a) for k, a in acc.items()}}
        return {k: torch.zeros_like(a) for k, a in acc.items()}, {
            "mini_step": n + 1, "gradient_step": state["gradient_step"],
            "inner": state["inner"], "acc_grads": acc}

    return GradientTransformation(init, update)


def masked(tx: GradientTransformation, mask: Dict[str, bool]
           ) -> GradientTransformation:
    """`tx` over the leaves whose mask is True; the others get zero
    updates (optax.multi_transform with set_to_zero: a freeze, not a
    pass-through of the raw gradients)."""
    def init(params):
        return tx.init({k: p for k, p in params.items() if mask[k]})

    def update(grads, state, params):
        inner, state = tx.update(
            {k: g for k, g in grads.items() if mask[k]}, state,
            {k: p for k, p in params.items() if mask[k]})
        return {k: inner[k] if mask[k] else torch.zeros_like(g)
                for k, g in grads.items()}, state

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: Leaves, updates: Leaves) -> None:
    """params += updates, in place, in each parameter's dtype."""
    for k, u in updates.items():
        params[k].add_(u.to(params[k].dtype))


def value_and_grad(leaves: Leaves, loss_fn
                   ) -> Tuple[torch.Tensor, object, Leaves]:
    """Differentiate `loss_fn() -> (loss, aux)` with respect to `leaves`
    (marked requires_grad here). A leaf the loss does not reach gets a
    zero gradient. Returns (loss detached, aux, gradients)."""
    for v in leaves.values():
        v.requires_grad_(True)
    with torch.enable_grad():
        loss, aux = loss_fn()
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    return loss.detach(), aux, {
        k: torch.zeros_like(leaves[k]) if g is None else g
        for k, g in zip(leaves, grads)}


@torch.no_grad()
def update_in_place(tx: GradientTransformation, opt_state: dict,
                    grads: Leaves, leaves: Leaves) -> dict:
    """Apply `tx`'s update of `grads` to `leaves` in place; returns the new
    optimizer state."""
    updates, opt_state = tx.update(grads, opt_state, leaves)
    apply_updates(leaves, updates)
    return opt_state


def grad_step(tx: GradientTransformation, opt_state: dict, leaves: Leaves,
              loss_fn) -> Tuple[torch.Tensor, dict, Leaves, dict]:
    """One optimizer step: `value_and_grad` of `loss_fn() -> (loss, aux)`
    with respect to `leaves`, then `tx`'s update applied to them in place.
    Returns (loss detached, aux, gradients, new optimizer state)."""
    loss, aux, grads = value_and_grad(leaves, loss_fn)
    return loss, aux, grads, update_in_place(tx, opt_state, grads, leaves)


def make_adamw(lr_schedule, weight_decay: float = 1e-10, b1: float = 0.9,
               b2: float = 0.95, eps: float = 1e-8, grad_clip: float = 1.0,
               accumulate_steps: int = 1) -> GradientTransformation:
    """Global-norm clip -> AdamW, accumulated over `accumulate_steps`."""
    tx = chain(clip_by_global_norm(grad_clip),
               adamw(lr_schedule, b1=b1, b2=b2, eps=eps,
                     weight_decay=weight_decay))
    if accumulate_steps > 1:
        tx = multi_steps(tx, accumulate_steps)
    return tx
