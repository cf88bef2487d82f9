"""Device mesh and sharding rules over torch.distributed.

Replaces the reference's DDP / FSDP wrappers: a ('dp', 'fsdp') mesh of
processes, one device each. The batch is split over both dims; parameters
and optimizer state are sharded over 'fsdp' (ZeRO-3 style); gradients are
reduce-scattered in fp32 over 'fsdp' and averaged over 'dp'.

The shard layout (a stated divergence from the JAX package, which splits a
leaf along its largest divisible dim): rank i of the 'fsdp' dim owns one
contiguous range of the leaf flattened, zero-padded to a multiple of
size x 256 elements, so every range starts on a block of 8-bit AdamW's
flattened quantisation and its grids are the unsharded grids. At 'fsdp'
size 1 a rank's range is the whole leaf, and gathering it is a view.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F

from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.utils.tree import flatten, unflatten

BLOCK = 256     # the 8-bit AdamW block: shard ranges start on one


def _mesh_dims(dp: Optional[int], fsdp: Optional[int],
               n: int) -> Tuple[int, int]:
    """The JAX package's defaults: every device on 'fsdp'."""
    if dp is None and fsdp is None:
        dp, fsdp = 1, n
    elif dp is None:
        dp = n // fsdp
    elif fsdp is None:
        fsdp = n // dp
    if dp * fsdp != n:
        raise ValueError(f"mesh {dp}x{fsdp} != {n} devices")
    return dp, fsdp


def make_mesh(dp: Optional[int] = None, fsdp: Optional[int] = None,
              devices=None):
    """A ('dp', 'fsdp') `DeviceMesh` over `devices` (global ranks; every
    rank of the default process group unless given), one device per
    process. Defaults: all devices on 'fsdp'."""
    from torch.distributed.device_mesh import DeviceMesh
    if devices is None:
        if not dist.is_initialized():
            raise RuntimeError("make_mesh needs a process group "
                               "(parallel.distributed.init_multihost)")
        devices = range(dist.get_world_size())
    ranks = list(devices)
    dp, fsdp = _mesh_dims(dp, fsdp, len(ranks))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(dp, fsdp),
                      mesh_dim_names=("dp", "fsdp"))


def _dim(mesh, axis: str) -> int:
    return list(mesh.mesh_dim_names).index(axis)


def mesh_size(mesh) -> int:
    n = 1
    for s in mesh.shape:
        n *= s
    return n


def mesh_rank(mesh) -> int:
    """This process's index in the mesh flattened row-major (the order in
    which the batch's rows are split)."""
    r = 0
    for c, s in zip(mesh.get_coordinate(), mesh.shape):
        r = r * s + c
    return r


class FlatShard(NamedTuple):
    """A leaf sharded over one mesh dim: rank `index` of `size` holds
    elements [index * chunk, (index + 1) * chunk) of the leaf flattened
    and zero-padded to `padded` elements."""
    shape: Tuple[int, ...]
    padded: int
    index: int
    size: int
    group: Any          # the dim's ProcessGroup

    @property
    def numel(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def chunk(self) -> int:
        return self.padded // self.size

    @property
    def valid(self) -> int:
        """Elements of the leaf (not padding) in this rank's range."""
        return max(0, min(self.chunk, self.numel - self.index * self.chunk))


class Replicated(NamedTuple):
    """A leaf every rank holds whole."""
    mesh: Any


Plan = Dict[str, Union[FlatShard, Replicated]]


def replicated(mesh) -> Replicated:
    return Replicated(mesh)


def fsdp_sharding(params, mesh, axis: str = "fsdp",
                  min_size: int = 2 ** 14) -> Plan:
    """{leaf name (`utils.tree.flatten`): FlatShard | Replicated}.

    Leaves smaller than min_size elements (norm scales, biases) and 0-d
    leaves stay replicated: sharding them costs collective latency for
    nothing. Every other leaf is sharded over `axis` in flat ranges padded
    to a multiple of size x BLOCK."""
    d = _dim(mesh, axis)
    size, index = mesh.shape[d], mesh.get_coordinate()[d]
    group = mesh.get_group(axis)
    unit = size * BLOCK
    plan = {}
    for name, x in flatten(params).items():
        if x.ndim == 0 or x.numel() < min_size:
            plan[name] = Replicated(mesh)
        else:
            padded = -(-x.numel() // unit) * unit
            plan[name] = FlatShard(tuple(x.shape), padded, index, size, group)
    return plan


def batch_sharding(mesh) -> Callable:
    """The rule that takes this rank's rows of a leaf's leading axis, split
    over both mesh dims (row-major mesh order). 0-d leaves and non-arrays
    (lists of strings) pass through. An indivisible batch raises."""
    n, r = mesh_size(mesh), mesh_rank(mesh)

    def rule(x):
        if getattr(x, "ndim", 0) == 0:
            return x
        b = x.shape[0]
        if b % n:
            raise ValueError(f"a batch of {b} rows does not divide over "
                             f"{n} processes")
        return x[r * (b // n):(r + 1) * (b // n)]

    return rule


def gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's rows of a tensor split as `batch_sharding` splits it,
    in order (the inverse of the rule). Bools travel as uint8."""
    out = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
    for axis in ("fsdp", "dp"):      # rows of one 'dp' index are adjacent
        group = mesh.get_group(axis)
        parts = out.new_empty((out.shape[0] * dist.get_world_size(group),
                               *out.shape[1:]))
        dist.all_gather_into_tensor(parts, out, group=group)
        out = parts
    return out.bool() if t.dtype == torch.bool else out


# ---------------------------------------------------------------------------
# moving leaves between the sharded and the whole layout
# ---------------------------------------------------------------------------


def shard_tensor(full: torch.Tensor, spec: FlatShard,
                 shape: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """This rank's part of a leaf (or of a tensor laid out by it) in the
    whole layout. `shape` is the shard's shape: [chunk] (the default) for
    the leaf itself and per-element state, [chunk / 256, c] for per-block
    state (8-bit AdamW's grids and scales); rows past the end are zero."""
    shape = (spec.chunk,) if shape is None else tuple(shape)
    rows = full.reshape(-1, *shape[1:])
    lo = spec.index * shape[0]
    part = rows[lo:lo + shape[0]]
    return F.pad(part, (0, 0) * (len(shape) - 1)
                 + (0, shape[0] - part.shape[0])).contiguous()


def gather_tensor(shard: torch.Tensor, spec: FlatShard) -> torch.Tensor:
    """The whole-layout tensor of every rank's `shard` (the inverse of
    `shard_tensor`): the leaf's shape for a [chunk] shard, the unpadded
    rows for a per-block one. At size 1 a view of `shard`."""
    shard = shard.detach()
    if spec.size == 1:
        out = shard
    else:
        out = shard.new_empty((shard.shape[0] * spec.size, *shard.shape[1:]))
        dist.all_gather_into_tensor(out, shard.contiguous(), group=spec.group)
    rows = -(-spec.numel * shard.shape[0] // spec.chunk)
    return out[:rows].view(spec.shape) if shard.ndim == 1 else out[:rows]


def node_spec(plan: Plan, path: str, key: str) -> Optional[FlatShard]:
    """The shard of a tree node: a parameter at `path`, or an optimizer
    state entry keyed by a leaf's name."""
    spec = plan.get(path, plan.get(key))
    return spec if isinstance(spec, FlatShard) else None


def map_shards(tree, plan: Plan, fn: Callable, spec=None, path: str = ""
               ) -> dict:
    """A copy of a nested tree (a state, a parameter or optimizer tree)
    with fn(tensor, spec) in place of every tensor under a sharded leaf's
    name; the other tensors are kept as they are."""
    out = {}
    for key, value in tree.items():
        here = f"{path}.{key}" if path else key
        s = spec or node_spec(plan, here, key)
        if isinstance(value, torch.Tensor):
            out[key] = fn(value, s) if s is not None else value
        else:
            out[key] = map_shards(value, plan, fn, s, here)
    return out


def shard_params(params, plan: Plan) -> ParamTree:
    """A tree of this rank's shards (copies) and of the replicated leaves
    (shared with `params`); it carries `plan` as its `shard_plan`."""
    leaves = {k: shard_tensor(v.detach(), plan[k])
              if isinstance(plan[k], FlatShard) else v
              for k, v in flatten(params).items()}
    tree = ParamTree(unflatten(leaves))
    tree.shard_plan = plan
    return tree


def shard_plan(tree) -> Optional[Plan]:
    return getattr(tree, "shard_plan", None)


def gather_params(params) -> ParamTree:
    """The whole parameter tree of a sharded one (every rank joins; at
    'fsdp' size 1 its leaves are views of the shards); an unsharded tree
    as it is."""
    plan = shard_plan(params)
    if plan is None:
        return params
    return ParamTree(map_shards(params, plan, gather_tensor))


# ---------------------------------------------------------------------------
# gradient and metric reductions
# ---------------------------------------------------------------------------


def _avg(t: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(t, op=dist.ReduceOp.AVG, group=group)
    return t


def reduce_gradients(grads: Dict[str, torch.Tensor], plan: Plan, mesh
                     ) -> Dict[str, torch.Tensor]:
    """Whole-leaf gradients of this rank's rows -> the mean gradient over
    every rank, in the parameters' layout: a sharded leaf's gradient is
    reduce-scattered in fp32 over 'fsdp', a replicated one all-reduced;
    both are then averaged over 'dp' and cast back to the leaf's dtype
    once. It empties `grads` as it goes (one leaf's fp32 copies at a
    time)."""
    fsdp, dp = mesh.get_group("fsdp"), mesh.get_group("dp")
    out = {}
    for k in list(grads):
        g, spec = grads.pop(k), plan[k]
        if isinstance(spec, FlatShard):
            flat = F.pad(g.float().reshape(-1), (0, spec.padded - g.numel()))
            red = flat.new_empty(spec.chunk)
            dist.reduce_scatter_tensor(red, flat, op=dist.ReduceOp.AVG,
                                       group=fsdp)
        else:
            red = _avg(g.float().clone(), fsdp)
        out[k] = _avg(red, dp).to(g.dtype)
    return out


def mean_over_mesh(t: torch.Tensor, mesh) -> torch.Tensor:
    """The mean of `t` over every rank of the mesh (fp32)."""
    t = t.detach().float().clone()
    return _avg(_avg(t, mesh.get_group("fsdp")), mesh.get_group("dp"))


def norm_counts(plan: Plan, names) -> Dict[str, int]:
    """Per leaf, how many of its gradient's elements this rank adds to the
    global norm: a shard's elements of the leaf, a replicated leaf's all
    on 'fsdp' index 0 and none elsewhere (so it counts once per 'dp'
    replica, which the all-reduce over 'fsdp' alone then sums)."""
    out = {}
    for k in names:
        spec = plan[k]
        if isinstance(spec, FlatShard):
            out[k] = spec.valid
        else:
            first = spec.mesh.get_coordinate()[_dim(spec.mesh, "fsdp")] == 0
            out[k] = -1 if first else 0         # -1: the whole gradient
    return out
