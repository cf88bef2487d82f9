"""Checkpoint save/load + rotation/resume semantics.

The port's native checkpoint is a directory holding one ``params.blob``
(`convert/blob.py`): written leaf by leaf from any device, loaded as
memory-mapped host tensors and moved to the device in one pass. The JAX
package writes orbax directories instead; orbax needs ``jax``, so the port
cannot read them and says so (`load_params` raises ValueError). A JAX tree
reaches the port through a blob (the JAX package's ``convert/blob.py``
``save_tree`` into ``<dir>/params.blob``, which `load_params` reads) or in
memory through `convert/from_jax.py`.

Replaces the reference's three checkpoint families:
  * full train-state checkpoints (model + optimizer + scheduler + step):
    a train state (`training/train_pi0.py`) is saved as one blob of its
    parameters, its optimizer state (moments or int8 grids and scales,
    counters, the accumulation buffer and its mini-step) and its step,
    and restored into a state of the same layout in place,
  * weights-only exports,
  * rotation keeping the last K (the verifier trainer's
    manage_checkpoints).

A sharded train state (`parallel/mesh.py`: its parameter tree carries a
shard plan) is saved in the layout a single process writes: every rank
joins the gather of the whole leaves, rank 0 alone writes, and then every
rank passes a barrier. Restoring reads the file on every rank and keeps
the rank's shard, so a state saved at one world size restores at
another.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, List, Optional

import torch

from cover_vla_tpu_torch.convert import blob
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models.params import ParamTree
from cover_vla_tpu_torch.parallel.distributed import barrier, rank
from cover_vla_tpu_torch.parallel.mesh import (
    gather_tensor, map_shards, node_spec, shard_plan, shard_tensor)

BLOB_NAME = "params.blob"
# files an orbax PyTreeCheckpointer directory holds
_ORBAX_MARKERS = ("_METADATA", "_CHECKPOINT_METADATA", "manifest.ocdbt",
                  "_sharding", "checkpoint")


def save_params(path: str, params: Any) -> str:
    """Write a tree (ParamTree or nested dicts of tensors) as the blob
    directory `path`, replacing whatever was there."""
    path = os.path.abspath(path)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.makedirs(path)
    blob.save_tree(os.path.join(path, BLOB_NAME), params)
    return path


def _restore(tree, target, dev, where: str = "") -> dict:
    """`tree` moved to `dev`. With `target`, the two must hold the same
    keys and each leaf is cast to the target leaf's dtype (the restore
    args of the JAX package's orbax load)."""
    if target is not None:
        missing = [k for k in target if k not in tree]
        extra = [k for k in tree if k not in target]
        if missing or extra:
            raise KeyError(f"checkpoint and target differ under "
                           f"{where or '/'}: missing {missing}, "
                           f"unexpected {extra}")
    out = {}
    for key, leaf in tree.items():
        want = None if target is None else target[key]
        out[key] = (_restore(leaf, want, dev, f"{where}/{key}")
                    if isinstance(leaf, dict)
                    else leaf.to(dev, leaf.dtype if want is None
                                 else want.dtype))
    return out


def load_params(path: str, target: Optional[Any] = None,
                device=None) -> ParamTree:
    """Load a blob directory as a ParamTree on `device` (CUDA unless given).
    With `target`, the checkpoint must hold the target's keys and each
    leaf is cast to the target leaf's dtype."""
    path = os.path.abspath(path)
    f = os.path.join(path, BLOB_NAME)
    if not os.path.isfile(f):
        if os.path.isdir(path) and any(
                os.path.exists(os.path.join(path, m)) for m in _ORBAX_MARKERS):
            raise ValueError(
                f"{path!r} is an orbax checkpoint, which needs jax to read; "
                "the PyTorch port reads blob directories only. Bring a JAX "
                "tree across with the JAX package's convert/blob.py "
                f"(save_tree('<dir>/{BLOB_NAME}', tree)) or, in memory, with "
                "cover_vla_tpu_torch.convert.from_jax")
        raise FileNotFoundError(f"no {BLOB_NAME} checkpoint at {path!r}")
    return ParamTree(_restore(blob.load_tree(f), target,
                              resolve_device(device)))


def _as_tree(state: Any):
    """A train state (a NamedTuple of trees) as the dict it is saved as."""
    return state._asdict() if hasattr(state, "_asdict") else state


def _state_plan(state):
    """The shard plan of a train state's sharded parameter tree, if any."""
    for value in _as_tree(state).values():
        if shard_plan(value) is not None:
            return shard_plan(value)
    return None


def _copy_into(target, tree, where: str = "", plan=None, spec=None,
               path: str = "") -> None:
    """Copy every leaf of `tree` into the tensor at the same key of
    `target`, in place (cast to the target's dtype). Both must hold the
    same leaves with the same shapes; an empty node of `target` (an
    optimizer part without state) has no entry in a blob. With `plan`,
    a tensor under a sharded leaf's name takes this rank's part of the
    whole-layout tensor; the top level's keys are the state's fields."""
    extra = [k for k in tree if k not in target]
    if extra:
        raise KeyError(f"checkpoint has unexpected entries under "
                       f"{where or '/'}: {extra}")
    for key in target:
        value, here = target[key], f"{where}/{key}"
        node = "" if not where else f"{path}.{key}" if path else key
        s = spec or (node_spec(plan, node, key) if plan and where else None)
        if isinstance(value, torch.Tensor):
            if key not in tree or isinstance(tree[key], dict):
                raise KeyError(f"checkpoint lacks the tensor {here}")
            src = tree[key]
            if s is not None:
                src = shard_tensor(src, s, value.shape)
            if tuple(src.shape) != tuple(value.shape):
                raise ValueError(f"{here}: checkpoint shape "
                                 f"{tuple(src.shape)}, state shape "
                                 f"{tuple(value.shape)}")
            with torch.no_grad():
                value.copy_(src)
        else:
            _copy_into(value, tree.get(key, {}), here, plan, s, node)


def save_train_state(root: str, step: int, state: Any,
                     keep_last: int = 3) -> str:
    """Save under root/step_<N>/ and rotate old checkpoints. `state` is a
    train state or a parameter tree. In a multi-process run every rank
    calls it: the whole leaves of a sharded state are gathered, rank 0
    writes, and the call returns once every rank has passed a barrier."""
    path = os.path.join(os.path.abspath(root), f"step_{step:08d}")
    tree, plan = _as_tree(state), _state_plan(state)
    if plan is not None:
        tree = {k: v if isinstance(v, torch.Tensor)
                else map_shards(v, plan, gather_tensor)
                for k, v in tree.items()}
    if rank() == 0:
        save_params(path, tree)
        rotate_checkpoints(root, keep_last)
    barrier("save_train_state")
    return path


def list_checkpoints(root: str) -> List[str]:
    if not os.path.isdir(root):
        return []
    entries = [d for d in os.listdir(root)
               if re.fullmatch(r"step_\d+", d)]
    return [os.path.join(root, d) for d in sorted(entries)]


def latest_checkpoint(root: str) -> Optional[str]:
    cks = list_checkpoints(root)
    return cks[-1] if cks else None


def rotate_checkpoints(root: str, keep_last: int) -> None:
    cks = list_checkpoints(root)
    for old in cks[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(old, ignore_errors=True)


def cleanup_empty_runs(runs_root: str) -> int:
    """Remove run directories that contain no checkpoints (the reference's
    empty-run cleanup). Returns the number removed."""
    removed = 0
    if not os.path.isdir(runs_root):
        return 0
    for d in os.listdir(runs_root):
        path = os.path.join(runs_root, d)
        if os.path.isdir(path) and not list_checkpoints(path) \
                and not os.listdir(path):
            shutil.rmtree(path, ignore_errors=True)
            removed += 1
    return removed


def restore_train_state(root: str, target: Any,
                        device=None) -> tuple[Any, int]:
    """Resume from the latest checkpoint; returns (state, step). Without
    a checkpoint, (target, 0). A train state `target` is restored in
    place (its tensors keep their devices and requires_grad flags) and
    continues as the saved state would have (a sharded state keeps this
    rank's shards of the saved whole leaves); a parameter tree is loaded
    as a new ParamTree on `device`."""
    path = latest_checkpoint(root)
    if path is None:
        return target, 0
    step = int(os.path.basename(path).split("_")[1])
    if hasattr(target, "_asdict"):
        f = os.path.join(path, BLOB_NAME)
        if not os.path.isfile(f):
            raise FileNotFoundError(f"no {BLOB_NAME} checkpoint at {path!r}")
        _copy_into(_as_tree(target), blob.load_tree(f),
                   plan=_state_plan(target))
        return target, step
    return load_params(path, target=target, device=device), step
