"""Parameter-tree utilities over `ParamTree`s (and nested dicts of
tensors)."""

from __future__ import annotations

from typing import Any, Dict, Iterator, Mapping

import torch

from cover_vla_tpu_torch.models.params import ParamTree


def _leaves(tree) -> Iterator[torch.Tensor]:
    for _, value in tree.items():
        if isinstance(value, torch.Tensor):
            yield value
        else:
            yield from _leaves(value)


def flatten(tree, prefix: str = "") -> Dict[str, Any]:
    """{"a.b.c": leaf} of a tree of nested dicts / `ParamTree`s, in the
    JAX package's leaf order (keys sorted at every level, as
    jax.tree_util flattens dicts)."""
    out = {}
    for key in sorted(tree):
        value = tree[key]
        name = f"{prefix}{key}"
        if isinstance(value, (Mapping, ParamTree)):
            out.update(flatten(value, name + "."))
        else:
            out[name] = value
    return out


def unflatten(leaves: Dict[str, torch.Tensor]) -> dict:
    """The nested dict of a `flatten` result."""
    root: dict = {}
    for name, leaf in leaves.items():
        *path, last = name.split(".")
        d = root
        for k in path:
            d = d.setdefault(k, {})
        d[last] = leaf
    return root


def count_params(params) -> int:
    return sum(x.numel() for x in _leaves(params))


def _cast(tree, dtype):
    out = {}
    for k, v in tree.items():
        if not isinstance(v, torch.Tensor):
            out[k] = _cast(v, dtype)
        else:
            out[k] = v.to(dtype) if v.is_floating_point() else v
    return out


def cast_tree(params, dtype: torch.dtype) -> ParamTree:
    """A tree with every floating leaf cast to `dtype` (others as they
    are), on the same device."""
    return ParamTree(_cast(params, dtype))


def param_bytes(params) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(params))
