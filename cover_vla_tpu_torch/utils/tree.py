"""Parameter-tree utilities over `ParamTree`s (and nested dicts of
tensors)."""

from __future__ import annotations

from typing import Iterator

import torch

from cover_vla_tpu_torch.models.params import ParamTree


def _leaves(tree) -> Iterator[torch.Tensor]:
    for _, value in tree.items():
        if isinstance(value, torch.Tensor):
            yield value
        else:
            yield from _leaves(value)


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
