"""Parameter trees as ``nn.Module``s, in the reference package's layout.

A `ParamTree` mirrors one nested parameter dict of the JAX package key for
key: stacked ``[depth, ...]`` layer tensors, ``[in, out]`` kernels, the
same dtypes. Carrying weights across is therefore a copy
(`convert/from_jax.py`), and the model functions index a tree as they
index a dict: ``params["layers"]["q"]``.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import torch
from torch import nn


class ParamTree(nn.Module):
    """Nested frozen parameters: tensors become `nn.Parameter`s
    (requires_grad=False) over the same storage, sub-dicts become child
    trees, and child trees are taken as they are."""

    def __init__(self, tree: Mapping):
        super().__init__()
        self._keys = list(tree)
        for key, value in tree.items():
            if isinstance(value, ParamTree):
                self.add_module(key, value)
            elif isinstance(value, Mapping):
                self.add_module(key, ParamTree(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(torch.as_tensor(value),
                                      requires_grad=False))

    def __getitem__(self, key: str):
        if key not in self._keys:
            raise KeyError(key)
        return getattr(self, key)

    def __contains__(self, key: object) -> bool:
        return key in self._keys

    def __iter__(self) -> Iterator[str]:
        return iter(self._keys)

    def get(self, key: str, default=None):
        return self[key] if key in self._keys else default

    def items(self) -> Iterator[tuple]:
        return ((k, getattr(self, k)) for k in self._keys)


def take_layer(tree, i: int, axis: int = 0) -> dict:
    """Layer i of a tree whose leaves are stacked along `axis`, as nested
    dicts of views."""
    return {k: (take_layer(tree[k], i, axis)
                if isinstance(tree[k], (Mapping, ParamTree))
                else tree[k].select(axis, i)) for k in tree}


def unstack_layers(tree, axis: int = 0) -> list:
    """Every layer of a tree whose leaves are stacked along `axis`, as one
    nested dict of views per layer, from one `unbind` per leaf. Under
    autograd the backward pass then stacks each leaf's layer gradients
    once; a `select` per layer (`take_layer`) adds a zero gradient of the
    whole stacked leaf per layer."""
    layers = None
    for k in tree:
        v = tree[k]
        parts = (unstack_layers(v, axis) if isinstance(v, (Mapping, ParamTree))
                 else v.unbind(axis))
        if layers is None:
            layers = [{} for _ in parts]
        for layer, part in zip(layers, parts):
            layer[k] = part
    return layers


def iter_layers(tree, depth: int, axis: int = 0):
    """The `depth` layers of a stacked tree in order: `unstack_layers`
    when grad is enabled, else `take_layer` one layer at a time (the
    no-grad serving paths keep their per-layer views)."""
    if torch.is_grad_enabled():
        return unstack_layers(tree, axis)
    return (take_layer(tree, i, axis) for i in range(depth))


class Init:
    """Seeded random tensors on one device: a `torch.Generator` in place of
    the reference's `jax.random` keys. The same shapes, dtypes and scales
    as the reference initialisers; not the same numbers."""

    def __init__(self, seed: int, device: torch.device):
        self.device = device
        # the meta device (shapes and dtypes only) has no generator
        self.gen = (None if device.type == "meta"
                    else torch.Generator(device=device).manual_seed(seed))

    def normal(self, shape, std: float, dtype=torch.bfloat16) -> torch.Tensor:
        if self.gen is None:
            return self._meta(shape, dtype)
        x = torch.randn(shape, generator=self.gen, dtype=torch.float32,
                        device=self.device)
        return (x * std).to(dtype)

    def uniform(self, shape, bound: float,
                dtype=torch.float32) -> torch.Tensor:
        if self.gen is None:
            return self._meta(shape, dtype)
        x = torch.rand(shape, generator=self.gen, dtype=torch.float32,
                       device=self.device)
        return ((2.0 * x - 1.0) * bound).to(dtype)

    def _meta(self, shape, dtype) -> torch.Tensor:
        # shapes and dtypes only, without arithmetic: the first arithmetic
        # on the meta device imports PyTorch's Python meta kernels (seconds)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def zeros(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def ones(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.ones(shape, dtype=dtype, device=self.device)

    def full(self, shape, value: float, dtype=torch.float32) -> torch.Tensor:
        return torch.full(shape, value, dtype=dtype, device=self.device)

    def linear(self, fan_in: int, fan_out: int, lead=()) -> dict:
        """fp32 {kernel [.., in, out], bias [.., out]} ~ U(+-fan_in**-0.5)."""
        bound = fan_in ** -0.5
        return {"kernel": self.uniform((*lead, fan_in, fan_out), bound),
                "bias": self.uniform((*lead, fan_out), bound)}
