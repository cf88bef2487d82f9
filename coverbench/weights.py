"""Random weights from the run's seed, made on the device in a few large
calls, in the program's tree layout (key for key, shape for shape, dtype
for dtype), so that the same tensors serve the program and the reference.

The layout comes from the program's own initialisers run on the meta
device (shapes and dtypes, no values). The values are the benchmark's: one
flat buffer per dtype filled with standard normals by a `torch.Generator`
on the device, then each leaf scaled by a rule on its name and shape:
matrices by fan_in ** -0.5, embedding tables by 0.02, norm weights and
biases around their identity by 0.1 and 0.02, the verifier's readout
queries by 1, and its two temperatures as published constants; the
policy's leaves by its backbone module's `weight_rule` first (Gemma's
RMSNorm weights, 1 + w, by 0.1 around 0). Random norm weights and biases
keep their arithmetic visible to the comparison, which zeros would hide.
"""

from __future__ import annotations

import torch

CHUNK = 1 << 28     # elements a generator call fills


def _leaves(tree, prefix=()):
    for key in tree:
        value = tree[key]
        if isinstance(value, torch.Tensor):
            yield prefix + (key,), value
        else:
            yield from _leaves(value, prefix + (key,))


def _rule(path, shape):
    """(std, offset) of a leaf, from its name and shape."""
    name, parent = path[-1], (path[-2] if len(path) > 1 else "")
    if name == "tave_temperature":
        return 0.0, 0.07
    if name == "logit_scale":
        return 0.0, 2.6592
    if name == "query":
        return 1.0, 0.0
    if name in ("token_embed", "pos_emb"):
        return 0.02, 0.0
    if name == "scale":                                 # LayerNorm
        return 0.1, 1.0
    if name == "bias":
        return 0.02, 0.0
    if len(shape) >= 2:                                 # [.., in, out]
        return shape[-2] ** -0.5, 0.0
    raise ValueError(f"no initialisation rule for {'/'.join(path)} "
                     f"{tuple(shape)} (parent {parent!r})")


def make(trees: dict, seed: int, device, backbone) -> dict:
    """{name: meta tree} -> {name: nested dict of device tensors}, the
    values drawn from `seed`. The leaves of one dtype are views of one
    buffer. `backbone`: the configuration's backbone module, whose
    `weight_rule` the leaves of the "policy" tree consult first."""
    by_dtype = {}
    for name, tree in trees.items():
        for path, meta in _leaves(tree):
            by_dtype.setdefault(meta.dtype, []).append(((name,) + path, meta))
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {}
    for dtype in sorted(by_dtype, key=str):
        items = sorted(by_dtype[dtype], key=lambda it: it[0])
        total = sum(m.numel() for _, m in items)
        flat = torch.empty(total, dtype=dtype, device=device)
        for start in range(0, total, CHUNK):
            part = flat[start:start + CHUNK]
            part.copy_(torch.randn(part.numel(), generator=gen,
                                   dtype=torch.float32, device=device))
        at = 0
        for path, meta in items:
            view = flat[at:at + meta.numel()].view(meta.shape)
            at += meta.numel()
            rule = (backbone.weight_rule(path, meta.shape)
                    if path[0] == "policy" else None)
            std, offset = rule or _rule(path, meta.shape)
            view.mul_(std).add_(offset)
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = view
    return out
