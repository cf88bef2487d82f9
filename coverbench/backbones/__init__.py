"""A configuration's policy backbone, found by name: the configuration
file's top-level `"backbone"` names `coverbench/backbones/<backbone>.py`.

A backbone module provides everything of the benchmark that depends on the
policy's language-model stack (see `gemma.py` and the README):

- `port_configs(config, traffic)`: the program's config objects under the
  route the benchmark runs, `(policy, verifier, cover, members)`;
- `policy_meta(pcfg)`: the program's policy tree on the meta device;
- `quantize(ptree)`: the program's int8 w8a8 quantization of that tree;
- `prompt_vocab(policy)`: the prompts' vocabulary size (`policy`: the
  configuration's `policy` group);
- `embed(pw, pol, image, ids, num)`, `prefill(pw, pol, emb, pos, mask,
  num)` and `expert(pw, pol, h, s_pos, cache, key_mask, k_prompts, n,
  num)`: the plain reference's backbone layers, in plain torch, importing
  nothing of the program;
- `policy_flops(policy, k, n)`: model FLOPs of the prefill and the decode
  of one episode;
- `KERNELS`: {kernel: predicate on a device event's symbol}, the
  backbone's hand kernels, consulted by `yardstick.category` first;
- `kernel_work(policy, rows, n)`: {kernel: (bytes, FLOPs, launches)} of
  one boundary's launches of those kernels;
- `weight_rule(path, shape)`: (std, offset) of a policy leaf, or None to
  fall through to `weights.py`'s table.
"""

from __future__ import annotations

import importlib
import os


def load(config: dict):
    """The backbone module a configuration names."""
    name = config["backbone"]
    module = f"coverbench.backbones.{name}"
    try:
        return importlib.import_module(module)
    except ModuleNotFoundError as e:
        if e.name != module:
            raise
        path = os.path.join("coverbench", "backbones", name + ".py")
        raise FileNotFoundError(
            f"configuration {config.get('name', '?')!r} names the backbone "
            f"{name!r}, but {path} does not exist") from None
