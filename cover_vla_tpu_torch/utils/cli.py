"""Dataclass -> CLI config system (draccus-equivalent).

The reference wires every entry point through draccus dataclass CLIs with
YAML + `!include` composition. This module provides the same surface
without the dependency, as the JAX package's `utils/cli.py` does:

  * `parse(ConfigClass, argv)` — builds a nested argparse from the
    dataclass tree; `--a.b.c value` overrides nested fields.
  * `--config path.yaml` — loads a YAML first (supports `!include other.yaml`
    nodes, relative to the including file), then applies CLI overrides.
  * `wrap()` — decorator mirroring @draccus.wrap().

PyYAML is imported only where YAML is read, so the CLI without a YAML file
works where it is not installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os
import sys
from typing import Any, Dict, Optional, Sequence, Type, get_type_hints


def load_yaml(path: str) -> Dict[str, Any]:
    """Read a YAML file whose `!include other.yaml` nodes load other.yaml
    (relative to the including file) in their place."""
    import yaml

    class Loader(yaml.SafeLoader):
        pass

    def include(loader, node):
        rel = loader.construct_scalar(node)
        return load_yaml(os.path.join(os.path.dirname(path), rel))

    Loader.add_constructor("!include", include)
    with open(path) as f:
        return yaml.load(f, Loader=Loader)


def _flatten_fields(cls, prefix=""):
    out = []
    hints = get_type_hints(cls)
    for f in dataclasses.fields(cls):
        t = hints.get(f.name, f.type)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(t):
            out.extend(_flatten_fields(t, prefix=name + "."))
        else:
            out.append((name, t, f))
    return out


def _coerce(t, value: str):
    if t is bool or t == Optional[bool]:
        return value.lower() in ("1", "true", "yes", "on")
    for typ in (int, float, str):
        if t is typ or t == Optional[typ]:
            return typ(value)
    try:                        # any other field: a YAML scalar
        import yaml
    except ImportError:
        return value
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def parse(cls: Type, argv: Optional[Sequence[str]] = None):
    """Parse argv into an instance of dataclass `cls`."""
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(add_help=True)
    parser.add_argument("--config", type=str, default=None,
                        help="YAML config file (supports !include)")
    for name, t, f in _flatten_fields(cls):
        parser.add_argument(f"--{name}", type=str, default=None)
    ns, unknown = parser.parse_known_args(argv)
    if unknown:
        raise SystemExit(f"unknown arguments: {unknown}")

    overrides: Dict[str, Any] = {}
    if ns.config:
        overrides.update(_flatten_dict(load_yaml(ns.config)))
    for name, t, f in _flatten_fields(cls):
        v = vars(ns).get(name)
        if v is not None:
            overrides[name] = v
    return _instantiate(cls, overrides)


def _flatten_dict(d: Dict[str, Any], prefix="") -> Dict[str, Any]:
    out = {}
    for k, v in (d or {}).items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten_dict(v, prefix=name + "."))
        else:
            out[name] = v
    return out


def _instantiate(cls, overrides: Dict[str, Any], prefix=""):
    hints = get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        t = hints.get(f.name, f.type)
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(t):
            if any(k.startswith(name + ".") for k in overrides):
                kwargs[f.name] = _instantiate(t, overrides, prefix=name + ".")
        elif name in overrides:
            v = overrides[name]
            kwargs[f.name] = _coerce(t, v) if isinstance(v, str) else v
    return cls(**kwargs)


def wrap():
    """@wrap() decorator: main(cfg) -> CLI entry (draccus.wrap mirror)."""
    def deco(fn):
        import inspect
        sig = inspect.signature(fn)
        cfg_cls = list(sig.parameters.values())[0].annotation

        @functools.wraps(fn)
        def entry(argv=None):
            return fn(parse(cfg_cls, argv))
        return entry
    return deco
