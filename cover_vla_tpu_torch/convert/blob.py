"""Flat single-file parameter blob: the convert-once cache format and the
port's native checkpoint file.

Layout (``CVTBLOB1``, byte for byte the JAX package's
``convert/blob.py``, so a blob written by either package loads in the
other): the magic, a u64 little-endian header length, a JSON header
``{"entries": [{path, dtype, shape, offset, nbytes}, ...]}`` whose offsets
are relative to the 64-byte-aligned data base, then the raw leaf bytes,
each leaf at a 64-byte-aligned offset. Trees are nested dicts (or
`ParamTree`s); leaves are torch tensors or numpy arrays.

bf16 needs no ``ml_dtypes``: it is written under the dtype name
``"bfloat16"`` (as ``ml_dtypes`` spells it, which the JAX reader
resolves) from its 16-bit pattern, and read back as a uint16 view
reinterpreted as ``torch.bfloat16``.

`load_tree` returns CPU tensors over a copy-on-write memory map of the
file: no parse, no copy until a leaf is consumed (by `.to(device)` or a
cast); writing to a leaf never reaches the file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from cover_vla_tpu_torch.models.params import ParamTree

MAGIC = b"CVTBLOB1"
_ALIGN = 64


def host_tensor(x) -> torch.Tensor:
    """A CPU tensor over `x`'s memory where it can be: tensors pass
    through, numpy arrays (numpy's ``bfloat16`` extension dtype too) are
    wrapped without a copy."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _as_bytes(leaf) -> np.ndarray:
    """The leaf's elements as a contiguous host numpy array (bf16 as its
    16-bit patterns)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy()
        return t.numpy()
    a = np.asarray(leaf)
    if a.dtype.name == "bfloat16":
        a = a.view(np.uint16)
    return np.ascontiguousarray(a)


def from_bytes(raw: np.ndarray, dtype: str, shape) -> torch.Tensor:
    """A tensor over the uint8 array `raw` holding `dtype` elements."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.uint16)).view(
            torch.bfloat16).reshape(shape)
    return torch.from_numpy(raw.view(np.dtype(dtype))).reshape(shape)


def _is_node(x) -> bool:
    return isinstance(x, (Mapping, ParamTree))


def _flatten(tree: Any, path=()) -> List[Tuple[List[str], Any]]:
    """(path, leaf) pairs with keys in sorted order, as the JAX package's
    tree flattening orders them: the same tree gives the same bytes."""
    if not _is_node(tree):
        raise TypeError(f"blob trees must be nested dicts; got "
                        f"{type(tree).__name__} at {'/'.join(path) or '/'}")
    out = []
    for key, value in sorted(tree.items(), key=lambda kv: kv[0]):
        where = (*path, str(key))
        out += (_flatten(value, where) if _is_node(value)
                else [(list(where), value)])
    return out


def _unflatten(entries: List[Tuple[List[str], torch.Tensor]]) -> Dict:
    root: Dict[str, Any] = {}
    for path, leaf in entries:
        d = root
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = leaf
    return root


def save_tree(path: str, tree: Any) -> str:
    """Write a nested-dict tree of tensors (any device) or numpy arrays to
    one blob file, leaf by leaf: the host holds one leaf's bytes at a
    time. The file appears under its name only once it is complete."""
    leaves = _flatten(tree)
    meta = []
    off = 0
    for p, leaf in leaves:
        off = (off + _ALIGN - 1) & ~(_ALIGN - 1)
        if isinstance(leaf, torch.Tensor):
            name = str(leaf.dtype).removeprefix("torch.")
            nbytes = leaf.numel() * leaf.element_size()
        else:
            a = np.asarray(leaf)
            name, nbytes = a.dtype.name, a.nbytes
        meta.append({"path": p, "dtype": name, "shape": list(leaf.shape),
                     "offset": off, "nbytes": int(nbytes)})
        off += nbytes
    header = json.dumps({"entries": meta}).encode()
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(header).to_bytes(8, "little"))
        f.write(header)
        f.write(b"\0" * ((-f.tell()) % _ALIGN))
        base = f.tell()
        for e, (_, leaf) in zip(meta, leaves):
            f.seek(base + e["offset"])
            f.write(_as_bytes(leaf).reshape(-1).view(np.uint8).data)  # 0-d safe
    os.replace(tmp, path)
    return path


def load_tree(path: str, mmap: bool = True) -> Dict[str, Any]:
    """Read a blob back as a nested dict of CPU tensors: views of a
    copy-on-write memory map by default (zero-copy until consumed), or of
    one in-memory read with ``mmap=False``."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path!r} is not a CVTBLOB1 file")
        hlen = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(hlen))["entries"]
        pos = f.tell()
    base = (pos + _ALIGN - 1) & ~(_ALIGN - 1)
    raw = (np.memmap(path, dtype=np.uint8, mode="c") if mmap
           else np.fromfile(path, dtype=np.uint8))
    entries = []
    for e in meta:
        start = base + e["offset"]
        if start + e["nbytes"] > raw.size:
            raise ValueError(f"{path!r} is truncated: "
                             f"{'/'.join(e['path'])} ends past the file")
        entries.append((e["path"], from_bytes(
            raw[start:start + e["nbytes"]], e["dtype"], e["shape"])))
    return _unflatten(entries)
