"""Carry parameter trees of the reference JAX package across to the port.

The input is the tree that ``pi0.init_pi0`` / ``verifier.init_verifier`` /
``pi0fast.init_pi0fast`` (or a checkpoint loader) returns, with every
leaf already turned into a numpy array
(``jax.tree_util.tree_map(np.asarray, tree)``). The port keeps
the same layout, so conversion copies each leaf to a tensor. bf16 leaves
arrive with numpy's ``bfloat16`` extension dtype, which ``torch.from_numpy``
refuses; they are reinterpreted bit for bit through uint16. Host trees of
torch tensors (the port's own checkpoint loaders, `convert/loaders.py`)
take the same path: each leaf is moved to the device as it is.

The structure is checked against the port's own initialiser for the same
config: every leaf must exist with the same shape. Dtypes are kept as
given, so a tree cast to fp32 stays fp32 (the parity tests use that).

``load_pickle`` reads a tree that the JAX package pickled (the
verification-scaling experiment's ``*_params.pkl`` and ``stats.pkl``)
without ``ml_dtypes`` or the JAX package: a bf16 leaf arrives as its
uint16 bits, and ``place_like`` views it as bf16 where the port's
reference tree has a bf16 leaf.
"""

from __future__ import annotations

import pickle
from typing import Mapping

import numpy as np
import torch

from cover_vla_tpu_torch.configs import Pi0Config, VerifierConfig
from cover_vla_tpu_torch.data import stats
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import pi0, pi0fast, verifier
from cover_vla_tpu_torch.models.params import ParamTree


def to_tensor(x, device) -> torch.Tensor:
    """numpy array (any float dtype, incl. bfloat16) or tensor -> tensor on
    device."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    x = np.array(x)                     # an owned, writable copy
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(x).to(device)


# The JAX package's module of the statistics dataclasses, spelt in two
# parts because no source of the port names a module of the JAX package.
_JAX_STATS_MODULE = "cover_vla_tpu" + ".data.stats"
_STATS_CLASSES = ("DatasetStatistics", "FieldStats")


class _JaxTreeUnpickler(pickle.Unpickler):
    """numpy arrays, builtins and the JAX package's statistics classes
    (taken from the port's `data.stats`); the bf16 dtype of ``ml_dtypes``
    becomes ``np.uint16`` (same width, same bytes). Every other global,
    under the JAX package, ``ml_dtypes`` or elsewhere, is refused by
    name."""

    def find_class(self, module, name):
        if module == "ml_dtypes" and name == "bfloat16":
            return np.uint16
        if module == _JAX_STATS_MODULE and name in _STATS_CLASSES:
            return getattr(stats, name)
        if module.split(".")[0] in ("numpy", "builtins", "collections",
                                    "_codecs", "copyreg"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to load {module}.{name}")


def load_pickle(path: str):
    """A tree (or stats object) that the JAX package pickled, read without
    ``ml_dtypes`` or the JAX package; bf16 leaves come back as uint16
    arrays holding their bits."""
    with open(path, "rb") as f:
        return _JaxTreeUnpickler(f).load()


def place_like(tree: Mapping, ref, device, path: str = "") -> dict:
    """`tree`'s leaves as tensors on `device` (resolved), checked against
    `ref`: the same keys, every leaf the same shape. A uint16 numpy leaf
    whose reference leaf is bf16 holds bf16 bits (`load_pickle`) and is
    viewed as bf16."""
    out = {}
    for key, value in tree.items():
        where = f"{path}/{key}"
        if ref is not None and key not in ref:
            raise KeyError(f"unexpected parameter {where}")
        sub = ref[key] if ref is not None else None
        if isinstance(value, (Mapping, ParamTree)):
            out[key] = place_like(value, sub, device, where)
            continue
        if (sub is not None and sub.dtype == torch.bfloat16
                and isinstance(value, np.ndarray) and value.dtype == np.uint16):
            t = torch.from_numpy(np.array(value)).view(torch.bfloat16).to(device)
        else:
            t = to_tensor(value, device)
        if sub is not None and t.shape != sub.shape:
            raise ValueError(f"{where}: got shape {tuple(t.shape)}, "
                             f"expected {tuple(sub.shape)}")
        out[key] = t
    if ref is not None:
        missing = [k for k in ref if k not in tree]
        if missing:
            raise KeyError(f"missing parameters under {path or '/'}: {missing}")
    return out


def _reference_tree(init_fn) -> ParamTree:
    """The port's own tree on the meta device: shapes and dtypes only."""
    return init_fn(torch.device("meta"))


def pi0_from_jax(tree: Mapping, cfg: Pi0Config, device=None) -> ParamTree:
    """pi0 parameters from the reference package's (numpy) tree."""
    dev = resolve_device(device)
    ref = _reference_tree(lambda d: pi0.init_pi0(0, cfg, device=d))
    return ParamTree(place_like(tree, ref, dev))


def pi0fast_from_jax(tree: Mapping, cfg: pi0fast.Pi0FastConfig,
                     device=None) -> ParamTree:
    """pi0-FAST parameters from the reference package's (numpy) tree."""
    dev = resolve_device(device)
    ref = _reference_tree(lambda d: pi0fast.init_pi0fast(0, cfg, device=d))
    return ParamTree(place_like(tree, ref, dev))


def verifier_from_jax(tree: Mapping, cfg: VerifierConfig,
                      device=None) -> ParamTree:
    """Verifier parameters (any member count, optional "calibration")
    from the reference package's (numpy) tree."""
    dev = resolve_device(device)
    members = tree["members"]["logit_scale"].shape[0]
    ref = _reference_tree(lambda d: verifier.init_verifier(
        0, cfg, members, device=d))
    checked = {k: v for k, v in tree.items() if k != "calibration"}
    out = place_like(checked, ref, dev)
    if "calibration" in tree:
        out["calibration"] = place_like(tree["calibration"], None, dev)
    return ParamTree(out)
