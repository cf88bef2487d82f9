"""Path-dispatching checkpoint loaders for serving/eval model switching.

The reference evaluator iterates checkpoints over RPC, and the server's
`switch_model` verb loads whatever format the path points at. Formats
accepted here (the JAX package's, with the port's blob directory in
orbax's place):

  policy:   * a blob directory (`checkpoints.save_params`)
            * an HF save_pretrained directory holding model.safetensors
              (lerobot pi0 layout)
            * a bare .safetensors / .pt / .bin state-dict file
  verifier: * a blob directory
            * a merged-ensemble .pt (`ensemble_components` schema), which
              holds the heads only: the backbone comes from the caller

Torch-format sources are converted once. The conversion runs on CPU
tensors; the host tree is written to ``<file>.torchcache/params.blob``
beside the source, keyed on the source's mtime and size (the port's own
directory name, so neither package trusts the other's ``.jaxcache``), and
reaches the device in one pass at the end. A cached load memory-maps the
blob and moves it to the device; a stale or corrupt cache is converted
again, and where the cache cannot be written the model is served
uncached. Every load is checked against the config's own tree (same keys
and shapes) before it is returned, so a caller that swaps parameters only
after a load returns never serves a half-loaded or mismatched tree.

The JAX package needs a separate host-array mode for its converters
(``hostmode.py``) to keep the tree off the device until the cache is
written; here a CPU tensor already is a host array, so that module has no
counterpart. Each stage's seconds are logged at INFO with
``extra={"stage": ..., "seconds": ...}``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict

from cover_vla_tpu_torch.configs import Pi0Config, VerifierConfig
from cover_vla_tpu_torch.convert import blob, checkpoints, from_jax
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models.params import ParamTree

log = logging.getLogger(__name__)

CACHE_SUFFIX = ".torchcache"
_TORCH_FORMATS = (".safetensors", ".pt", ".bin")


def _stage(name: str, t0: float, src: str) -> None:
    seconds = time.perf_counter() - t0
    log.info("%s: %s %.3f s", src, name, seconds,
             extra={"stage": name, "seconds": seconds})


def _cache_key(src: str) -> Dict[str, Any]:
    st = os.stat(src)
    return {"mtime": st.st_mtime, "size": st.st_size}


def _cached_convert(src: str, convert_fn: Callable[[], Any],
                    cache: bool) -> Dict[str, Any]:
    """Convert-once wrapper: the host tree (CPU tensors) of `src`, from a
    memory-mapped ``<src>.torchcache/params.blob`` when its meta matches
    the source file, else from `convert_fn()`, whose result is written to
    the cache (best effort: an unwritable location serves uncached)."""
    if not cache:
        return convert_fn()
    cache_dir = src + CACHE_SUFFIX
    meta_path = os.path.join(cache_dir, "meta.json")
    blob_path = os.path.join(cache_dir, checkpoints.BLOB_NAME)
    key = _cache_key(src)
    try:
        with open(meta_path) as f:
            if json.load(f) == key:
                return blob.load_tree(blob_path)
    except FileNotFoundError:
        pass
    except (OSError, ValueError, KeyError, TypeError, RuntimeError) as e:
        log.warning("%s: unreadable cache (%s: %s), converting again",
                    src, type(e).__name__, e)
    t0 = time.perf_counter()
    host = convert_fn()
    _stage("convert", t0, src)
    t0 = time.perf_counter()
    try:
        os.makedirs(cache_dir, exist_ok=True)
        blob.save_tree(blob_path, host)
        with open(meta_path, "w") as f:
            json.dump(key, f)
    except OSError as e:
        log.warning("%s: cache not written (%s), serving uncached", src, e)
    else:
        _stage("cache_write", t0, src)
    return host


def _host_tree(path: str, convert: Callable[[Dict], Any], cache: bool):
    """The host tree of a policy-like checkpoint at `path`."""
    if os.path.isdir(path):
        st = os.path.join(path, "model.safetensors")
        if os.path.exists(st):
            path = st
        else:
            return checkpoints.load_params(path, device="cpu")
    if path.endswith(_TORCH_FORMATS):
        from cover_vla_tpu_torch.convert.pi0_from_torch import load_state_dict
        return _cached_convert(path, lambda: convert(load_state_dict(path)),
                               cache)
    raise FileNotFoundError(f"unrecognised policy checkpoint: {path!r}")


def _to_device(src: str, place: Callable[[], ParamTree]) -> ParamTree:
    t0 = time.perf_counter()
    out = place()
    _stage("to_device", t0, src)
    return out


def load_policy_params(path: str, cfg: Pi0Config, cache: bool = True,
                       device=None) -> ParamTree:
    """Load pi0 params from any supported checkpoint format (see module
    docstring) onto `device` (CUDA unless given). Raises FileNotFoundError
    / KeyError / ValueError on bad paths or layouts."""
    from cover_vla_tpu_torch.convert.pi0_from_torch import convert_pi0
    dev = resolve_device(device)
    host = _host_tree(path, lambda sd: convert_pi0(sd, cfg, device="cpu"),
                      cache)
    return _to_device(path, lambda: from_jax.pi0_from_jax(host, cfg, dev))


def load_pi0fast_params(path: str, cfg, cache: bool = True,
                        device=None) -> ParamTree:
    """pi0-FAST params (`Pi0FastConfig`) from the same formats as
    `load_policy_params`, converted by `convert_pi0fast`."""
    from cover_vla_tpu_torch.convert.pi0fast_from_torch import (
        convert_pi0fast)
    dev = resolve_device(device)
    host = _host_tree(path,
                      lambda sd: convert_pi0fast(sd, cfg, device="cpu"),
                      cache)
    return _to_device(path,
                      lambda: from_jax.pi0fast_from_jax(host, cfg, dev))


def load_verifier_params(path: str, cfg: VerifierConfig,
                         backbone_params: Any = None, cache: bool = True,
                         device=None) -> ParamTree:
    """Load verifier params onto `device` (CUDA unless given). A merged
    .pt carries heads only: `backbone_params` (the currently served,
    possibly int8, SigLIP2 backbone) is reused as it is; without it the
    load raises ValueError."""
    dev = resolve_device(device)
    if os.path.isdir(path):
        host = checkpoints.load_params(path, device="cpu")
        return _to_device(
            path, lambda: from_jax.verifier_from_jax(host, cfg, dev))
    if not path.endswith(".pt"):
        raise FileNotFoundError(f"unrecognised verifier checkpoint: {path!r}")
    from cover_vla_tpu_torch.convert.verifier_from_torch import (
        convert_merged_checkpoint)
    host = _cached_convert(
        path, lambda: convert_merged_checkpoint(path, cfg, device="cpu"),
        cache)
    if "backbone" in host:
        return _to_device(
            path, lambda: from_jax.verifier_from_jax(host, cfg, dev))
    if backbone_params is None:
        raise ValueError(f"{path!r} is a heads-only merged ensemble and no "
                         "backbone params were supplied")
    from cover_vla_tpu_torch.models import verifier
    members = host["members"]
    ref = verifier.init_verifier(0, cfg, members["logit_scale"].shape[0],
                                 device="meta")
    return _to_device(path, lambda: ParamTree({
        "members": from_jax.place_like(members, ref["members"], dev),
        "backbone": backbone_params}))
