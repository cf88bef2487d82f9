"""Convert lerobot pi0 torch checkpoints -> the port's parameter trees.

Source format: the HF-hub / save_pretrained safetensors of `PI0Policy`
(lerobot's modeling_pi0.py), with keys under
  model.paligemma_with_expert.paligemma.*    (PaliGemma-3B + SigLIP tower)
  model.paligemma_with_expert.gemma_expert.* (action expert)
  model.{state_proj,action_in_proj,action_out_proj,action_time_mlp_in,out}
  normalize_inputs / normalize_targets / unnormalize_outputs buffers.

Converters take a {name: tensor or numpy array} state dict (`load_state_dict`
reads .safetensors with the port's own parser, and .pt / .bin files) and
return a `ParamTree` in the layout of `pi0.init_pi0`, on `device` (CUDA
unless given). The conversion itself runs on the host: each leaf is cast
to its parameter dtype in torch (round to nearest even, bit-equal to the
JAX package's numpy/ml_dtypes cast) and the tree reaches the device in one
pass at the end, through `place`, which checks it against the port's own
tree for the same config.

Layout notes:
  * torch Linear weights are [out, in] -> transposed to [in, out].
  * per-layer tensors are stacked along a leading [depth] axis, one
    stacked leaf at a time (`_stack`): the host holds the output tree and
    the memory-mapped source, never several copies of a stack.
  * conv patch embedding [W, C, kh, kw] -> [(kh kw C), W] matching
    ops.image.patchify's (row, col, channel) flattening.
"""

from __future__ import annotations

import json
import re
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from cover_vla_tpu_torch.configs import GemmaConfig, Pi0Config, VitConfig
from cover_vla_tpu_torch.convert import from_jax
from cover_vla_tpu_torch.convert.blob import from_bytes, host_tensor
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import gemma, siglip
from cover_vla_tpu_torch.models.params import Init, ParamTree

StateDict = Mapping[str, Any]

# safetensors dtype codes -> the blob reader's dtype names
_SAFETENSORS_DTYPES = {
    "F64": "float64", "F32": "float32", "F16": "float16",
    "BF16": "bfloat16", "I64": "int64", "I32": "int32", "I16": "int16",
    "I8": "int8", "U8": "uint8", "BOOL": "bool"}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A .safetensors file as {name: CPU tensor} over a copy-on-write
    memory map (nothing is read until a tensor is consumed). The format: a
    u64 little-endian header length, a JSON header {name: {dtype, shape,
    data_offsets}} (plus an optional "__metadata__" entry), then the data;
    offsets are relative to the end of the header."""
    with open(path, "rb") as f:
        hlen = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(hlen))
    raw = np.memmap(path, dtype=np.uint8, mode="c")
    base, size = 8 + hlen, raw.size - 8 - hlen
    out = {}
    for name, e in header.items():
        if name == "__metadata__":
            continue
        if e["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path!r}: {name} has unsupported dtype "
                             f"{e['dtype']}")
        dtype = _SAFETENSORS_DTYPES[e["dtype"]]
        begin, end = e["data_offsets"]
        item = 2 if dtype == "bfloat16" else np.dtype(dtype).itemsize
        if not 0 <= begin <= end <= size or \
                end - begin != item * int(np.prod(e["shape"])):
            raise ValueError(f"{path!r}: {name} has data offsets "
                             f"{e['data_offsets']} that do not fit its shape "
                             f"{e['shape']} or the file")
        out[name] = from_bytes(raw[base + begin:base + end], dtype,
                               e["shape"])
    return out


def load_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Read a .safetensors or torch .pt/.bin file into CPU tensors
    (floats of a .pt/.bin as fp32, as the JAX package reads them).

    .pt/.bin go through ``torch.load(weights_only=False)``, as in the JAX
    package: lerobot and HF pickles may hold non-tensor objects beside the
    weights, which PyTorch's restricted unpickler (the default from 2.6)
    refuses. Unpickling can run code, so load only files you trust."""
    if path.endswith(".safetensors"):
        return read_safetensors(path)
    raw = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    return {k: v.detach().float() if isinstance(v, torch.Tensor)
            else host_tensor(np.asarray(v)) for k, v in raw.items()}


def _t(sd: StateDict, key: str) -> torch.Tensor:
    return host_tensor(sd[key])


def _c(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Host-side cast (round to nearest even, as numpy/ml_dtypes does) to
    a contiguous tensor; a leaf already in `dtype` and layout stays a view
    of its source."""
    return x.to(dtype).contiguous()


def _stack(fn: Callable[[int], Dict[str, Any]], depth: int,
           dtype: torch.dtype, ln_keys=()) -> Dict[str, Any]:
    """Stack per-layer trees of source views along a new leading [depth]
    axis, one stacked leaf at a time: each layer's view is cast into its
    slot of a preallocated stack (leaves under a key of `ln_keys` in fp32,
    the rest in `dtype`)."""
    layers = [fn(i) for i in range(depth)]

    def walk(nodes, in_ln):
        first = nodes[0]
        if isinstance(first, dict):
            return {k: walk([n[k] for n in nodes], in_ln or k in ln_keys)
                    for k in first}
        out = torch.empty((depth, *first.shape),
                          dtype=torch.float32 if in_ln else dtype)
        for i, x in enumerate(nodes):
            out[i].copy_(x)
        return out

    return walk(layers, False)


def meta_init() -> Init:
    """An `Init` on the meta device: the port's own trees as shapes and
    dtypes only, for `place` to check against."""
    return Init(0, torch.device("meta"))


def place(tree: Dict[str, Any], ref, device=None) -> ParamTree:
    """A host tree as a `ParamTree` on `device` (CUDA unless given), one
    pass over the leaves, checked by `from_jax.place_like` against `ref`
    (the port's own tree for the same config, on the meta device): the
    same keys, every leaf the same shape."""
    return ParamTree(from_jax.place_like(tree, ref, resolve_device(device)))


# --------------------------------------------------------------------------
# Gemma decoder stack (HF naming: model.layers.N.*)
# --------------------------------------------------------------------------


def _gemma(sd: StateDict, cfg: GemmaConfig, prefix: str, embed: bool,
           dtype: torch.dtype) -> Dict[str, Any]:
    prefix = prefix + "." if prefix and not prefix.endswith(".") else prefix

    def layer(i: int) -> Dict[str, torch.Tensor]:
        p = f"{prefix}layers.{i}."

        def w(name: str) -> torch.Tensor:
            return _t(sd, p + name).t()

        return {
            "input_ln": _t(sd, p + "input_layernorm.weight"),
            "q": w("self_attn.q_proj.weight"),
            "k": w("self_attn.k_proj.weight"),
            "v": w("self_attn.v_proj.weight"),
            "o": w("self_attn.o_proj.weight"),
            "post_ln": _t(sd, p + "post_attention_layernorm.weight"),
            "gate": w("mlp.gate_proj.weight"),
            "up": w("mlp.up_proj.weight"),
            "down": w("mlp.down_proj.weight"),
        }

    out = {
        "layers": _stack(layer, cfg.depth, dtype,
                         ln_keys=("input_ln", "post_ln")),
        "final_norm": _c(_t(sd, f"{prefix}norm.weight"), torch.float32),
    }
    if embed:
        out["embed"] = _c(_t(sd, f"{prefix}embed_tokens.weight"), dtype)
    return out


def convert_gemma(sd: StateDict, cfg: GemmaConfig, prefix: str,
                  embed: bool, dtype=torch.bfloat16,
                  device=None) -> ParamTree:
    ref = gemma.init_gemma(meta_init(), cfg)
    if not embed:
        ref.pop("embed", None)
    return place(_gemma(sd, cfg, prefix, embed, dtype), ref, device)


# --------------------------------------------------------------------------
# SigLIP vision tower (HF naming: vision_model.*)
# --------------------------------------------------------------------------


def _patch_kernel(conv_w: torch.Tensor) -> torch.Tensor:
    """[W, C, kh, kw] -> [(kh kw C), W]."""
    return conv_w.permute(2, 3, 1, 0).reshape(-1, conv_w.shape[0])


def _siglip_vision(sd: StateDict, cfg: VitConfig, prefix: str,
                   dtype: torch.dtype) -> Dict[str, Any]:
    p = prefix + ".embeddings."

    def layer(i: int) -> Dict[str, Any]:
        q = f"{prefix}.encoder.layers.{i}."

        def lin(name: str) -> Dict[str, torch.Tensor]:
            return {"kernel": _t(sd, q + name + ".weight").t(),
                    "bias": _t(sd, q + name + ".bias")}

        def ln(name: str) -> Dict[str, torch.Tensor]:
            return {"scale": _t(sd, q + name + ".weight"),
                    "bias": _t(sd, q + name + ".bias")}

        return {
            "ln1": ln("layer_norm1"),
            "attn": {"q": lin("self_attn.q_proj"),
                     "k": lin("self_attn.k_proj"),
                     "v": lin("self_attn.v_proj"),
                     "o": lin("self_attn.out_proj")},
            "ln2": ln("layer_norm2"),
            "mlp": {"fc1": lin("mlp.fc1"), "fc2": lin("mlp.fc2")},
        }

    return {
        "patch_embed": {
            "kernel": _c(_patch_kernel(_t(sd, p + "patch_embedding.weight")),
                         dtype),
            "bias": _c(_t(sd, p + "patch_embedding.bias"), dtype)},
        "pos_emb": _c(_t(sd, p + "position_embedding.weight"), dtype),
        "blocks": _stack(layer, cfg.depth, dtype, ln_keys=("ln1", "ln2")),
        "final_ln": {
            "scale": _c(_t(sd, prefix + ".post_layernorm.weight"),
                        torch.float32),
            "bias": _c(_t(sd, prefix + ".post_layernorm.bias"),
                       torch.float32)},
    }


def convert_siglip_vision(sd: StateDict, cfg: VitConfig, prefix: str,
                          dtype=torch.bfloat16, device=None) -> ParamTree:
    return place(_siglip_vision(sd, cfg, prefix, dtype),
                 siglip.init_vit(meta_init(), cfg), device)


# --------------------------------------------------------------------------
# Full pi0 policy
# --------------------------------------------------------------------------

_PI0_ROOT = "model.paligemma_with_expert."


def find_prefix(keys, candidates, suffix: str = "") -> Optional[str]:
    """The first candidate prefix that some key starts with (+ suffix)."""
    for cand in candidates:
        if any(k.startswith(cand + suffix) for k in keys):
            return cand
    return None


def _pi0(sd: StateDict, cfg: Pi0Config, dtype: torch.dtype) -> Dict[str, Any]:
    keys = list(sd.keys())
    root = find_prefix(keys, (_PI0_ROOT,)) or ""
    pali = root + "paligemma."
    # transformers renamed language_model paths across versions
    lm_prefix = find_prefix(keys, (pali + "language_model.model",
                                   pali + "model.language_model",
                                   pali + "language_model"), ".layers.0.")
    if lm_prefix is None:
        raise KeyError("could not locate PaliGemma language model layers")
    vt_prefix = find_prefix(keys, (pali + "vision_tower.vision_model",
                                   pali + "model.vision_tower.vision_model"))
    mm_prefix = pali + ("multi_modal_projector"
                        if pali + "multi_modal_projector.linear.weight"
                        in sd or pali + "multi_modal_projector.weight" in sd
                        else "model.multi_modal_projector")
    mm_key = mm_prefix + (".linear" if mm_prefix + ".linear.weight" in sd
                          else "")

    def proj(name):
        return {"kernel": _c(_t(sd, f"model.{name}.weight").t(),
                             torch.float32),
                "bias": _c(_t(sd, f"model.{name}.bias"), torch.float32)}

    return {
        "vision": _siglip_vision(sd, cfg.vision, vt_prefix, dtype),
        "mm_proj": {"kernel": _c(_t(sd, mm_key + ".weight").t(),
                                 torch.float32),
                    "bias": _c(_t(sd, mm_key + ".bias"), torch.float32)},
        "paligemma": _gemma(sd, cfg.paligemma, lm_prefix, True, dtype),
        "expert": _gemma(sd, cfg.expert, root + "gemma_expert.model", False,
                         dtype),
        "state_proj": proj("state_proj"),
        "action_in_proj": proj("action_in_proj"),
        "action_out_proj": proj("action_out_proj"),
        "time_mlp_in": proj("action_time_mlp_in"),
        "time_mlp_out": proj("action_time_mlp_out"),
    }


def convert_pi0(sd: StateDict, cfg: Pi0Config, dtype=torch.bfloat16,
                device=None) -> ParamTree:
    """Full PI0Policy state dict -> the port's parameter tree on `device`.

    Handles both the lerobot layout (model.paligemma_with_expert...) and a
    bare PaliGemmaWithExpertModel layout (auto-detected by key prefix).
    """
    return from_jax.pi0_from_jax(_pi0(sd, cfg, dtype), cfg, device)


def extract_norm_stats(sd: StateDict) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
    """Pull the lerobot Normalize/Unnormalize buffers if present (numpy)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    pat = re.compile(
        r"(normalize_inputs|normalize_targets|unnormalize_outputs)"
        r"\.buffer_(.+)\.(mean|std|min|max)")
    for k, v in sd.items():
        m = pat.fullmatch(k)
        if m:
            out.setdefault(f"{m.group(1)}.{m.group(2)}", {})[m.group(3)] = \
                (v.float() if v.dtype == torch.bfloat16 else v).numpy() \
                if isinstance(v, torch.Tensor) else np.asarray(v)
    return out or None
