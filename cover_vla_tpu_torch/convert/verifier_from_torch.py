"""Convert the SigLIP2 verifier torch checkpoints -> the port's parameters.

Two source formats:
  * open_clip SigLIP2 backbone state dict (timm ViT trunk + custom text
    transformer) -> `convert_siglip2_backbone`.
  * the merged ensemble .pt (the reference's efficient_ensemble_merged.py
    schema): {"ensemble_components": [ {module_name: state_dict, ...,
    "action_padding_value": float} ], optional metadata} ->
    `convert_ensemble_components` / `convert_merged_checkpoint`.

torch Linear [out, in] -> [in, out]; packed qkv / in_proj tensors are split
into per-projection kernels; per-layer tensors stacked along [depth]. Per
leaf dtypes as in the JAX package: tower weights in `dtype` (bf16) with
their layernorms in fp32; every head leaf in fp32, `logit_scale` and
`tave_temperature` as fp32 scalars of shape (). Results are `ParamTree`s
on `device` (CUDA unless given), converted on the host and checked against
the port's own tree for the config (`pi0_from_torch.place`).
"""

from __future__ import annotations

from typing import Any, Dict, List, Mapping

import torch

from cover_vla_tpu_torch.configs import (
    SiglipTextConfig, VerifierConfig, VitConfig)
from cover_vla_tpu_torch.convert.blob import host_tensor
from cover_vla_tpu_torch.convert.pi0_from_torch import (
    StateDict, _c, _patch_kernel, _stack, _t, meta_init, place)
from cover_vla_tpu_torch.models import siglip, verifier
from cover_vla_tpu_torch.models.params import ParamTree

_F32 = torch.float32


def _map(fn, tree):
    return {k: _map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def _ref(cfg: VerifierConfig, members: int = 1) -> ParamTree:
    """The port's verifier tree for `cfg` on the meta device."""
    return verifier.init_verifier(0, cfg, members, device="meta")


def _one_member(ref) -> Dict[str, Any]:
    """`ref` without its leading member axis."""
    return {k: _one_member(v) if isinstance(v, (Mapping, ParamTree))
            else torch.empty(v.shape[1:], dtype=v.dtype, device="meta")
            for k, v in ref.items()}


def _lin(sd, prefix):
    return {"kernel": _t(sd, prefix + ".weight").t(),
            "bias": _t(sd, prefix + ".bias")}


def _ln(sd, prefix):
    return {"scale": _t(sd, prefix + ".weight"),
            "bias": _t(sd, prefix + ".bias")}


def _qkv(w, b, n):
    """Split packed [3n, in] / [3n] projections into q, k, v."""
    return {name: {"kernel": w[i * n:(i + 1) * n].t(),
                   "bias": b[i * n:(i + 1) * n]}
            for i, name in enumerate(("q", "k", "v"))}


def _f32(tree):
    return _map(lambda x: _c(x, _F32), tree)


# --------------------------------------------------------------------------
# Backbone
# --------------------------------------------------------------------------


def _timm_vit(sd: StateDict, cfg: VitConfig, prefix: str,
              dtype: torch.dtype) -> Dict[str, Any]:
    def layer(i):
        p = f"{prefix}.blocks.{i}."
        return {
            "ln1": _ln(sd, p + "norm1"),
            "attn": {**_qkv(_t(sd, p + "attn.qkv.weight"),
                            _t(sd, p + "attn.qkv.bias"), cfg.width),
                     "o": _lin(sd, p + "attn.proj")},
            "ln2": _ln(sd, p + "norm2"),
            "mlp": {"fc1": _lin(sd, p + "mlp.fc1"),
                    "fc2": _lin(sd, p + "mlp.fc2")},
        }

    pos = _t(sd, f"{prefix}.pos_embed")
    if pos.dim() == 3:
        pos = pos[0]
    return {
        "patch_embed": {
            "kernel": _c(_patch_kernel(
                _t(sd, f"{prefix}.patch_embed.proj.weight")), dtype),
            "bias": _c(_t(sd, f"{prefix}.patch_embed.proj.bias"), dtype)},
        "pos_emb": _c(pos, dtype),
        "blocks": _stack(layer, cfg.depth, dtype, ln_keys=("ln1", "ln2")),
        "final_ln": _f32(_ln(sd, f"{prefix}.norm")),
    }


def convert_timm_vit(sd: StateDict, cfg: VitConfig,
                     prefix: str = "visual.trunk", dtype=torch.bfloat16,
                     device=None) -> ParamTree:
    """timm ViT (qkv packed) -> our ViT params."""
    return place(_timm_vit(sd, cfg, prefix, dtype),
                 siglip.init_vit(meta_init(), cfg), device)


def _openclip_text(sd: StateDict, cfg: SiglipTextConfig, prefix: str,
                   dtype: torch.dtype) -> Dict[str, Any]:
    def layer(i):
        p = f"{prefix}.transformer.resblocks.{i}."
        return {
            "ln1": _ln(sd, p + "ln_1"),
            "attn": {**_qkv(_t(sd, p + "attn.in_proj_weight"),
                            _t(sd, p + "attn.in_proj_bias"), cfg.width),
                     "o": _lin(sd, p + "attn.out_proj")},
            "ln2": _ln(sd, p + "ln_2"),
            "mlp": {"fc1": _lin(sd, p + "mlp.c_fc"),
                    "fc2": _lin(sd, p + "mlp.c_proj")},
        }

    return {
        "token_embed": _c(_t(sd, f"{prefix}.token_embedding.weight"), dtype),
        "pos_emb": _c(_t(sd, f"{prefix}.positional_embedding"), dtype),
        "blocks": _stack(layer, cfg.depth, dtype, ln_keys=("ln1", "ln2")),
        "ln_final": _f32(_ln(sd, f"{prefix}.ln_final")),
        "text_projection": _f32(_lin(sd, f"{prefix}.text_projection")),
    }


def convert_openclip_text(sd: StateDict, cfg: SiglipTextConfig,
                          prefix: str = "text", dtype=torch.bfloat16,
                          device=None) -> ParamTree:
    """open_clip custom TextTransformer (in_proj packed) -> our text tower."""
    return place(_openclip_text(sd, cfg, prefix, dtype),
                 siglip.init_text_tower(meta_init(), cfg), device)


def _siglip2_backbone(sd, cfg, dtype):
    return {"vision": _timm_vit(sd, cfg.vision, "visual.trunk", dtype),
            "text": _openclip_text(sd, cfg.text, "text", dtype)}


def convert_siglip2_backbone(sd: StateDict, cfg: VerifierConfig,
                             dtype=torch.bfloat16, device=None) -> ParamTree:
    return place(_siglip2_backbone(sd, cfg, dtype), _ref(cfg)["backbone"],
                 device)


# --------------------------------------------------------------------------
# Trainable heads (per ensemble member)
# --------------------------------------------------------------------------


def _attention_pooling(sd: StateDict, cfg: VerifierConfig) -> Dict[str, Any]:
    """AttentionPooling state dict (the reference model.py:76-112) -> fp32
    params. nn.MultiheadAttention with kdim != embed_dim stores separate
    q/k/v_proj_weight plus a packed in_proj_bias."""
    inter = _t(sd, "query").shape[-1]

    def layer(i):
        p = f"blocks.{i}."
        ap = p + "attention."
        b = _t(sd, ap + "in_proj_bias")
        if ap + "q_proj_weight" in sd:
            # q is [inter, inter], k and v [inter, kv_dim]
            attn = {n: {"kernel": _t(sd, ap + f"{n}_proj_weight").t(),
                        "bias": b[i * inter:(i + 1) * inter]}
                    for i, n in enumerate(("q", "k", "v"))}
        else:  # same-dim case: packed in_proj_weight
            attn = _qkv(_t(sd, ap + "in_proj_weight"), b, inter)
        return {
            "q_ln": _ln(sd, p + "q_layer_norm"),
            "attn": {**attn, "o": _lin(sd, ap + "out_proj")},
            "ln": _ln(sd, p + "layer_norm"),
            "mlp": {"fc1": _lin(sd, p + "mlp.fc1"),
                    "fc2": _lin(sd, p + "mlp.fc2")},
        }

    return {
        "query": _c(_t(sd, "query").reshape(-1, inter), _F32),
        "blocks": _stack(layer, cfg.pooling_layers, _F32),
        "final_ln": _f32(_ln(sd, "layer_norm")),
    }


def _convert_attention_pooling(sd: StateDict, cfg: VerifierConfig,
                               kv_dim: int, device=None) -> ParamTree:
    """One member's attention pooling over keys of width `kv_dim` (the
    vision tower's width for the vision pooling, else the text's)."""
    out = (cfg.vision_pooling_output_dim if kv_dim == cfg.vision.width
           else cfg.text_pooling_output_dim)
    ref = verifier.init_attention_pooling(
        meta_init(), 1, kv_dim, out, cfg.pooling_layers, cfg.num_readouts)
    return place(_attention_pooling(sd, cfg), _one_member(ref), device)


def _traj_encoder(sd: StateDict, cfg: VerifierConfig, d: int):
    def layer(i):
        p = f"layers.{i}."
        return {
            "attn": {**_qkv(_t(sd, p + "self_attn.in_proj_weight"),
                            _t(sd, p + "self_attn.in_proj_bias"), d),
                     "o": _lin(sd, p + "self_attn.out_proj")},
            "ln1": _ln(sd, p + "norm1"),
            "fc1": _lin(sd, p + "linear1"),
            "fc2": _lin(sd, p + "linear2"),
            "ln2": _ln(sd, p + "norm2"),
        }

    return _stack(layer, cfg.traj_layers, _F32)


def _convert_traj_encoder(sd: StateDict, cfg: VerifierConfig, d: int,
                          device=None) -> ParamTree:
    """nn.TransformerEncoder state dict -> our post-LN encoder params."""
    ref = verifier.init_traj_encoder(meta_init(), 1, d, cfg.traj_layers)
    return place(_traj_encoder(sd, cfg, d), _one_member(ref), device)


def _lin_module(sd: StateDict) -> Dict[str, torch.Tensor]:
    """A bare nn.Linear module state dict ({'weight','bias'}), fp32."""
    return _f32({"kernel": _t(sd, "weight").t(), "bias": _t(sd, "bias")})


def _scalar(x) -> torch.Tensor:
    return _c(host_tensor(x).reshape(()), _F32)


def _member(component: Mapping[str, Any], cfg: VerifierConfig):
    tave = component["text_aware_visual_extraction"]
    return {
        "logit_scale": _scalar(component.get("logit_scale",
                                             cfg.logit_scale_init)),
        "tave_temperature": _scalar(tave["temperature"]),
        "text_pooling": _attention_pooling(component["text_pooling"], cfg),
        "vision_pooling": _attention_pooling(component["vision_poolings"],
                                             cfg),
        "input_projection": _lin_module(component["input_projection"]),
        "action_in": _lin_module(component["single_step_action_encoder"]),
        "traj": _traj_encoder(component["trajectory_encoder"], cfg,
                              cfg.vision_pooling_output_dim),
    }


def convert_member(component: Mapping[str, Any], cfg: VerifierConfig,
                   device=None) -> ParamTree:
    """One ensemble_components entry -> our member params."""
    return place(_member(component, cfg), _one_member(_ref(cfg)["members"]),
                 device)


def _stack_members(members: List[Dict[str, Any]]) -> Dict[str, Any]:
    first = members[0]
    return {k: _stack_members([m[k] for m in members])
            if isinstance(first[k], dict)
            else torch.stack([m[k] for m in members]) for k in first}


def _ensemble_components(components, cfg):
    return _stack_members([_member(c, cfg) for c in components])


def convert_ensemble_components(components: List[Mapping[str, Any]],
                                cfg: VerifierConfig,
                                device=None) -> ParamTree:
    """Members stacked along a leading member axis."""
    return place(_ensemble_components(components, cfg),
                 _ref(cfg, len(components))["members"], device)


def _fp32_tensors(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().float()
    if isinstance(tree, Mapping):
        return {k: _fp32_tensors(v) for k, v in tree.items()}
    return tree


def convert_merged_checkpoint(path: str, cfg: VerifierConfig,
                              backbone_sd: StateDict = None,
                              dtype=torch.bfloat16,
                              device=None) -> ParamTree:
    """Load a merged .pt and build verifier params: "members", plus
    "backbone" when the open_clip SigLIP2 state dict is given (the merged
    .pt holds heads only, as published).

    ``torch.load(weights_only=False)`` as in the JAX package: the merged
    file may pickle metadata objects beside the tensors, which PyTorch's
    restricted unpickler (the default from 2.6) refuses. Unpickling can
    run code, so load only files you trust."""
    raw = torch.load(path, map_location="cpu", weights_only=False)
    components = [_fp32_tensors(c) for c in raw["ensemble_components"]]
    params: Dict[str, Any] = {
        "members": _ensemble_components(components, cfg)}
    ref = _ref(cfg, len(components))
    if backbone_sd is not None:
        params["backbone"] = _siglip2_backbone(backbone_sd, cfg, dtype)
    else:
        ref = {"members": ref["members"]}
    return place(params, ref, device)
