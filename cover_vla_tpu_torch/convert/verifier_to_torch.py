"""Export trained verifier members to the reference's merged-ensemble .pt.

The inverse of verifier_from_torch.convert_ensemble_components: produces
{"ensemble_components": [per-member module state dicts...]} in the schema
the reference's EfficientEnsembleMerged loads (the same schema the JAX
package writes), so a .pt written by either package loads in the other.

Layouts: our Linear kernels are [in, out] -> torch [out, in]; attention
pooling uses nn.MultiheadAttention's kdim != embed_dim format (separate
q/k/v_proj_weight + packed in_proj_bias); the trajectory encoder uses
nn.TransformerEncoder's packed in_proj_weight. Every exported tensor is an
fp32 CPU tensor with its own storage.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from cover_vla_tpu_torch.configs import VerifierConfig
from cover_vla_tpu_torch.models.params import take_layer


def _own(x: torch.Tensor) -> torch.Tensor:
    """An fp32 CPU copy with its own contiguous storage (a layer slice
    would otherwise save its whole stack)."""
    return x.detach().to("cpu", torch.float32).clone(
        memory_format=torch.contiguous_format)


def _lin_t(p) -> Dict[str, torch.Tensor]:
    return {"weight": _own(p["kernel"].t()), "bias": _own(p["bias"])}


def _ln_t(p) -> Dict[str, torch.Tensor]:
    return {"weight": _own(p["scale"]), "bias": _own(p["bias"])}


def _put(sd, prefix: str, module: Dict[str, torch.Tensor]) -> None:
    for k, v in module.items():
        sd[prefix + k] = v


def _export_attention_pooling(p, num_layers: int) -> Dict[str, torch.Tensor]:
    """Our AttentionPooling params -> the torch module's state dict (the
    reference model.py:76-112 layout)."""
    sd: Dict[str, torch.Tensor] = {"query": _own(p["query"])}
    for i in range(num_layers):
        layer = take_layer(p["blocks"], i)
        pre = f"blocks.{i}."
        at = layer["attn"]
        for n in ("q", "k", "v"):
            sd[pre + f"attention.{n}_proj_weight"] = _own(at[n]["kernel"].t())
        sd[pre + "attention.in_proj_bias"] = _own(torch.cat(
            [at[n]["bias"] for n in ("q", "k", "v")]))
        _put(sd, pre + "attention.out_proj.", _lin_t(at["o"]))
        _put(sd, pre + "q_layer_norm.", _ln_t(layer["q_ln"]))
        _put(sd, pre + "layer_norm.", _ln_t(layer["ln"]))
        _put(sd, pre + "mlp.fc1.", _lin_t(layer["mlp"]["fc1"]))
        _put(sd, pre + "mlp.fc2.", _lin_t(layer["mlp"]["fc2"]))
    _put(sd, "layer_norm.", _ln_t(p["final_ln"]))
    return sd


def _export_traj_encoder(p, num_layers: int) -> Dict[str, torch.Tensor]:
    """Our post-LN encoder params -> nn.TransformerEncoder state dict."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(num_layers):
        layer = take_layer(p, i)
        pre = f"layers.{i}."
        at = layer["attn"]
        sd[pre + "self_attn.in_proj_weight"] = _own(torch.cat(
            [at[n]["kernel"].t() for n in ("q", "k", "v")]))
        sd[pre + "self_attn.in_proj_bias"] = _own(torch.cat(
            [at[n]["bias"] for n in ("q", "k", "v")]))
        _put(sd, pre + "self_attn.out_proj.", _lin_t(at["o"]))
        _put(sd, pre + "norm1.", _ln_t(layer["ln1"]))
        _put(sd, pre + "norm2.", _ln_t(layer["ln2"]))
        _put(sd, pre + "linear1.", _lin_t(layer["fc1"]))
        _put(sd, pre + "linear2.", _lin_t(layer["fc2"]))
    return sd


def export_member(member, cfg: VerifierConfig) -> Dict[str, Any]:
    """One member's params (no member axis) -> one ensemble_components
    entry."""
    return {
        "logit_scale": _own(member["logit_scale"].reshape(())),
        "action_padding_value": float(cfg.action_padding_value),
        "text_aware_visual_extraction": {
            "temperature": _own(member["tave_temperature"].reshape(())),
        },
        "text_pooling": _export_attention_pooling(
            member["text_pooling"], cfg.pooling_layers),
        "vision_poolings": _export_attention_pooling(
            member["vision_pooling"], cfg.pooling_layers),
        "input_projection": _lin_t(member["input_projection"]),
        "single_step_action_encoder": _lin_t(member["action_in"]),
        "trajectory_encoder": _export_traj_encoder(
            member["traj"], cfg.traj_layers),
    }


def export_ensemble_components(members, cfg: VerifierConfig
                               ) -> List[Dict[str, Any]]:
    """Members tree (leading member axis) -> components list."""
    return [export_member(take_layer(members, m), cfg)
            for m in range(members["logit_scale"].shape[0])]


def save_merged_ensemble(path: str, members, cfg: VerifierConfig,
                         metadata: Dict[str, Any] = None) -> None:
    """Write the merged .pt (fp32 torch tensors, reference loader
    compatible)."""
    payload: Dict[str, Any] = {
        "ensemble_components": export_ensemble_components(members, cfg)}
    if metadata:
        payload.update(metadata)
    torch.save(payload, path)
