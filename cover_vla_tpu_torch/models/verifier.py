"""SigLIP2 contrastive trajectory verifier + ensemble.

  * The frozen SigLIP2 backbone runs once; the trainable heads of the M
    ensemble members are stacked along a leading member axis and run as
    one batched computation (`_mlinear`), not a loop over members.
  * The patch features are the attention-sublayer output of the last ViT
    block (ClearCLIP style).

Semantics: L2 norms in fp32; the cross-attention block's residual uses
the post-norm query; the trajectory encoder is a post-LN transformer
(relu FFN, ff = 2*d) with top-padded histories masked where
action[..., 0] == -5.0; ensemble fusion is mean-then-renorm; inference
scores are raw cosine similarities. All head products run in true fp32
and the head attention is eager.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from cover_vla_tpu_torch.configs import VerifierConfig
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import siglip
from cover_vla_tpu_torch.models.params import Init, ParamTree, iter_layers
from cover_vla_tpu_torch.ops.attention import mha_attention
from cover_vla_tpu_torch.ops.norms import layer_norm
from cover_vla_tpu_torch.utils.monitor import to_device


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x.float(), dim=-1, keepdim=True)


def _mlinear(p, x: torch.Tensor) -> torch.Tensor:
    """Per-member linear: x [M, ..., in] @ kernel [M, in, out] + bias [M, out]."""
    k, b = p["kernel"], p["bias"]
    m = k.shape[0]
    y = torch.bmm(x.reshape(m, -1, x.shape[-1]), k)
    return y.reshape(*x.shape[:-1], k.shape[-1]) \
        + b.reshape(m, *([1] * (x.ndim - 2)), -1)


def _mln(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-member LayerNorm: scale/bias [M, dim], x [M, ..., dim]."""
    shape = (p["scale"].shape[0],) + (1,) * (x.ndim - 2) + (-1,)
    return layer_norm(x, p["scale"].reshape(shape), p["bias"].reshape(shape),
                      eps)


def sincos_position_embedding(seq_len: int, dim: int) -> np.ndarray:
    """[S, dim] cat(sin, cos) over 10000^(2i/dim)."""
    pos = np.arange(seq_len, dtype=np.float32)
    inv_freq = 1.0 / (10_000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    sinusoid = np.einsum("i,j->ij", pos, inv_freq)
    return np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _ln_init(init: Init, lead, dim: int) -> dict:
    return {"scale": init.ones((*lead, dim)), "bias": init.zeros((*lead, dim))}


def init_attention_pooling(init: Init, m: int, kv_dim: int, output_dim: int,
                           num_layers: int, num_readouts: int) -> dict:
    inter = output_dim // num_readouts
    lead = (m, num_layers)
    return {
        "query": init.normal((m, num_readouts, inter), 1.0, torch.float32),
        "blocks": {
            "q_ln": _ln_init(init, lead, inter),
            "attn": {"q": init.linear(inter, inter, lead),
                     "k": init.linear(kv_dim, inter, lead),
                     "v": init.linear(kv_dim, inter, lead),
                     "o": init.linear(inter, inter, lead)},
            "ln": _ln_init(init, lead, inter),
            "mlp": {"fc1": init.linear(inter, output_dim, lead),
                    "fc2": init.linear(output_dim, inter, lead)},
        },
        "final_ln": _ln_init(init, (m,), inter),
    }


def init_traj_encoder(init: Init, m: int, dim: int, num_layers: int) -> dict:
    lead = (m, num_layers)
    return {
        "attn": {"q": init.linear(dim, dim, lead),
                 "k": init.linear(dim, dim, lead),
                 "v": init.linear(dim, dim, lead),
                 "o": init.linear(dim, dim, lead)},
        "ln1": _ln_init(init, lead, dim),
        "fc1": init.linear(dim, 2 * dim, lead),
        "fc2": init.linear(2 * dim, dim, lead),
        "ln2": _ln_init(init, lead, dim),
    }


def _init_members(init: Init, cfg: VerifierConfig, m: int) -> dict:
    d = cfg.vision_pooling_output_dim
    return {
        "logit_scale": init.full((m,), cfg.logit_scale_init),
        "tave_temperature": init.full((m,), cfg.tave_temperature_init),
        "text_pooling": init_attention_pooling(
            init, m, cfg.text.embed_dim, cfg.text_pooling_output_dim,
            cfg.pooling_layers, cfg.num_readouts),
        "vision_pooling": init_attention_pooling(
            init, m, cfg.vision.width, d, cfg.pooling_layers,
            cfg.num_readouts),
        "input_projection": init.linear(cfg.fused_dim, d, (m,)),
        "action_in": init.linear(cfg.action_dim, d, (m,)),
        "traj": init_traj_encoder(init, m, d, cfg.traj_layers),
    }


def init_member(seed: int, cfg: VerifierConfig, num_members: int = 1, *,
                device=None) -> ParamTree:
    """Randomly initialised trainable heads of `num_members` members,
    member axis first (the reference's one member is num_members=1), on
    `device` (CUDA unless given)."""
    return ParamTree(_init_members(Init(seed, resolve_device(device)), cfg,
                                   num_members))


def init_verifier(seed: int, cfg: VerifierConfig, num_members: int = 1, *,
                  device=None) -> ParamTree:
    """Randomly initialised verifier with `num_members` stacked heads, on
    `device` (CUDA unless given)."""
    init = Init(seed, resolve_device(device))
    return ParamTree({
        "backbone": {"vision": siglip.init_vit(init, cfg.vision),
                     "text": siglip.init_text_tower(init, cfg.text)},
        "members": _init_members(init, cfg, num_members),
    })


def member_slice(members, i: int) -> dict:
    """Member i of a member-axis tree, keeping the axis (length 1)."""
    return {k: (member_slice(v, i) if isinstance(v, (Mapping, ParamTree))
                else v[i:i + 1]) for k, v in members.items()}


# ---------------------------------------------------------------------------
# Heads (member axis first)
# ---------------------------------------------------------------------------


def attention_pooling(p, x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Learned-readout cross-attention pool of all members at once.

    x: [M, B, T, kv_dim] -> [M, B, output_dim]. Per block: q_ln -> attn ->
    residual on the NORMED query -> ln -> mlp -> residual.
    """
    m, b = x.shape[:2]
    query = p["query"]                                   # [M, R, inter]
    r, inter = query.shape[1:]
    d = inter // num_heads
    q = query[:, None].expand(m, b, r, inter)
    depth = p["blocks"]["q_ln"]["scale"].shape[1]
    for layer in iter_layers(p["blocks"], depth, axis=1):
        qn = _mln(layer["q_ln"], q)
        qh = _mlinear(layer["attn"]["q"], qn).reshape(m * b, r, num_heads, d)
        kh = _mlinear(layer["attn"]["k"], x).reshape(m * b, -1, num_heads, d)
        vh = _mlinear(layer["attn"]["v"], x).reshape(m * b, -1, num_heads, d)
        attn = mha_attention(qh, kh, vh).reshape(m, b, r, inter)
        qn = qn + _mlinear(layer["attn"]["o"], attn)
        qn = _mln(layer["ln"], qn)
        y = F.gelu(_mlinear(layer["mlp"]["fc1"], qn), approximate="none")
        q = qn + _mlinear(layer["mlp"]["fc2"], y)
    q = _mln(p["final_ln"], q)
    return q.reshape(m, b, r * inter)


def traj_encoder(p, x: torch.Tensor, pad_mask: torch.Tensor,
                 num_heads: int) -> torch.Tensor:
    """Post-LN encoder. x: [M, B, H, D]; pad_mask: bool[B, H], True = PADDED."""
    m, b, h, dim = x.shape
    d = dim // num_heads
    attn_mask = (~pad_mask)[:, None, :].expand(b, h, h).repeat(m, 1, 1)
    for layer in iter_layers(p, p["ln1"]["scale"].shape[1], axis=1):
        qh = _mlinear(layer["attn"]["q"], x).reshape(m * b, h, num_heads, d)
        kh = _mlinear(layer["attn"]["k"], x).reshape(m * b, h, num_heads, d)
        vh = _mlinear(layer["attn"]["v"], x).reshape(m * b, h, num_heads, d)
        a = mha_attention(qh, kh, vh, mask=attn_mask).reshape(m, b, h, dim)
        x = _mln(layer["ln1"], x + _mlinear(layer["attn"]["o"], a))
        y = _mlinear(layer["fc2"], F.relu(_mlinear(layer["fc1"], x)))
        x = _mln(layer["ln2"], x + y)
    return x


# ---------------------------------------------------------------------------
# Full verifier
# ---------------------------------------------------------------------------


class SharedFeatures(NamedTuple):
    patch: torch.Tensor  # [B, P, W_v] fp32, L2-normalised per token
    text: torch.Tensor   # [B, T, E] fp32, L2-normalised per token


def extract_features(params: ParamTree, cfg: VerifierConfig,
                     images: torch.Tensor,
                     text_tokens: torch.Tensor) -> SharedFeatures:
    """Frozen-backbone features. images: [B, H, W, 3] in [-1, 1];
    text_tokens: int[B, T]."""
    vit_out = siglip.vit_forward(params["backbone"]["vision"], cfg.vision,
                                 images)
    patch = _l2norm(vit_out.last_attn_out.float())
    text_out = siglip.text_forward(params["backbone"]["text"], cfg.text,
                                   text_tokens)
    text = _l2norm(text_out.seq_features.float())
    return SharedFeatures(patch=patch, text=text)


def text_aware_visual_extraction(members, cfg: VerifierConfig,
                                 patch: torch.Tensor,
                                 text: torch.Tensor) -> torch.Tensor:
    """ClearCLIP text->patch attention of every member: [M, B, T, W_v]."""
    temp = members["tave_temperature"].clamp(0.0, 100.0)        # [M]
    sim = torch.einsum("bij,bkj->bik", text, patch)
    sim = sim[None] / temp[:, None, None, None]
    attn = torch.softmax(sim, dim=-1)
    pos = to_device(sincos_position_embedding(patch.shape[1],
                                              patch.shape[2]), patch.device)
    return torch.einsum("mbik,bkj->mbij", attn, patch + pos[None])


def member_image_text_embed(members, cfg: VerifierConfig,
                            feats: SharedFeatures) -> torch.Tensor:
    """Every member's fused image+text embedding [M, B, d], L2-normalised."""
    m = members["tave_temperature"].shape[0]
    tave = text_aware_visual_extraction(members, cfg, feats.patch, feats.text)
    vision_token = attention_pooling(members["vision_pooling"], tave,
                                     cfg.pooling_heads)
    text_token = attention_pooling(members["text_pooling"],
                                   feats.text[None].expand(m, *feats.text.shape),
                                   cfg.pooling_heads)
    combined = torch.cat([text_token, vision_token], dim=-1)
    return _l2norm(_mlinear(members["input_projection"], combined))


def member_action_embed(members, cfg: VerifierConfig,
                        action_histories: torch.Tensor) -> torch.Tensor:
    """Every member's trajectory embedding [M, B, d], L2-normalised.
    action_histories: [B, H, action_dim] fp32, top-padded with -5.0."""
    m = members["tave_temperature"].shape[0]
    pad = action_histories[:, :, 0] == cfg.action_padding_value
    ah = action_histories.float()[None].expand(m, *action_histories.shape)
    x = _mlinear(members["action_in"], ah)
    x = traj_encoder(members["traj"], x, pad, cfg.traj_heads)
    valid = (~pad)[None, ..., None].float()
    pooled = (x * valid).sum(dim=2) / valid.sum(dim=2).clamp_min(1e-9)
    return _l2norm(pooled)


def ensemble_embed(params: ParamTree, cfg: VerifierConfig,
                   feats: SharedFeatures, action_histories: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused (mean over members, re-normalised) embeddings.
    Returns (image_text [B, d], action [Ba, d])."""
    it = member_image_text_embed(params["members"], cfg, feats)
    ac = member_action_embed(params["members"], cfg, action_histories)
    return _l2norm(it.mean(dim=0)), _l2norm(ac.mean(dim=0))


def score_actions(params: ParamTree, cfg: VerifierConfig, image: torch.Tensor,
                  text_tokens: torch.Tensor,
                  action_histories: torch.Tensor) -> torch.Tensor:
    """Cosine similarity of ONE (image, instruction) against all candidate
    trajectories (row 0 of the image batch). Returns [num_actions] fp32."""
    feats = extract_features(params, cfg, image, text_tokens)
    fused_it, fused_ac = ensemble_embed(params, cfg, feats, action_histories)
    return (fused_it @ fused_ac.T)[0]


def image_text_embed(params: ParamTree, cfg: VerifierConfig,
                     images: torch.Tensor,
                     text_tokens: torch.Tensor) -> torch.Tensor:
    """Ensemble-fused image+text embeddings [B, d], L2-normalised: the
    scene-familiarity signal of the engine's phase-aware deference."""
    feats = extract_features(params, cfg, images, text_tokens)
    return _l2norm(member_image_text_embed(params["members"], cfg,
                                           feats).mean(dim=0))


def contrastive_logits(params: ParamTree, cfg: VerifierConfig,
                       images: torch.Tensor, text_tokens: torch.Tensor,
                       action_histories: torch.Tensor, member_idx: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-time symmetric logits of one member, scaled by
    exp(logit_scale): (image->action [B, Ba], its transpose)."""
    member = member_slice(params["members"], member_idx)
    feats = extract_features(params, cfg, images, text_tokens)
    it = member_image_text_embed(member, cfg, feats)[0]
    ac = member_action_embed(member, cfg, action_histories)[0]
    image_logits = torch.exp(member["logit_scale"][0]) * (it @ ac.T)
    return image_logits, image_logits.T


def pad_action_histories(histories, history_len: int = 10,
                         pad_value: float = -5.0) -> np.ndarray:
    """Host helper: top-pad variable-length histories to [N, H, D]."""
    out = []
    for ah in histories:
        ah = np.asarray(ah, dtype=np.float32)
        if len(ah) < history_len:
            pad = np.full((history_len - len(ah), ah.shape[1]), pad_value,
                          dtype=np.float32)
            ah = np.vstack([pad, ah])
        out.append(ah[:history_len])
    return np.stack(out)
