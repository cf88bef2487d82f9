"""pi0 flow-matching VLA policy: the flow-matching training loss, and
shared prefill + Euler integration over N candidates.

  * `sample_actions` supports a candidate axis N with a shared prefix: the
    PaliGemma prefill runs once per batch row and all N candidates decode
    against the same KV cache.
  * Image/language embedding scalings follow the reference's sequence: the
    multi-modal projector output is divided by sqrt(width), rounded
    through `compute_dtype`, and multiplied by sqrt(width) in that dtype;
    language embeddings are scaled by sqrt(width) in the embedding dtype.

The VLM's language model and the expert are Gemma stacks
(`models/gemma.py`) or, when the config's `paligemma` is an
`MlaMoeConfig`, MLA + MoE stacks (`models/mla_moe.py`: Kimi-VL-A3B's
language model, a latent prefix cache, absorbed decode, no embedding
scale). The MLA + MoE backbone serves inference only: the training loss
refuses it.

Numerics: fp32 projections (state/action/time MLP, action_out_proj) in
true fp32, bf16 transformer, fp32 RoPE/softmax.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from cover_vla_tpu_torch.configs import MlaMoeConfig, Pi0Config
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.models import gemma, mla_moe, siglip
from cover_vla_tpu_torch.models.params import Init, ParamTree
from cover_vla_tpu_torch.ops.masks import make_att_2d_masks, suffix_att_masks
from cover_vla_tpu_torch.ops.sampling import (
    sample_flow_time, sample_noise, sinusoidal_time_embedding)
from cover_vla_tpu_torch.utils.monitor import span, to_device

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _linear(p, x: torch.Tensor) -> torch.Tensor:
    return x @ p["kernel"] + p["bias"]


def _is_mla(cfg: Pi0Config) -> bool:
    """Whether the policy's backbone is an MLA + MoE stack."""
    if isinstance(cfg.paligemma, MlaMoeConfig) != \
            isinstance(cfg.expert, MlaMoeConfig):
        raise ValueError("the VLM backbone and the action expert must both "
                         "be Gemma or both MLA + MoE stacks")
    return isinstance(cfg.paligemma, MlaMoeConfig)


def init_pi0(seed: int, cfg: Pi0Config, *, device=None) -> ParamTree:
    """Randomly initialised policy (the reference's shapes, dtypes and
    scales) on `device` (CUDA unless given)."""
    init = Init(seed, resolve_device(device))
    w = cfg.proj_width
    init_stack = mla_moe.init_mla_moe if _is_mla(cfg) else gemma.init_gemma
    return ParamTree({
        "vision": siglip.init_vit(init, cfg.vision),
        "mm_proj": init.linear(cfg.vision.width, cfg.paligemma.width),
        "paligemma": init_stack(init, cfg.paligemma),
        "expert": init_stack(init, cfg.expert),
        "state_proj": init.linear(cfg.max_state_dim, w),
        "action_in_proj": init.linear(cfg.max_action_dim, w),
        "action_out_proj": init.linear(w, cfg.max_action_dim),
        "time_mlp_in": init.linear(2 * w, w),
        "time_mlp_out": init.linear(w, w),
    })


# ---------------------------------------------------------------------------
# Embedding
# ---------------------------------------------------------------------------


class Prefix(NamedTuple):
    embs: torch.Tensor       # [B, P, W_pg]
    pad_masks: torch.Tensor  # bool[B, P]
    att_masks: torch.Tensor  # int[B, P]


def embed_prefix(params: ParamTree, cfg: Pi0Config, images: torch.Tensor,
                 img_masks: torch.Tensor, lang_tokens: torch.Tensor,
                 lang_masks: torch.Tensor) -> Prefix:
    """images: [Bi, num_images, H, W, 3] in [-1,1]; img_masks:
    bool[Bi, num_images]; lang_tokens: int[B, T]; lang_masks: bool[B, T].

    Prompt sharing: B must be a multiple of Bi. When B > Bi, each image row
    serves B/Bi consecutive prompt rows (K rephrased prompts over one
    observation): the vision tower runs once per image row and its tokens
    are repeated.
    """
    cdt = _DTYPES[cfg.compute_dtype]
    b = lang_tokens.shape[0]
    bi, n_img = images.shape[:2]
    if b % bi:
        raise ValueError(f"{b} prompt rows do not split over {bi} image rows")
    flat = images.reshape(bi * n_img, *images.shape[2:])
    vit_out = siglip.vit_forward(params["vision"], cfg.vision, flat)
    mla = _is_mla(cfg)
    if mla:
        # no embedding scale: the projected image tokens and the token
        # embeddings enter the stack as they are
        img_emb = _linear(params["mm_proj"], vit_out.tokens.float()).to(cdt)
    else:
        w_sqrt = cfg.paligemma.width ** 0.5
        img_emb = _linear(params["mm_proj"], vit_out.tokens.float()) / w_sqrt
        img_emb = img_emb.to(cdt) * torch.tensor(w_sqrt, dtype=cdt)
    img_emb = img_emb.reshape(bi, n_img * cfg.vision.num_patches, -1)
    if b > bi:
        img_emb = img_emb.repeat_interleave(b // bi, dim=0)
        img_masks = img_masks.repeat_interleave(b // bi, dim=0)

    if mla:
        lang_emb = mla_moe.embed_tokens(params["paligemma"], lang_tokens)
    else:
        lang_emb = gemma.embed_tokens(params["paligemma"], lang_tokens)
        lang_emb = lang_emb * torch.tensor(cfg.paligemma.width ** 0.5,
                                           dtype=lang_emb.dtype)
    embs = torch.cat([img_emb, lang_emb.to(cdt)], dim=1)
    img_pad = img_masks.repeat_interleave(cfg.vision.num_patches, dim=1)
    pad = torch.cat([img_pad, lang_masks.bool()], dim=1)
    att = torch.zeros((b, embs.shape[1]), dtype=torch.int32,
                      device=embs.device)
    return Prefix(embs, pad, att)


def embed_suffix(params: ParamTree, cfg: Pi0Config, state: torch.Tensor,
                 noisy_actions: torch.Tensor,
                 timestep: torch.Tensor) -> torch.Tensor:
    """Suffix token embeddings.

    state: [B, max_state_dim] fp32; noisy_actions: [B, ..., chunk,
    max_action_dim] fp32; timestep: broadcastable to the leading dims of
    noisy_actions. Returns [B, ..., 1 + chunk, proj_width] fp32.
    """
    cdt = _DTYPES[cfg.compute_dtype]
    lead = noisy_actions.shape[:-2]
    w = cfg.proj_width
    # the state embedding rounds through compute_dtype
    state_emb = _linear(params["state_proj"], state.float())
    state_emb = state_emb.to(cdt).float()
    state_emb = state_emb.reshape(state.shape[0], *([1] * (len(lead) - 1)),
                                  1, w).expand(*lead, 1, w)

    t_flat = to_device(timestep, state.device).expand(lead)
    time_emb = sinusoidal_time_embedding(
        t_flat.reshape(-1), w, cfg.time_min_period, cfg.time_max_period)
    # the time embedding is cast to the state embedding's dtype first
    time_emb = time_emb.to(cdt).float()
    time_emb = time_emb.reshape(*lead, 1, w).expand(*lead, cfg.chunk_size, w)

    action_emb = _linear(params["action_in_proj"], noisy_actions.float())
    x = torch.cat([action_emb, time_emb], dim=-1)
    x = F.silu(_linear(params["time_mlp_in"], x))
    action_time_emb = _linear(params["time_mlp_out"], x)
    return torch.cat([state_emb, action_time_emb], dim=-2)


# ---------------------------------------------------------------------------
# Training forward
# ---------------------------------------------------------------------------


def flow_matching_loss(params: ParamTree, cfg: Pi0Config, images, img_masks,
                       lang_tokens, lang_masks, state, actions,
                       noise: Optional[torch.Tensor] = None,
                       time: Optional[torch.Tensor] = None,
                       remat: bool = True,
                       generator: Optional[torch.Generator] = None
                       ) -> torch.Tensor:
    """Per-element MSE losses [B, chunk, max_action_dim].

    `noise` ([B, chunk, A]) and `time` ([B]) are drawn from `generator`
    (noise first) unless given. remat: recompute the transformer layers
    in the backward pass (`gemma.fused_forward`)."""
    if _is_mla(cfg):
        raise NotImplementedError(
            "flow_matching_loss: π0 training supports the Gemma backbone "
            "only; this policy's backbone is an MLA + MoE stack "
            "(inference only)")
    b = actions.shape[0]
    dev = actions.device
    if noise is None:
        noise = sample_noise(actions.shape, generator=generator, device=dev)
    if time is None:
        time = sample_flow_time(b, generator=generator, device=dev)

    t = time[:, None, None]
    x_t = t * noise + (1 - t) * actions
    u_t = noise - actions

    prefix = embed_prefix(params, cfg, images, img_masks, lang_tokens,
                          lang_masks)
    suffix_embs = embed_suffix(params, cfg, state, x_t, time)
    suf_att = suffix_att_masks(b, cfg.chunk_size, device=dev)
    suf_pad = torch.ones((b, suffix_embs.shape[1]), dtype=torch.bool,
                         device=dev)
    pad = torch.cat([prefix.pad_masks, suf_pad], dim=1)
    att = torch.cat([prefix.att_masks, suf_att], dim=1)
    mask2d = make_att_2d_masks(pad, att)
    positions = torch.cumsum(pad.to(torch.int32), dim=1) - 1

    _, suffix_out = gemma.fused_forward(
        params["paligemma"], params["expert"], cfg.paligemma, cfg.expert,
        prefix.embs, suffix_embs, positions, mask2d, remat=remat)
    suffix_out = suffix_out[:, -cfg.chunk_size:].float()
    v_t = _linear(params["action_out_proj"], suffix_out)
    return torch.square(u_t - v_t)


# ---------------------------------------------------------------------------
# Inference: shared prefill + Euler integration over N candidates
# ---------------------------------------------------------------------------


class PrefixCache(NamedTuple):
    # Gemma {"k","v"}: [L, B, P, Hkv, D]; MLA + MoE {"kv": [L, B, P, r + dr]
    # latents and rope keys, "kv_b": the backbone's up projections}
    cache: dict
    pad_masks: torch.Tensor   # bool[B, P]
    hidden: Optional[torch.Tensor] = None


def compute_prefix_cache(params: ParamTree, cfg: Pi0Config, images,
                         img_masks, lang_tokens, lang_masks,
                         return_hidden: bool = False) -> PrefixCache:
    prefix = embed_prefix(params, cfg, images, img_masks, lang_tokens,
                          lang_masks)
    mask2d = make_att_2d_masks(prefix.pad_masks, prefix.att_masks)
    positions = torch.cumsum(prefix.pad_masks.to(torch.int32), dim=1) - 1
    stack = mla_moe if _is_mla(cfg) else gemma
    hidden, cache = stack.prefill(params["paligemma"], cfg.paligemma,
                                  prefix.embs, positions, mask2d,
                                  return_hidden=return_hidden,
                                  attn_impl=cfg.attention_impl)
    return PrefixCache(cache=cache, pad_masks=prefix.pad_masks, hidden=hidden)


def _suffix_geometry(cfg: Pi0Config, prefix_pad: torch.Tensor):
    """Suffix attention mask + RoPE positions, identical for every Euler step."""
    b = prefix_pad.shape[0]
    dev = prefix_pad.device
    att = suffix_att_masks(b, cfg.chunk_size, device=dev)
    pad = torch.ones((b, cfg.suffix_len), dtype=torch.bool, device=dev)
    mask = make_att_2d_masks(pad, att)                     # [B, S, S]
    offset = prefix_pad.to(torch.int32).sum(dim=1, keepdim=True)
    positions = offset + torch.cumsum(pad.to(torch.int32), dim=1) - 1
    return mask, positions


def denoise_step(params: ParamTree, cfg: Pi0Config, state: torch.Tensor,
                 prefix: PrefixCache, x_t: torch.Tensor, time: torch.Tensor,
                 suffix_mask: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    """One velocity evaluation. x_t: [B, N, chunk, A]; time: scalar."""
    suffix_embs = embed_suffix(params, cfg, state, x_t, time)
    if _is_mla(cfg):
        out = mla_moe.decode_shared_prefix(
            params["expert"], cfg.expert, suffix_embs, positions,
            prefix.cache, prefix.pad_masks, suffix_mask)
    else:
        out = gemma.decode_shared_prefix(
            params["expert"], cfg.expert, suffix_embs, positions,
            prefix.cache, prefix.pad_masks, suffix_mask,
            attn_impl=cfg.decode_attn_impl or cfg.attention_impl)
    out = out[..., -cfg.chunk_size:, :].float()
    return _linear(params["action_out_proj"], out)


def denoise_from_cache(params: ParamTree, cfg: Pi0Config,
                       state: torch.Tensor, prefix: PrefixCache,
                       noise: torch.Tensor) -> torch.Tensor:
    """Integrate the flow from t=1 to 0 given a prefilled cache.
    noise: [B, N, chunk, A] fp32 starting point (x_1)."""
    suffix_mask, positions = _suffix_geometry(cfg, prefix.pad_masks)
    dt = -1.0 / cfg.num_denoise_steps
    times = 1.0 + dt * torch.arange(cfg.num_denoise_steps,
                                    dtype=torch.float32, device=noise.device)
    x_t = noise
    for i in range(cfg.num_denoise_steps):
        v_t = denoise_step(params, cfg, state, prefix, x_t, times[i],
                           suffix_mask, positions)
        x_t = x_t + dt * v_t
    return x_t


def sample_actions(params: ParamTree, cfg: Pi0Config, images, img_masks,
                   lang_tokens, lang_masks, state,
                   num_candidates: int = 1, noise_std: float = 1.0,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
    """Sample N action-chunk candidates per batch row.

    Returns [B, N, chunk_size, max_action_dim] fp32. The noise is `noise`
    when given, else drawn from `generator`. The prefill runs once per
    row (the span `pi0.prefix`); the Euler loop runs num_denoise_steps
    steps of dt = -1/steps (the span `pi0.denoise`).
    """
    b = state.shape[0]
    if noise is None:
        noise = sample_noise(
            (b, num_candidates, cfg.chunk_size, cfg.max_action_dim),
            noise_std, generator=generator, device=state.device)
    with span("pi0.prefix"):
        prefix = compute_prefix_cache(params, cfg, images, img_masks,
                                      lang_tokens, lang_masks)
    with span("pi0.denoise"):
        return denoise_from_cache(params, cfg, state, prefix, noise)
