"""MLA + MoE decoder stack (Kimi-VL-A3B's language model, DeepSeek-V3's
block) as π0's VLM backbone, and an MLA action expert of its attention
geometry: prefill into a latent cache, and the expert's shared-prefix
decode over it.

A layer: h += o(MLA(norm(h))); h += FFN(norm(h)), the FFN a dense SwiGLU
in the leading `first_dense` layers (every layer of the expert) and a
mixture of experts after them (`ops/moe.py`, inside the span
`moe.block`). RMSNorm is weight * x / rms(x); no embedding scale.

Prefill: per layer, [c_kv | k_pe] = x W_kv_a (c_kv RMS-normed, k_pe
roped, one rope key for every head) is the cache, [L, B, P, r + dr];
the attention itself runs on explicit keys [c_kv W_UK | k_pe] and values
c_kv W_UV padded to the query's head dim, through kernel K3 ("cuda") or
the eager GQA, and keeps the first v_head_dim of each head's output.

Decode: the expert's candidates attend [shared latent prefix | own
suffix] jointly, the prefix part absorbed (`ops/mla.absorbed_decode`,
inside the span `mla.decode`) with the backbone layer's up projections,
which the cache carries beside the latents.

Numerics as the Gemma stack's: weights and the residual stream in the
weights' dtype, norms, RoPE, the router and the softmax in fp32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from cover_vla_tpu_torch.configs import MlaMoeConfig
from cover_vla_tpu_torch.models.params import Init, ParamTree, take_layer
from cover_vla_tpu_torch.ops import mla, moe
from cover_vla_tpu_torch.ops.attention import gqa_attention
from cover_vla_tpu_torch.ops.norms import scaled_rms_norm
from cover_vla_tpu_torch.utils.monitor import count, span

# tokens a mixture-of-experts pass takes at once: bounds its transient
# rows (about 12 KB a routed row at width 2048, 6 choices a token)
MOE_CHUNK_TOKENS = 32_768


def init_mla_moe(init: Init, cfg: MlaMoeConfig,
                 param_dtype=torch.bfloat16) -> dict:
    """The stack with [depth]-stacked attention weights, [num_dense]-
    stacked dense SwiGLUs and [num_moe]-stacked expert layers. Norm
    weights are ones, the correction bias zeros (fp32, as published), the
    router bf16."""
    d, w, h = cfg.depth, cfg.width, cfg.num_heads
    r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim

    def norm(*shape):
        return init.normal(shape, 0.02, param_dtype)

    def ones(*shape):
        return init.ones(shape, param_dtype)

    params = {
        "layers": {
            "input_ln": ones(d, w),
            "q": norm(d, w, h * cfg.qk_head_dim),
            "kv_a": norm(d, w, r + dr),
            "kv_ln": ones(d, r),
            "kv_b": norm(d, r, h * (cfg.qk_nope_dim + cfg.v_head_dim)),
            "o": norm(d, h * cfg.v_head_dim, w),
            "post_ln": ones(d, w),
        },
        "dense": {"gate_up": norm(cfg.num_dense, w, 2 * cfg.mlp_dim),
                  "down": norm(cfg.num_dense, cfg.mlp_dim, w)},
        "final_norm": ones(w),
    }
    if cfg.num_moe:
        nm, e, m = cfg.num_moe, cfg.num_experts, cfg.moe_dim
        ms = cfg.num_shared_experts * m
        params["moe"] = {
            "router": norm(nm, w, e),
            "bias": init.zeros((nm, e)),
            "gate_up": norm(nm, e, w, 2 * m),
            "down": norm(nm, e, m, w),
            "shared_gate_up": norm(nm, w, 2 * ms),
            "shared_down": norm(nm, ms, w),
        }
    if cfg.vocab_size:
        params["embed"] = norm(cfg.vocab_size, w)
    return params


def is_mla_moe(tree) -> bool:
    """Whether a stack's tree is this module's (its layers carry kv_a)."""
    return "kv_a" in tree["layers"]


def embed_tokens(params: ParamTree, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _mla_inputs(layer: dict, cfg: MlaMoeConfig, h: torch.Tensor,
                positions: torch.Tensor):
    """input RMSNorm -> q and [c_kv | k_pe] projections, c_kv normed, RoPE.
    h: [..., S, W]; positions: [..., S]. -> (q_nope [..., S, H, dn], q_pe
    [..., S, H, dr], c_kv [..., S, r], k_pe [..., S, dr])."""
    x = scaled_rms_norm(h, layer["input_ln"], cfg.rms_eps)
    lead = x.shape[:-1]
    q = (x @ layer["q"]).view(*lead, cfg.num_heads, cfg.qk_head_dim)
    q_pe = mla.rope_pairs(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)
    kv = x @ layer["kv_a"]
    r = cfg.kv_lora_rank
    c_kv = scaled_rms_norm(kv[..., :r], layer["kv_ln"], cfg.rms_eps)
    k_pe = mla.rope_pairs(kv[..., None, r:], positions, cfg.rope_theta)
    return q[..., :cfg.qk_nope_dim], q_pe, c_kv, k_pe[..., 0, :]


def _up(layer: dict, cfg: MlaMoeConfig, c_kv: torch.Tensor):
    """c_kv [..., r] -> per head (k_nope [..., H, dn], v [..., H, dv])."""
    kvb = (c_kv @ layer["kv_b"]).view(
        *c_kv.shape[:-1], cfg.num_heads, cfg.qk_nope_dim + cfg.v_head_dim)
    return kvb[..., :cfg.qk_nope_dim], kvb[..., cfg.qk_nope_dim:]


def _ffn(params, cfg: MlaMoeConfig, i: int, y: torch.Tensor) -> torch.Tensor:
    """Layer i's feed-forward of the normed y [..., W]."""
    if i < cfg.num_dense:
        dense = take_layer(params["dense"], i)
        return moe.swiglu(y, dense["gate_up"], dense["down"])
    lw = take_layer(params["moe"], i - cfg.num_dense)
    x = y.reshape(-1, y.shape[-1])
    out = []
    with span("moe.block"):
        for lo in range(0, x.shape[0], MOE_CHUNK_TOKENS):
            xc = x[lo:lo + MOE_CHUNK_TOKENS]
            idx, w = moe.route(xc, lw["router"], lw["bias"],
                               cfg.experts_per_token, cfg.routed_scaling)
            routed = moe.routed_experts(xc, idx, w, lw["gate_up"], lw["down"])
            out.append(routed + moe.swiglu(xc, lw["shared_gate_up"],
                                           lw["shared_down"]))
        count("moe_rows", x.shape[0] * cfg.experts_per_token)
    return torch.cat(out).view(y.shape)


def _block_rest(params, cfg: MlaMoeConfig, i: int, layer: dict,
                h: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
    """o projection + residual, post-attention norm + FFN + residual."""
    h = h + attn @ layer["o"]
    return h + _ffn(params, cfg, i,
                    scaled_rms_norm(h, layer["post_ln"], cfg.rms_eps))


def prefill(params: ParamTree, cfg: MlaMoeConfig, prefix_emb: torch.Tensor,
            positions: torch.Tensor, mask: torch.Tensor,
            return_hidden: bool = False, attn_impl: str = "eager"):
    """Run the stack on the prefix [B, P, W] (positions [B, P], mask
    bool[B, P, P]). Returns (hidden after the final norm or None, cache):
    cache {"kv": [L, B, P, r + dr] latents and rope keys, "kv_b": the
    layers' up projections [L, r, H * (dn + dv)]}."""
    layers = params["layers"]
    dtype = layers["q"].dtype
    if attn_impl == "cuda":
        # kernel K3 at head dim dn + dr, the values zero-padded to it
        from cover_vla_tpu_torch.ops.cuda_attention import prefix_gqa
        kmask = mask.contiguous()
        bf = torch.bfloat16

        def attend(q, k, v):
            return prefix_gqa(q.to(bf).contiguous(), k.to(bf).contiguous(),
                              v.to(bf).contiguous(), kmask, out_dtype=dtype)
    elif attn_impl == "eager":
        def attend(q, k, v):
            return gqa_attention(q, k, v, mask)
    else:
        raise ValueError(f"unknown attention backend {attn_impl!r}")
    h = prefix_emb.to(dtype)
    b, p_len = h.shape[:2]
    hd, dq = cfg.num_heads, cfg.qk_head_dim
    kv = torch.empty((cfg.depth, b, p_len, cfg.kv_lora_rank + cfg.qk_rope_dim),
                     dtype=dtype, device=h.device)
    for i in range(cfg.depth):
        layer = take_layer(layers, i)
        q_nope, q_pe, c_kv, k_pe = _mla_inputs(layer, cfg, h, positions)
        kv[i] = torch.cat([c_kv, k_pe], dim=-1)
        k_nope, v = _up(layer, cfg, c_kv)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe[..., None, :].expand(b, p_len, hd, -1)],
                      dim=-1)
        v = F.pad(v, (0, dq - cfg.v_head_dim))
        attn = attend(q, k, v).view(b, p_len, hd, dq)[..., :cfg.v_head_dim]
        h = _block_rest(params, cfg, i, layer, h,
                        attn.reshape(b, p_len, hd * cfg.v_head_dim))
    cache = {"kv": kv, "kv_b": layers["kv_b"]}
    if return_hidden:
        return scaled_rms_norm(h, params["final_norm"], cfg.rms_eps), cache
    return None, cache


def decode_shared_prefix(ex_params: ParamTree, cfg: MlaMoeConfig,
                         suffix_emb: torch.Tensor, positions: torch.Tensor,
                         cache: dict, prefix_pad: torch.Tensor,
                         suffix_mask: torch.Tensor) -> torch.Tensor:
    """The MLA expert over N candidates sharing one latent prefix cache
    per row. suffix_emb: [B, N, S, W]; positions: [B, S]; cache: from
    `prefill` of a backbone of the same attention geometry; prefix_pad:
    bool[B, P]; suffix_mask: bool[B, S, S]. Returns [B, N, S, W] after the
    final RMSNorm."""
    b, n, s, _ = suffix_emb.shape
    pos = positions[:, None, :].expand(b, n, s)
    layers = ex_params["layers"]
    h = suffix_emb.to(layers["q"].dtype)
    hd, dn = cfg.num_heads, cfg.qk_nope_dim
    r = cfg.kv_lora_rank
    if cache["kv"].shape[-1] != r + cfg.qk_rope_dim or \
            cache["kv_b"].shape[-1] != hd * (dn + cfg.v_head_dim):
        raise ValueError("the expert's attention geometry differs from the "
                         "backbone's cache")
    for i in range(cfg.depth):
        layer = take_layer(layers, i)
        q_nope, q_pe, c_kv, k_pe = _mla_inputs(layer, cfg, h, pos)
        k_nope, v = _up(layer, cfg, c_kv)
        w = cache["kv_b"][i].view(r, hd, dn + cfg.v_head_dim)
        with span("mla.decode"):
            attn = mla.absorbed_decode(q_nope, q_pe, k_nope, k_pe, v,
                                       cache["kv"][i], w[..., :dn],
                                       w[..., dn:], prefix_pad, suffix_mask)
        h = _block_rest(ex_params, cfg, i, layer, h, attn)
    return scaled_rms_norm(h, ex_params["final_norm"], cfg.rms_eps)
