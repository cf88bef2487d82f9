"""Gemma decoder stack: the fused training forward of PaliGemma and the
action expert, prefill into a KV cache, shared-prefix decode, and greedy
autoregressive decode (pi0-FAST).

Layer weights are stacked along a leading [depth] axis, as in the
reference package, and the layer loop is a Python loop. Decode uses a
shared-prefix KV cache: all N candidates of a batch row attend one copy of
the row's prefix keys/values; the softmax runs jointly over
[prefix | own suffix] scores in fp32 (eager) or inside kernel K1 ("cuda").
The prefill's attention is eager or kernel K3 ("cuda").

Numerics: weights bf16, the residual stream and the KV cache in the
stack's compute dtype (`_dtype`: the weights' dtype, bf16 for an int8
stack), RMSNorm/softmax/RoPE in fp32. An int8-quantized stack
(ops/quant) runs its matmuls as w8a8 products.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from cover_vla_tpu_torch.configs import GemmaConfig
from cover_vla_tpu_torch.models.params import (
    Init, ParamTree, iter_layers, take_layer, unstack_layers)
from cover_vla_tpu_torch.ops.attention import (
    ATTN_BACKENDS, BIG_NEG, gqa_attention)
from cover_vla_tpu_torch.ops import quant
from cover_vla_tpu_torch.ops.norms import rms_norm
from cover_vla_tpu_torch.ops.rope import apply_rope


def init_gemma(init: Init, cfg: GemmaConfig,
               param_dtype=torch.bfloat16) -> dict:
    """Gemma decoder stack with [depth]-stacked layer weights."""
    d, w, m = cfg.depth, cfg.width, cfg.mlp_dim
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim

    def norm(*shape):
        return init.normal(shape, 0.02, param_dtype)

    params = {
        "layers": {
            "input_ln": init.zeros((d, w)),
            "q": norm(d, w, qd),
            "k": norm(d, w, kvd),
            "v": norm(d, w, kvd),
            "o": norm(d, qd, w),
            "post_ln": init.zeros((d, w)),
            "gate": norm(d, w, m),
            "up": norm(d, w, m),
            "down": norm(d, m, w),
        },
        "final_norm": init.zeros((w,)),
    }
    if cfg.vocab_size:
        params["embed"] = norm(cfg.vocab_size, w)
    return params


def embed_tokens(params: ParamTree, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens.long()]


def _dtype(layers_or_layer) -> torch.dtype:
    """Compute dtype of a stack: its q weight's dtype, or bf16 when the
    stack is int8-quantized (ops/quant: the layer dict carries the mode)."""
    d = layers_or_layer["q"].dtype
    return torch.bfloat16 if d == torch.int8 else d


def _mm(x: torch.Tensor, layer: dict, name: str, xq=None,
        xs=None) -> torch.Tensor:
    """x @ layer[name], or the int8 product when the layer carries
    `<name>_scale` (ops/quant.quantize_gemma_stack). A pre-quantized
    (xq, xs) shares one activation quant across the q/k/v (or gate/up)
    projections of the same input."""
    w = layer[name]
    s = layer.get(name + "_scale")
    if s is None:
        return x.to(w.dtype) @ w
    if xq is None:
        xq, xs = quant.quant_act(x)
    return quant.int8_matmul(xq, xs, w, s)


def _qkv(layer: dict, cfg: GemmaConfig, h: torch.Tensor,
         positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """input RMSNorm -> q/k/v projections -> RoPE. h: [..., S, W];
    positions: [..., S]."""
    x = rms_norm(h, layer["input_ln"], cfg.rms_eps).to(_dtype(layer))
    shape = x.shape[:-1]
    xq = xs = None
    if "q_scale" in layer:      # quantize the normed input once for q/k/v
        xq, xs = quant.quant_act(x)
    q = _mm(x, layer, "q", xq, xs).reshape(*shape, cfg.num_heads,
                                           cfg.head_dim)
    k = _mm(x, layer, "k", xq, xs).reshape(*shape, cfg.num_kv_heads,
                                           cfg.head_dim)
    v = _mm(x, layer, "v", xq, xs).reshape(*shape, cfg.num_kv_heads,
                                           cfg.head_dim)
    pos = positions.reshape(-1, positions.shape[-1])
    q = apply_rope(q.reshape(-1, *q.shape[-3:]), pos,
                   cfg.rope_theta).reshape(q.shape)
    k = apply_rope(k.reshape(-1, *k.shape[-3:]), pos,
                   cfg.rope_theta).reshape(k.shape)
    return q, k, v


def _post_attention(layer: dict, cfg: GemmaConfig, h: torch.Tensor,
                    attn_out: torch.Tensor) -> torch.Tensor:
    """o_proj + residual + post-LN + GeGLU MLP + residual."""
    dtype = _dtype(layer)
    h = h + _mm(attn_out.to(dtype), layer, "o")
    y = rms_norm(h, layer["post_ln"], cfg.rms_eps).to(dtype)
    yq = ys = None
    if "gate_scale" in layer:   # quantize y once for gate/up
        yq, ys = quant.quant_act(y)
    gated = F.gelu(_mm(y, layer, "gate", yq, ys), approximate="tanh") \
        * _mm(y, layer, "up", yq, ys)
    return h + _mm(gated, layer, "down")


# ---------------------------------------------------------------------------
# Fused training forward (both spans, no cache)
# ---------------------------------------------------------------------------


def fused_forward(pg_params: ParamTree, ex_params: ParamTree,
                  pg_cfg: GemmaConfig, ex_cfg: GemmaConfig,
                  prefix_emb: torch.Tensor, suffix_emb: torch.Tensor,
                  positions: torch.Tensor, mask: torch.Tensor,
                  remat: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run PaliGemma on the prefix span and the expert on the suffix span
    with one masked GQA per layer over [prefix | suffix].

    prefix_emb: [B, P, W_pg]; suffix_emb: [B, S, W_ex]; positions:
    [B, P + S] RoPE positions; mask: bool[B, P + S, P + S] (True =
    attend). Returns (prefix_out, suffix_out) after each model's final
    RMSNorm. The attention is the eager `gqa_attention` (fp32 scores and
    softmax): the hand kernels have no backward pass.

    remat: recompute each layer pair in the backward pass
    (`torch.utils.checkpoint`), the frozen PaliGemma span included, as
    `jax.checkpoint` over the scanned layer body does.
    """
    p_len = prefix_emb.shape[1]
    pos_p, pos_s = positions[:, :p_len], positions[:, p_len:]
    pg_layers = unstack_layers(pg_params["layers"])
    ex_layers = unstack_layers(ex_params["layers"])

    def layer_pair(i: int, h_p: torch.Tensor, h_s: torch.Tensor):
        lp, ls = pg_layers[i], ex_layers[i]
        qp, kp, vp = _qkv(lp, pg_cfg, h_p, pos_p)
        qs, ks, vs = _qkv(ls, ex_cfg, h_s, pos_s)
        attn = gqa_attention(torch.cat([qp, qs], dim=1),
                             torch.cat([kp, ks], dim=1),
                             torch.cat([vp, vs], dim=1), mask)
        h_p = _post_attention(lp, pg_cfg, h_p, attn[:, :p_len])
        h_s = _post_attention(ls, ex_cfg, h_s, attn[:, p_len:])
        return h_p, h_s

    h_p = prefix_emb.to(_dtype(pg_params["layers"]))
    h_s = suffix_emb.to(_dtype(ex_params["layers"]))
    for i in range(len(pg_layers)):
        if remat:
            h_p, h_s = checkpoint(layer_pair, i, h_p, h_s,
                                  use_reentrant=False)
        else:
            h_p, h_s = layer_pair(i, h_p, h_s)
    return (rms_norm(h_p, pg_params["final_norm"], pg_cfg.rms_eps),
            rms_norm(h_s, ex_params["final_norm"], ex_cfg.rms_eps))


# ---------------------------------------------------------------------------
# Prefill (PaliGemma span only) -> KV cache
# ---------------------------------------------------------------------------


def prefill(pg_params: ParamTree, cfg: GemmaConfig, prefix_emb: torch.Tensor,
            positions: torch.Tensor, mask: torch.Tensor,
            return_hidden: bool = False, attn_impl: str = "eager"):
    """Run the LM on the prefix, emitting per-layer K/V.

    Returns (hidden_or_None, cache) with cache = {"k": [L,B,P,Hkv,D],
    "v": [L,B,P,Hkv,D]} in the stack's compute dtype. Under autograd only
    `hidden` is differentiable: the cache holds detached copies, so the
    graph keeps no per-layer cache writes.
    """
    if attn_impl not in ATTN_BACKENDS:
        raise ValueError(f"unknown attention backend {attn_impl!r}")
    layers = pg_params["layers"]
    dtype = _dtype(layers)
    if attn_impl == "cuda":
        # kernel K3, once per layer: bf16 operands, the mask made
        # contiguous once; an fp32 stack gets the kernel's fp32 result
        from cover_vla_tpu_torch.ops.cuda_attention import prefix_gqa
        kmask = mask.contiguous()
        bf = torch.bfloat16

        def attend(q, k, v):
            return prefix_gqa(q.to(bf).contiguous(), k.to(bf).contiguous(),
                              v.to(bf).contiguous(), kmask, out_dtype=dtype)
    else:
        def attend(q, k, v):
            return gqa_attention(q, k, v, mask)
    h = prefix_emb.to(dtype)
    b, p_len = h.shape[:2]
    shape = (cfg.depth, b, p_len, cfg.num_kv_heads, cfg.head_dim)
    cache = {"k": torch.empty(shape, dtype=dtype, device=h.device),
             "v": torch.empty(shape, dtype=dtype, device=h.device)}
    for i, layer in enumerate(iter_layers(layers, cfg.depth)):
        q, k, v = _qkv(layer, cfg, h, positions)
        cache["k"][i] = k.detach()
        cache["v"][i] = v.detach()
        h = _post_attention(layer, cfg, h, attend(q, k, v))
    if return_hidden:
        return rms_norm(h, pg_params["final_norm"], cfg.rms_eps), cache
    return None, cache


# ---------------------------------------------------------------------------
# Autoregressive greedy decode (pi0-FAST action-token generation)
# ---------------------------------------------------------------------------


def lm_logits(params: ParamTree, cfg: GemmaConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """Tied-embedding LM head: logits = hidden @ embed^T, fp32."""
    return hidden.float() @ params["embed"].float().T


@torch.no_grad()
def ar_generate(params: ParamTree, cfg: GemmaConfig, prefix_emb: torch.Tensor,
                prefix_pad: torch.Tensor, max_new_tokens: int, eos_id: int,
                pad_id: int = 0) -> torch.Tensor:
    """Greedy autoregressive generation after a (right-padded) prefix.

    The KV cache is preallocated to [L, B, P + max_new, Hkv, D]; new tokens
    occupy fixed slots P+t with per-row RoPE positions starting at each
    row's count of valid prefix tokens, so right padding needs no shifting
    (invalid key slots are masked). Rows that emit EOS continue with pad
    tokens. Output t is the token fed at step t; the loop stops once every
    row is done, since every later output is then pad.

    Returns int32[B, max_new_tokens].
    """
    b, p_len, _ = prefix_emb.shape
    dev = prefix_emb.device
    layers = params["layers"]
    positions = torch.cumsum(prefix_pad.to(torch.int32), dim=1) - 1
    mask2d = prefix_pad[:, None, :] & prefix_pad[:, :, None]
    hidden, cache = prefill(params, cfg, prefix_emb, positions, mask2d,
                            return_hidden=True)

    shape = (cfg.depth, b, p_len + max_new_tokens, cfg.num_kv_heads,
             cfg.head_dim)
    kc = torch.zeros(shape, dtype=cache["k"].dtype, device=dev)
    vc = torch.zeros_like(kc)
    kc[:, :, :p_len] = cache["k"]
    vc[:, :, :p_len] = cache["v"]
    key_valid = torch.cat([prefix_pad.bool(), torch.zeros(
        (b, max_new_tokens), dtype=torch.bool, device=dev)], dim=1)

    # the tied embedding in fp32 once per call, not once per step
    table = params["embed"].float()
    n_valid = prefix_pad.to(torch.int32).sum(dim=1)                 # [B]
    rows = torch.arange(b, device=dev)
    first = hidden[rows, n_valid.long() - 1].float() @ table.T
    token = first.argmax(dim=-1).to(torch.int32)
    done = token == eos_id
    token = torch.where(done, pad_id, token)
    pos = n_valid
    scale = torch.tensor(cfg.width ** 0.5, dtype=params["embed"].dtype)
    dtype = _dtype(layers)

    out = torch.full((b, max_new_tokens), pad_id, dtype=torch.int32,
                     device=dev)
    for t in range(max_new_tokens):
        out[:, t] = token
        # the last step's next token is never emitted
        if t == max_new_tokens - 1 or bool(done.all()):
            break
        slot = p_len + t
        key_valid[:, slot] = True
        h = (embed_tokens(params, token[:, None]) * scale).to(dtype)
        for i in range(cfg.depth):
            layer = take_layer(layers, i)
            q, k, v = _qkv(layer, cfg, h, pos[:, None])
            kc[i, :, slot] = k[:, 0]
            vc[i, :, slot] = v[:, 0]
            attn = gqa_attention(q, kc[i], vc[i], key_valid[:, None, :])
            h = _post_attention(layer, cfg, h, attn)
        h = rms_norm(h, params["final_norm"], cfg.rms_eps)
        next_token = (h[:, 0].float() @ table.T).argmax(dim=-1).to(torch.int32)
        next_done = done | (next_token == eos_id)
        token = torch.where(done, pad_id, next_token)   # the old `done`
        done, pos = next_done, pos + 1
    return out


# ---------------------------------------------------------------------------
# Shared-prefix decode (expert span only, N candidates per cached row)
# ---------------------------------------------------------------------------


def decode_shared_prefix(ex_params: ParamTree, cfg: GemmaConfig,
                         suffix_emb: torch.Tensor, positions: torch.Tensor,
                         cache: dict, prefix_pad: torch.Tensor,
                         suffix_mask: torch.Tensor,
                         attn_impl: str = "eager") -> torch.Tensor:
    """Expert forward over N candidates sharing one prefix KV cache per row.

    suffix_emb: [B, N, S, W]; positions: [B, S] RoPE positions of the
    suffix tokens (same for all N); cache {"k","v"}: [L, B, P, Hkv, D];
    prefix_pad: bool[B, P]; suffix_mask: bool[B, S, S].
    Returns [B, N, S, W] after the final RMSNorm.
    """
    b, n, s, _ = suffix_emb.shape
    pos = positions[:, None, :].expand(b, n, s)
    layers = ex_params["layers"]
    h = suffix_emb.to(_dtype(layers))
    for i in range(cfg.depth):
        layer = take_layer(layers, i)
        q, k, v = _qkv(layer, cfg, h, pos)   # q: [B,N,S,Hq,D]; k/v: [B,N,S,Hkv,D]
        attn = _shared_prefix_gqa(q, k, v, cache["k"][i], cache["v"][i],
                                  prefix_pad, suffix_mask,
                                  attn_impl=attn_impl)
        h = _post_attention(layer, cfg, h, attn)
    return rms_norm(h, ex_params["final_norm"], cfg.rms_eps)


def _shared_prefix_gqa(q: torch.Tensor, k_suf: torch.Tensor,
                       v_suf: torch.Tensor, k_pre: torch.Tensor,
                       v_pre: torch.Tensor, prefix_pad: torch.Tensor,
                       suffix_mask: torch.Tensor,
                       attn_impl: str = "eager") -> torch.Tensor:
    """Attention of candidate suffix queries over [shared prefix | own suffix].

    q: [B, N, S, Hq, D]; k_suf/v_suf: [B, N, S, Hkv, D];
    k_pre/v_pre: [B, P, Hkv, D]; prefix_pad: bool[B, P];
    suffix_mask: bool[B, S, S]. Returns [B, N, S, Hq*D].

    The prefix keys are not replicated across candidates. Under
    attn_impl="cuda" the whole op is kernel K1.
    """
    if attn_impl not in ATTN_BACKENDS:
        raise ValueError(f"unknown attention backend {attn_impl!r}")
    if attn_impl == "cuda":
        from cover_vla_tpu_torch.ops.cuda_attention import shared_prefix_gqa
        return shared_prefix_gqa(q, k_suf, v_suf, k_pre, v_pre, prefix_pad,
                                 suffix_mask)
    b, n, s, hq, d = q.shape
    hkv = k_suf.shape[3]
    q32 = q.float().reshape(b, n, s, hkv, hq // hkv, d) * (d ** -0.5)
    scores_pre = torch.einsum("bnshgd,bphd->bnhgsp", q32, k_pre.float())
    scores_pre = torch.where(prefix_pad[:, None, None, None, None, :],
                             scores_pre, BIG_NEG)
    scores_suf = torch.einsum("bnshgd,bnthd->bnhgst", q32, k_suf.float())
    scores_suf = torch.where(suffix_mask[:, None, None, None],
                             scores_suf, BIG_NEG)
    probs = torch.softmax(torch.cat([scores_pre, scores_suf], dim=-1), dim=-1)
    p_len = scores_pre.shape[-1]
    p_pre = probs[..., :p_len].to(v_pre.dtype)
    p_suf = probs[..., p_len:].to(v_suf.dtype)
    out = torch.einsum("bnhgsp,bphd->bnshgd", p_pre, v_pre)
    out = out + torch.einsum("bnhgst,bnthd->bnshgd", p_suf, v_suf)
    return out.reshape(b, n, s, hq * d)
