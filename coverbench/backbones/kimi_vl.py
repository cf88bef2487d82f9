"""π0 over Kimi-VL-A3B-Instruct's language model (configuration groups
`policy.paligemma`, under config.json's own key names, and
`policy.expert`): a DeepSeek-V3-shaped decoder, multi-head latent
attention (MLA, arXiv 2405.04434) and, after one dense layer, mixtures of
64 sigmoid-routed SwiGLU experts with a correction bias and 2 shared
experts (`noaux_tc`, arXiv 2412.19437); the action expert mirrors its
attention geometry with a dense SwiGLU.

The arithmetic, as the reference below writes it: RMSNorm as
w * x / rms(x); no embedding scale; per layer q = x W_q per head
[q_nope | q_pe], [c_kv | k_pe] = x W_kv_a, c_kv RMS-normed, the rope key
k_pe shared by the heads, rotated in DeepSeek's interleaved pairs;
explicit keys [c_kv W_UK | k_pe] and values c_kv W_UV per head (kv_b),
softmax scale 1/sqrt(qk_nope + qk_rope); the expert's suffix attends the
prompt's explicit prefix keys and values and its own, jointly. Routing:
fp32 logits, sigmoid scores, the top k on score + bias, the chosen scores
normalised to sum 1 and times routed_scaling_factor, each expert's rows in
a loop of its own. The program's side runs under
`replace(fast_pi0_config(cfg), attention_impl="cuda")`: K3 prefills (head
dim 192, the values zero-padded), the experts run as grouped products
(`MOE`), and the decode is the program's absorbed latent attention, no
hand kernel.

In the benchmark: `KERNELS` adds the category `MOE` (the routed
experts' grouped products, CUTLASS's sm90 grouped GEMM, which
`moe_gemm_roofline` reads against `kernel_work`'s `MOE`) beside K3; the
spans `moe.block` and `mla.decode` feed `moe_ms_per_boundary` and
`mla_decode_ms_per_boundary`. The program has no int8 route for this
backbone (`quantize` raises), so its cells' control is
`--control reference_int4` (the reference on the int4 grid in the
program's place), not `program_w8a8`. The harness has no control on the
int8 grid yet; the Kimi cell's `action_rms` limit also sits under the
reference's readings there, taken with 127 levels in its place.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from coverbench.backbones.gemma import k3_work
from coverbench.reference import layer
from coverbench.yardstick import BF16, flash_exact, num_patches

# config.json's routing and attention that this module implements; a
# configuration that states another is refused
PUBLISHED = {"topk_method": "noaux_tc", "scoring_func": "sigmoid",
             "hidden_act": "silu", "n_group": 1, "topk_group": 1,
             "moe_layer_freq": 1, "norm_topk_prob": True, "q_lora_rank": None,
             "rope_scaling": None, "attention_bias": False}

# ---------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------


def port_stack(g: dict):
    """A config.json-named group -> the program's `MlaMoeConfig`."""
    from cover_vla_tpu_torch.configs import MlaMoeConfig
    for key, want in PUBLISHED.items():
        if key in g and g[key] != want:
            raise ValueError(f"{key} {g[key]!r}: this backbone implements "
                             f"{want!r}")
    experts = g.get("n_routed_experts") or 0
    return MlaMoeConfig(
        width=g["hidden_size"], depth=g["num_hidden_layers"],
        num_heads=g["num_attention_heads"], mlp_dim=g["intermediate_size"],
        kv_lora_rank=g["kv_lora_rank"], qk_nope_dim=g["qk_nope_head_dim"],
        qk_rope_dim=g["qk_rope_head_dim"], v_head_dim=g["v_head_dim"],
        num_experts=experts,
        experts_per_token=g["num_experts_per_tok"] if experts else 0,
        moe_dim=g["moe_intermediate_size"] if experts else 0,
        num_shared_experts=g["n_shared_experts"] if experts else 0,
        first_dense=g["first_k_dense_replace"] if experts else 0,
        routed_scaling=g["routed_scaling_factor"] if experts else 1.0,
        vocab_size=g.get("vocab_size", 0), rope_theta=float(g["rope_theta"]),
        rms_eps=g["rms_norm_eps"])


def port_configs(config: dict, traffic: dict):
    """The program's config objects for a configuration file and a mix."""
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, Pi0Config, SiglipTextConfig, VerifierConfig, VitConfig,
        fast_pi0_config, fast_verifier_config, replace)
    p = dict(config["policy"])
    pcfg = Pi0Config(paligemma=port_stack(p.pop("paligemma")),
                     expert=port_stack(p.pop("expert")),
                     vision=VitConfig(**p.pop("vision")), **p)
    v = dict(config["verifier"])
    members = v.pop("members")
    vcfg = VerifierConfig(vision=VitConfig(**v.pop("vision")),
                          text=SiglipTextConfig(**v.pop("text")), **v)
    ccfg = CoVerConfig(n_samples=traffic["n_samples"],
                       n_rephrases=traffic["n_rephrases"], **config["cover"])
    return (replace(fast_pi0_config(pcfg), attention_impl="cuda"),
            fast_verifier_config(vcfg), ccfg, members)


def policy_meta(pcfg):
    from cover_vla_tpu_torch.models import pi0
    return pi0.init_pi0(0, pcfg, device="meta")


def quantize(ptree):
    raise NotImplementedError(
        "kimi_vl: the program has no int8 route for an MLA + MoE backbone "
        "(its configurations are bf16; their control is reference_int4)")


def prompt_vocab(policy: dict) -> int:
    return policy["paligemma"]["vocab_size"]


def weight_rule(path, shape):
    """RMSNorm weights (w itself) around 1; the routers' correction bias
    drawn from the seed (a zero bias would hide what it chooses); the token
    embedding at the image tokens' scale, since nothing scales it."""
    if path[-1] in ("input_ln", "post_ln", "kv_ln", "final_norm"):
        return 0.1, 1.0
    if path[-2:] == ("moe", "bias"):
        return 0.05, 0.0
    if path[-1] == "embed":
        return 1.0, 0.0
    return None


# ---------------------------------------------------------------------------
# The plain reference's layers
# ---------------------------------------------------------------------------


def _norm(x, w, eps):
    """w * x / rms(x)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rope(x, pos, theta):
    """DeepSeek's rotary embedding on consecutive pairs (x[2i], x[2i+1])
    as complex numbers times exp(i pos / theta**(2i/d)). x [..., T, H, d];
    pos [..., T]."""
    d = x.shape[-1]
    freq = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                        dtype=torch.float32) / d)
    ang = pos.float()[..., None, None] * freq
    z = torch.view_as_complex(x.float().reshape(*x.shape[:-1], d // 2, 2)
                              .contiguous())
    return torch.view_as_real(z * torch.polar(torch.ones_like(ang), ang)
                              ).reshape(x.shape)


def _mla(lw, g, h, pos, num):
    """-> (queries [..., T, H, dn + dr], c_kv [..., T, r], k_pe [..., T,
    dr]), each stored."""
    dn, dr = g["qk_nope_head_dim"], g["qk_rope_head_dim"]
    r, eps = g["kv_lora_rank"], g["rms_norm_eps"]
    x = num.r(_norm(h, lw["input_ln"], eps))
    q = num.mm(x, lw["q"], True).reshape(*x.shape[:-1],
                                         g["num_attention_heads"], dn + dr)
    q = torch.cat([q[..., :dn], num.r(_rope(q[..., dn:], pos,
                                            g["rope_theta"]))], dim=-1)
    kv = num.mm(x, lw["kv_a"], True)
    c = num.r(_norm(kv[..., :r], lw["kv_ln"], eps))
    k_pe = num.r(_rope(kv[..., None, r:], pos, g["rope_theta"]))[..., 0, :]
    return q, c, k_pe


def _keys_values(kv_b, g, c, k_pe, num):
    """The explicit per-head keys [c W_UK | k_pe] and values c W_UV."""
    dn, heads = g["qk_nope_head_dim"], g["num_attention_heads"]
    kvb = num.mm(c, kv_b, True).reshape(*c.shape[:-1], heads, -1)
    k = torch.cat([kvb[..., :dn],
                   k_pe[..., None, :].expand(*k_pe.shape[:-1], heads, -1)],
                  dim=-1)
    return k, kvb[..., dn:]


def _attend(q, k, v, mask):
    """q [B, Tq, H, dq]; k [B, Tk, H, dq]; v [B, Tk, H, dv]; mask bool
    [B, Tq, Tk]; float32 softmax. -> [B, Tq, H * dv]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    s = torch.where(mask[:, None], s, torch.full_like(s, -1e30))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return out.reshape(*out.shape[:2], -1)


def _swiglu(x, gate_up, down, num):
    m = gate_up.shape[-1] // 2
    g = num.mm(x, gate_up[..., :m], True)
    u = num.mm(x, gate_up[..., m:], True)
    return num.mm(num.r(num.r(F.silu(g)) * u), down, True)


def _route(mw, g, x):
    """The fp32 router over the tokens x [T, W]: sigmoid scores, the top k
    experts chosen on score + correction bias, weighted by their scores
    (not the bias) normalised to sum 1, times routed_scaling_factor.
    -> (chosen experts [T, k], weights [T, k])."""
    scores = torch.sigmoid(x @ mw["router"].float())
    chosen = torch.topk(scores + mw["bias"].float(),
                        g["num_experts_per_tok"], dim=-1).indices
    w = scores.gather(-1, chosen)
    return chosen, w / (w.sum(-1, keepdim=True) + 1e-20) \
        * g["routed_scaling_factor"]


def _moe(mw, g, x, num, routing=None):
    """The mixture of experts over the stored tokens x [T, W]: the
    routing (`_route`'s unless given), each routed expert over the rows
    that chose it, the weighted sum in float32, plus the shared experts."""
    chosen, w = routing if routing is not None else _route(mw, g, x)
    y = torch.zeros_like(x)
    for e in range(g["n_routed_experts"]):
        tok, slot = (chosen == e).nonzero(as_tuple=True)
        if len(tok):
            y[tok] += w[tok, slot, None] * _swiglu(
                x[tok], mw["gate_up"][e], mw["down"][e], num)
    shared = _swiglu(x, mw["shared_gate_up"], mw["shared_down"], num)
    return num.r(num.r(y) + shared)


def _ffn(stack, g, i, y, num):
    if not g.get("n_routed_experts") or i < g["first_k_dense_replace"]:
        lw = layer(stack["dense"], i)
        return _swiglu(y, lw["gate_up"], lw["down"], num)
    flat = y.reshape(-1, y.shape[-1])
    out = _moe(layer(stack["moe"], i - g["first_k_dense_replace"]), g, flat,
               num)
    return out.reshape(y.shape)


def _block(stack, g, i, lw, h, attn, num):
    h = num.r(h + num.mm(num.r(attn), lw["o"], True))
    y = num.r(_norm(h, lw["post_ln"], g["rms_norm_eps"]))
    return num.r(h + _ffn(stack, g, i, y, num))


def embed(pw, pol, image, ids, num):
    """The prefix's embeddings, unscaled: the projected image tokens
    stored, each prompt's token rows. (The episode's first call: float32
    products stay float32 on the card, TF32 off.)"""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    table = pw["paligemma"]["embed"]
    return num.r(image), [num.r(table[i].float()) for i in ids]


def prefill(pw, pol, emb, pos, mask, num):
    """Each layer's explicit keys and values of the valid prefix."""
    g, stack = pol["paligemma"], pw["paligemma"]
    cache = []
    h = emb
    for i in range(g["num_hidden_layers"]):
        lw = layer(stack["layers"], i)
        q, c, k_pe = _mla(lw, g, h, pos, num)
        k, v = _keys_values(lw["kv_b"], g, c, k_pe, num)
        cache.append((k, v))
        h = _block(stack, g, i, lw, h, _attend(q, k, v, mask), num)
    return cache


def expert(pw, pol, h, s_pos, cache, key_mask, k_prompts, n, num):
    """The expert over the suffix h [K * N, S, W], each prompt's N
    candidates attending its cached prefix and their own suffix jointly;
    -> the final norm's output [K * N, S, W]."""
    g, stack = pol["expert"], pw["expert"]
    for i in range(g["num_hidden_layers"]):
        lw = layer(stack["layers"], i)
        q, c, k_pe = _mla(lw, g, h, s_pos, num)
        k, v = _keys_values(lw["kv_b"], g, c, k_pe, num)
        kp, vp = (x[:, None].expand(k_prompts, n, *x.shape[1:]).reshape(
            k_prompts * n, *x.shape[1:]) for x in cache[i])
        attn = _attend(q, torch.cat([kp, k], 1), torch.cat([vp, v], 1),
                       key_mask)
        h = _block(stack, g, i, lw, h, attn, num)
    return num.r(_norm(h, stack["final_norm"], g["rms_norm_eps"]))


# ---------------------------------------------------------------------------
# Yardstick: model FLOPs and the hand kernels' work
# ---------------------------------------------------------------------------


def _attention_params(g: dict) -> float:
    """q, kv_a, kv_b and o of one layer."""
    w, heads = g["hidden_size"], g["num_attention_heads"]
    dq = g["qk_nope_head_dim"] + g["qk_rope_head_dim"]
    r = g["kv_lora_rank"]
    return (w * heads * dq + w * (r + g["qk_rope_head_dim"])
            + r * heads * (g["qk_nope_head_dim"] + g["v_head_dim"])
            + heads * g["v_head_dim"] * w)


def _active_params(g: dict) -> float:
    """The matmul parameters one token runs through: every layer's
    attention, the dense SwiGLUs, and in each MoE layer the router, its
    top-k routed experts and the shared experts."""
    w, depth = g["hidden_size"], g["num_hidden_layers"]
    total = depth * _attention_params(g)
    if not g.get("n_routed_experts"):
        return total + depth * 3 * w * g["intermediate_size"]
    dense = g["first_k_dense_replace"]
    m = g["moe_intermediate_size"]
    moe = (w * g["n_routed_experts"] + g["num_experts_per_tok"] * 3 * w * m
           + 3 * w * g["n_shared_experts"] * m)
    return total + dense * 3 * w * g["intermediate_size"] \
        + (depth - dense) * moe


def _attention_flops(g: dict, queries: float, keys: int) -> float:
    """q.k over dn + dr and p.v over dv, every head, every layer."""
    per = g["qk_nope_head_dim"] + g["qk_rope_head_dim"] + g["v_head_dim"]
    return 2 * g["num_hidden_layers"] * queries * keys \
        * g["num_attention_heads"] * per


def policy_flops(policy: dict, k: int, n: int) -> float:
    """Model FLOPs of one episode's K prompt prefills and the Euler-loop
    expert decode over N candidates a prompt, as the reference computes
    them: non-absorbed attention over explicit keys and values, each
    token through 6 routed and the shared experts."""
    lm, ex = policy["paligemma"], policy["expert"]
    p_len = num_patches(policy["vision"]) + policy["tokenizer_max_length"]
    s_len = 1 + policy["chunk_size"]
    prefill_ = 2 * _active_params(lm) * k * p_len
    prefill_ += _attention_flops(lm, k * p_len, p_len)
    dec_tokens = policy["num_denoise_steps"] * k * n * s_len
    decode = 2 * _active_params(ex) * dec_tokens
    decode += _attention_flops(ex, dec_tokens, p_len + s_len)
    return prefill_ + decode


# K3 is the flash body with its EXACT flag set; the routed experts' grouped
# products are CUTLASS's sm90 grouped GEMM, as a trace names it:
#   _ZN7cutlass13device_kernelIN2at4cuda6detail25enable_3x_kernel_for_sm9x
#   INS_4gemm6kernel13GemmUniversalINS5_17GroupProblemShapeI...
MOE_SYMBOL = "GroupProblemShape"
KERNELS = {"K3": lambda name: flash_exact(name) is True,
           "MOE": lambda name: MOE_SYMBOL in name}
# The program routes a MoE layer's tokens in passes of this many, two
# grouped products a pass (the program's `mla_moe.MOE_CHUNK_TOKENS`; a test
# holds the two equal). It sets how many launches the trace should show.
MOE_CHUNK_TOKENS = 32_768


def moe_work(g: dict, tokens: int):
    """The routed experts' products of one boundary: (bytes, FLOPs,
    launches) over every MoE layer, `tokens` routed through each. FLOPs:
    2 x routed rows x 3 x W x M a layer; bytes: each expert's weights once
    a layer, and the routed rows in and out of both products ([gate | up]
    then down), bf16. Work and bytes do not depend on how the rows are cut
    into passes; the launches, two a pass of `MOE_CHUNK_TOKENS` tokens, are
    what the trace shows, so that a trace that lost some keeps their share
    of the work."""
    w, m = g["hidden_size"], g["moe_intermediate_size"]
    layers = g["num_hidden_layers"] - g["first_k_dense_replace"]
    rows = tokens * g["num_experts_per_tok"]
    weights = g["n_routed_experts"] * 3 * w * m * BF16
    acts = rows * ((w + 2 * m) + (m + w)) * BF16
    passes = -(-tokens // MOE_CHUNK_TOKENS)
    return (float(layers * (weights + acts)),
            float(layers * 2 * rows * 3 * w * m), 2 * layers * passes)


def kernel_work(policy: dict, rows, n: int) -> dict:
    """{kernel: (bytes, FLOPs, launches)} of K3 and the MoE's grouped
    products at one boundary. rows: each prompt's valid prefix tokens (K3
    attends those); every token of the padded prefix is routed."""
    lm = policy["paligemma"]
    p_len = num_patches(policy["vision"]) + policy["tokenizer_max_length"]
    dq = lm["qk_nope_head_dim"] + lm["qk_rope_head_dim"]
    heads = lm["num_attention_heads"]
    # No metric reads K3 here yet: `k3_roofline` lists the Gemma cells, and
    # this entry is its work once a benchmark change lists this cell too.
    k3 = k3_work(rows, p_len, heads, heads, dq)
    nbytes, flops, launches = moe_work(lm, len(rows) * p_len)
    return {"K3": (*k3, lm["num_hidden_layers"]),
            "MOE": (nbytes / launches, flops / launches, launches)}
