"""π0's PaliGemma backbone: PaliGemma-3B's Gemma stack and the Gemma-300M
action expert that mirrors it (configuration groups `policy.paligemma`
and `policy.expert`).

Gemma's arithmetic: embeddings scaled by sqrt(width), RMSNorm as
x / rms(x) * (1 + w), GeGLU MLPs (tanh GELU), grouped-query attention with
half-split RoPE; the expert's suffix attends the prompt's cached keys and
values and its own, jointly. The program's side runs under
`replace(fast_pi0_config(cfg), attention_impl="cuda")`: K1 decodes the
expert's suffix over the shared prefix, K3 prefills.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from coverbench.reference import attention, layer, rms_norm, rope
from coverbench.yardstick import BF16, flash_exact, num_patches

# ---------------------------------------------------------------------------
# The program's side
# ---------------------------------------------------------------------------


def port_configs(config: dict, traffic: dict):
    """The program's config objects for a configuration file and a mix."""
    from cover_vla_tpu_torch.configs import (
        CoVerConfig, GemmaConfig, Pi0Config, SiglipTextConfig,
        VerifierConfig, VitConfig, fast_pi0_config, fast_verifier_config,
        replace)
    p = dict(config["policy"])
    pcfg = Pi0Config(paligemma=GemmaConfig(**p.pop("paligemma")),
                     expert=GemmaConfig(**p.pop("expert")),
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
    from cover_vla_tpu_torch.ops import quant
    return quant.quantize_pi0_policy(ptree)


def prompt_vocab(policy: dict) -> int:
    return policy["paligemma"]["vocab_size"]


def weight_rule(path, shape):
    """Gemma's RMSNorm weights (1 + w) and its token embedding."""
    if path[-1] in ("input_ln", "post_ln", "final_norm"):
        return 0.1, 0.0
    if path[-1] == "embed":
        return 0.02, 0.0
    return None


# ---------------------------------------------------------------------------
# The plain reference's layers
# ---------------------------------------------------------------------------


def _gemma_qkv(lw, cfg, h, pos, num):
    x = num.r(rms_norm(h, lw["input_ln"]))
    lead = x.shape[:-1]
    q = num.mm(x, lw["q"], True).reshape(*lead, cfg["num_heads"],
                                          cfg["head_dim"])
    k = num.mm(x, lw["k"], True).reshape(*lead, cfg["num_kv_heads"],
                                          cfg["head_dim"])
    v = num.mm(x, lw["v"], True).reshape(*lead, cfg["num_kv_heads"],
                                          cfg["head_dim"])
    return num.r(rope(q, pos)), num.r(rope(k, pos)), v


def _gemma_rest(lw, h, attn, num):
    h = num.r(h + num.mm(num.r(attn), lw["o"], True))
    y = num.r(rms_norm(h, lw["post_ln"]))
    g = num.r(F.gelu(num.mm(y, lw["gate"], True), approximate="tanh"))
    g = num.r(g * num.mm(y, lw["up"], True))
    return num.r(h + num.mm(g, lw["down"], True))


def embed(pw, pol, image, ids, num):
    """The prefix's embeddings, scaled by sqrt(width) in the stored
    precision. image: the projected image tokens [n_img, W]; ids: each
    prompt's valid token ids. -> (image embeddings [n_img, W], [each
    prompt's token embeddings [n_i, W]])."""
    root = math.sqrt(pol["paligemma"]["width"])
    root_s = num.r(torch.tensor(root, device=image.device))
    img_emb = num.r(num.r(image / root) * root_s)
    table = pw["paligemma"]["embed"]
    return img_emb, [num.r(table[i].float() * root_s) for i in ids]


def prefill(pw, pol, emb, pos, mask, num):
    """The per-layer keys and values of the valid prefix."""
    pg = pol["paligemma"]
    cache = []
    h = emb
    for i in range(pg["depth"]):
        lw = layer(pw["paligemma"]["layers"], i)
        q, k, v = _gemma_qkv(lw, pg, h, pos, num)
        cache.append((k, v))
        h = _gemma_rest(lw, h, attention(q, k, v, mask), num)
    return cache


def expert(pw, pol, h, s_pos, cache, key_mask, k_prompts, n, num):
    """The expert over the suffix h [K * N, S, W], each prompt's N
    candidates attending its cached prefix and their own suffix jointly;
    -> the final norm's output [K * N, S, W]."""
    ex = pol["expert"]
    for i in range(ex["depth"]):
        lw = layer(pw["expert"]["layers"], i)
        q, k, v = _gemma_qkv(lw, ex, h, s_pos, num)
        kp, vp = cache[i]
        kp = kp[:, None].expand(k_prompts, n, *kp.shape[1:]).reshape(
            k_prompts * n, *kp.shape[1:])
        vp = vp[:, None].expand(k_prompts, n, *vp.shape[1:]).reshape(
            k_prompts * n, *vp.shape[1:])
        attn = attention(q, torch.cat([kp, k], 1), torch.cat([vp, v], 1),
                         key_mask, store=num.r)
        h = _gemma_rest(lw, h, attn, num)
    return num.r(rms_norm(h, pw["expert"]["final_norm"]))


# ---------------------------------------------------------------------------
# Yardstick: model FLOPs and the hand kernels' work
# ---------------------------------------------------------------------------


def _gemma_matmul_params(g: dict) -> float:
    qd = g["num_heads"] * g["head_dim"]
    kvd = g["num_kv_heads"] * g["head_dim"]
    return g["depth"] * (g["width"] * qd + 2 * g["width"] * kvd
                         + qd * g["width"] + 3 * g["width"] * g["mlp_dim"])


def policy_flops(policy: dict, k: int, n: int) -> float:
    """Model FLOPs of one episode's K prompt prefills through PaliGemma
    and the Euler-loop expert decode over N candidates a prompt attending
    the cached prefix, attention products included."""
    pg, ex = policy["paligemma"], policy["expert"]
    p_len = num_patches(policy["vision"]) + policy["tokenizer_max_length"]
    s_len = 1 + policy["chunk_size"]
    qd_pg = pg["num_heads"] * pg["head_dim"]
    qd_ex = ex["num_heads"] * ex["head_dim"]

    prefill = 2 * _gemma_matmul_params(pg) * k * p_len
    prefill += 2 * 2 * pg["depth"] * k * p_len * p_len * qd_pg
    dec_tokens = policy["num_denoise_steps"] * k * n * s_len
    decode = 2 * _gemma_matmul_params(ex) * dec_tokens
    decode += 2 * 2 * ex["depth"] * dec_tokens * (p_len + s_len) * qd_ex
    return prefill + decode


# the wgmma bodies' symbols as a trace names them:
#   void (anonymous namespace)::decode_wgmma_kernel<256>(...DecodeParams)
#   void (anonymous namespace)::flash_wgmma_kernel<256, 2, true>(...WgParams)
# (K3 is the flash body with its EXACT flag set)
K1_SYMBOL = "decode_wgmma_kernel<"
KERNELS = {"K1": lambda name: K1_SYMBOL in name,
           "K3": lambda name: flash_exact(name) is True}


def k1_work(rows_valid_prefix, n: int, s: int, hq: int, hkv: int, d: int,
            p_len: int):
    """K1 `shared_prefix_gqa` over B = len(rows_valid_prefix) prefix rows,
    each with N candidates of S suffix tokens: q [B, N, S, Hq, D], k/v
    suffix [B, N, S, Hkv, D], k/v prefix [B, P, Hkv, D], the prefix pad
    mask bool [B, P] and the suffix mask bool [B, S, S]; every candidate's
    rows attend the row's valid prefix keys and its own suffix."""
    b = len(rows_valid_prefix)
    q = b * n * s * hq * d * BF16
    nbytes = (2 * q + 2 * b * n * s * hkv * d * BF16
              + 2 * b * p_len * hkv * d * BF16 + b * p_len + b * s * s)
    keys = sum(rows_valid_prefix) + b * s
    return float(nbytes), float(4 * n * s * hq * d * keys)


def k3_work(rows_valid, p_len: int, hq: int, hkv: int, d: int):
    """K3 `prefix_gqa`: q [B, P, Hq, D], k/v [B, P, Hkv, D], mask bool
    [B, P, P]; each row's valid tokens attend each other (the prefix is
    bidirectional over its valid tokens)."""
    b = len(rows_valid)
    q = b * p_len * hq * d * BF16
    nbytes = 2 * q + 2 * b * p_len * hkv * d * BF16 + b * p_len * p_len
    pairs = sum(v * v for v in rows_valid)
    return float(nbytes), float(4 * hq * d * pairs)


def kernel_work(policy: dict, rows, n: int) -> dict:
    """{kernel: (bytes, FLOPs, launches)} of K1 and K3 at one boundary.
    rows: each prompt's valid prefix tokens (image and valid text)."""
    pg, ex = policy["paligemma"], policy["expert"]
    p_len = num_patches(policy["vision"]) + policy["tokenizer_max_length"]
    k1 = k1_work(rows, n, 1 + policy["chunk_size"], ex["num_heads"],
                 ex["num_kv_heads"], ex["head_dim"], p_len)
    k3 = k3_work(rows, p_len, pg["num_heads"], pg["num_kv_heads"],
                 pg["head_dim"])
    return {"K1": (*k1, ex["depth"] * policy["num_denoise_steps"]),
            "K3": (*k3, pg["depth"])}
