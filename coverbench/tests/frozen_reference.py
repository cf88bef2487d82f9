"""A frozen copy of the plain reference's policy as it was before the
backbone's layers moved to `coverbench/backbones/gemma.py` (commit d002048:
`_gemma_qkv`, `_gemma_rest`, `propose`, `episode`), for the test that the
split reference computes the same bits. Everything else it calls is
`coverbench/reference.py`'s, unchanged by the split."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from coverbench.reference import (Numerics, _lin, attention, decode, layer,
                                  policy_image, rms_norm, rope, scores,
                                  time_embedding, tokenize, trajectories,
                                  vit)


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


def propose(pw, cfg, stats, raw, proprio, prompts, noise, num, dev):
    """The K x N candidates of one episode.

    pw: policy weights; cfg: the configuration's `policy` group; stats:
    {"action"|"proprio": {"p01", "p99"}}; prompts: K texts; noise fp32
    [K, N, chunk, max_action_dim]. -> normalised actions [K * N, chunk, 7]."""
    pg, ex, vc = cfg["paligemma"], cfg["expert"], cfg["vision"]
    k_prompts, n = noise.shape[:2]
    chunk = cfg["chunk_size"]
    f32 = torch.float32

    # prefix: image tokens, then each prompt's valid tokens; the scalings
    # by sqrt(width) in the stored precision
    img = policy_image(raw, vc["image_size"], dev)
    tokens, _ = vit(pw["vision"], vc, img, False, num)
    root = math.sqrt(pg["width"])
    root_s = num.r(torch.tensor(root, device=dev))
    img_emb = num.r(num.r(_lin(pw["mm_proj"], tokens) / root) * root_s)
    toks = [tokenize(p, cfg["tokenizer_max_length"], pg["vocab_size"], True)
            for p in prompts]
    n_lang = [int(m.sum()) for _, m in toks]
    n_img = img_emb.shape[0]
    p_max = n_img + max(n_lang)
    emb = torch.zeros((k_prompts, p_max, pg["width"]), dtype=f32, device=dev)
    valid = torch.zeros((k_prompts, p_max), dtype=torch.bool, device=dev)
    for i, (t, _) in enumerate(toks):
        ids = torch.from_numpy(t[:n_lang[i]]).to(dev)
        emb[i, :n_img] = img_emb
        emb[i, n_img:n_img + n_lang[i]] = num.r(
            pw["paligemma"]["embed"][ids].float() * root_s)
        valid[i, :n_img + n_lang[i]] = True
    pos = torch.arange(p_max, device=dev).expand(k_prompts, p_max)
    mask = valid[:, :, None] & valid[:, None, :]

    # prefill: the per-layer keys and values of the valid prefix
    cache = []
    h = emb
    for i in range(pg["depth"]):
        lw = layer(pw["paligemma"]["layers"], i)
        q, k, v = _gemma_qkv(lw, pg, h, pos, num)
        cache.append((k, v))
        h = _gemma_rest(lw, h, attention(q, k, v, mask), num)

    # suffix: [state | chunk actions], positions after each prompt's prefix
    ap01 = torch.tensor(stats["action"]["p01"], dtype=f32, device=dev)
    ap99 = torch.tensor(stats["action"]["p99"], dtype=f32, device=dev)
    pp01 = torch.tensor(stats["proprio"]["p01"], dtype=f32, device=dev)
    pp99 = torch.tensor(stats["proprio"]["p99"], dtype=f32, device=dev)
    prop = torch.from_numpy(np.asarray(proprio, np.float32)).to(dev)
    state = torch.zeros(cfg["max_state_dim"], dtype=f32, device=dev)
    state[:7] = (2 * (prop - pp01) / (pp99 - pp01 + 1e-8) - 1).clamp(-1, 1)
    state_emb = num.r(_lin(pw["state_proj"], state))
    s_len = 1 + chunk
    n_prefix = torch.tensor([n_img + m for m in n_lang], device=dev)
    s_pos = (n_prefix[:, None] + torch.arange(s_len, device=dev)
             )[:, None].expand(k_prompts, n, s_len).reshape(-1, s_len)
    blk = torch.tensor([1] + [2] * chunk, device=dev)
    s_mask = blk[None, :] <= blk[:, None]                 # [S, S]
    key_mask = torch.cat([valid[:, None, :].expand(k_prompts, s_len, p_max),
                          s_mask.expand(k_prompts, s_len, s_len)], dim=-1)
    key_mask = key_mask[:, None].expand(k_prompts, n, s_len, -1).reshape(
        k_prompts * n, s_len, -1)

    def velocity(x_t, t):
        w = cfg["proj_width"]
        a_emb = _lin(pw["action_in_proj"],
                     x_t.reshape(-1, chunk, x_t.shape[-1]))
        t_emb = num.r(time_embedding(t, w, cfg["time_min_period"],
                                     cfg["time_max_period"], dev))
        x = torch.cat([a_emb, t_emb.expand_as(a_emb)], dim=-1)
        x = _lin(pw["time_mlp_out"], F.silu(_lin(pw["time_mlp_in"], x)))
        h = num.r(torch.cat([state_emb.expand(x.shape[0], 1, w), x], dim=1))
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
        h = num.r(rms_norm(h, pw["expert"]["final_norm"]))[:, -chunk:]
        return _lin(pw["action_out_proj"], h)

    steps = cfg["num_denoise_steps"]
    dt = -1.0 / steps
    x_t = noise.reshape(k_prompts * n, chunk, -1).float()
    for i in range(steps):
        t = float(np.float32(1.0) + np.float32(dt) * np.float32(i))
        x_t = x_t + dt * velocity(x_t, t)
    return x_t[..., :7], ap01, ap99


def episode(weights, cfg, stats, raw, proprio, prompts, task, history,
            history_len, noise, quant_levels, dev):
    """The reference's candidates and scores of one episode.
    -> dict of float32 CPU tensors: actions [K * N, chunk, 7] (normalised),
    exec, verif (same shape) and scores [K * N]."""
    num = Numerics(cfg["dtype"], quant_levels)
    with torch.no_grad():
        actions, ap01, ap99 = propose(weights["policy"], cfg["policy"], stats,
                                      raw, proprio, prompts, noise, num, dev)
        exec_, verif = decode(actions, ap01, ap99)
        traj = trajectories(verif, history, history_len,
                            cfg["cover"]["max_history"])
        s = scores(weights["verifier"], cfg["verifier"], raw, task, traj,
                   num, dev)
    return {"actions": actions.cpu(), "exec": exec_.cpu(),
            "verif": verif.cpu(), "scores": s.cpu()}
