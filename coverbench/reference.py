"""Plain reference of one CoVer-VLA verified step for ONE episode.

Written from the published descriptions (π0, arXiv 2410.24164; SigLIP,
PaliGemma; CoVer-VLA, arXiv 2602.12281), in plain PyTorch and NumPy: no
kernel, no cache object, no batching over episodes. It imports nothing of
the program, and takes nothing the program made: it reads the weights the
benchmark made (nested dicts keyed as the program's trees are), the raw
frame, the proprio, the prompt texts and the flow's noise, and works out
again what the program derives from them (tokens, images, the quantized
weights of the w8a8 route).

Numerics: every product and sum in float32 with TF32 off (the integer
products of the w8a8 route exactly, in float64), and every value rounded
to the configuration's stored precision where the published model stores
it: for a bf16 configuration, the transformer stacks' weights,
activations, residual streams and attention keys and values in bf16;
norms, softmax, RoPE and the heads in float32; π0's image, state and
time embeddings rounded through bf16 as openpi does. A float32
configuration rounds nothing. Rounding at the stated precision is what
lets the comparison see the step below it: against a reference that
rounds nothing, a bf16 program's own rounding reads half of what its
int8 route adds (PERF.md).

`quant_levels` selects the w8a8 route: None is none; 127 rounds every
quantized GEMM's activations (per token) and weights (per output channel)
to the int8 grid, 7 to the int4 grid (the control of a w8a8
configuration). The quantized GEMMs are the policy backbone's (for
Gemma, its two stacks' seven matmuls) and the block matmuls of both vision
towers.

What depends on the policy's backbone (its prompt embedding, prefill and
action expert) lives in the configuration's backbone module
(`coverbench/backbones/<backbone>.py`), which this module calls between
its own stages: images, the towers, the state and time embeddings, the
Euler loop, decoding, the verifier and the selection are the same for
every backbone.

The prefix is computed on each prompt's tokens padded to the longest
prompt of the episode, not to the tokenizer's 72: padding is masked.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30          # a masked attention score (finite, so no NaN rows)
PAD_VALUE = -5.0     # the verifier's trajectory top padding


# ---------------------------------------------------------------------------
# Tokenizers: the word-hash vocabulary the program falls back to without
# tokenizer files (BOS 2, pad 0, a trailing newline token, right padding)
# ---------------------------------------------------------------------------


def _word_id(word: str, vocab: int) -> int:
    h = hashlib.md5(word.encode()).digest()
    return 3 + int.from_bytes(h[:4], "little") % (vocab - 3)


def tokenize(text: str, max_len: int, vocab: int, add_bos: bool):
    """-> (int64 tokens [max_len], bool mask [max_len])."""
    ids = [2] if add_bos else []
    ids += [_word_id(w, vocab) for w in text.strip().lower().split()]
    ids = (ids + [_word_id("\n", vocab)])[:max_len]
    tokens = np.zeros(max_len, np.int64)
    mask = np.zeros(max_len, bool)
    tokens[:len(ids)] = ids
    mask[:len(ids)] = True
    return tokens, mask


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------


def _lanczos4_taps(src: int, dst: int):
    """cv2's INTER_LANCZOS4 for 8-bit images: per output pixel 8 source
    indices (clamped at the border) and coefficients in fixed point at
    scale 2048 (interpolateLanczos4: float32 sum, normalised, rounded)."""
    s45 = 0.70710678118654752440084436210485
    cs = [(1, 0), (-s45, -s45), (0, 1), (s45, -s45),
          (-1, 0), (s45, s45), (0, -1), (-s45, s45)]
    idx = np.zeros((dst, 8), np.int64)
    coef = np.zeros((dst, 8), np.int64)
    scale = src / dst
    for d in range(dst):
        fx = np.float32((d + 0.5) * scale - 0.5)
        sx = int(math.floor(fx))
        fx = np.float32(fx - np.float32(sx))
        c = np.zeros(8, np.float32)
        if fx < np.finfo(np.float32).eps:
            c[3] = 1.0
        else:
            y0 = -(float(fx) + 3) * math.pi * 0.25
            s0, c0 = math.sin(y0), math.cos(y0)
            total = np.float32(0.0)
            for i in range(8):
                y = -(float(fx) + 3 - i) * math.pi * 0.25
                c[i] = np.float32((cs[i][0] * s0 + cs[i][1] * c0) / (y * y))
                total = np.float32(total + c[i])
            c = (c * (np.float32(1.0) / total)).astype(np.float32)
        coef[d] = np.rint((c * np.float32(2048.0)).astype(np.float64))
        idx[d] = np.clip(sx - 3 + np.arange(8), 0, src - 1)
    return idx, coef


def lanczos4_uint8(img: np.ndarray, size: int) -> np.ndarray:
    """cv2.resize(uint8 [H, W, C], (size, size), INTER_LANCZOS4): integer
    taps, (acc + 2**21) >> 22, saturation."""
    h, w = img.shape[:2]
    if (h, w) == (size, size):
        return img
    xi, xc = _lanczos4_taps(w, size)
    yi, yc = _lanczos4_taps(h, size)
    src = img.astype(np.int64)
    rows = np.einsum("hwkc,wk->hwc", src[:, xi, :], xc)
    acc = np.einsum("hkwc,hk->hwc", rows[yi, :, :], yc)
    return np.clip((acc + (1 << 21)) >> 22, 0, 255).astype(np.uint8)


def _bicubic_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] PIL BICUBIC (a = -0.5) weights; on downscale the support
    widens by the scale; taps outside the image are dropped and the rest
    renormalised."""
    a = -0.5

    def cubic(x):
        x = abs(x)
        if x < 1.0:
            return ((a + 2) * x - (a + 3)) * x * x + 1
        if x < 2.0:
            return (((x - 5) * x + 8) * x - 4) * a
        return 0.0

    scale = src / dst
    fscale = max(scale, 1.0)
    support = 2.0 * fscale
    m = np.zeros((dst, src), np.float64)
    for d in range(dst):
        center = (d + 0.5) * scale
        lo = max(int(center - support + 0.5), 0)
        hi = min(int(center + support + 0.5), src)
        w = np.array([cubic((x - center + 0.5) / fscale)
                      for x in range(lo, hi)])
        m[d, lo:hi] = w / w.sum()
    return m.astype(np.float32)


def verifier_image(raw: np.ndarray, size: int, dev) -> torch.Tensor:
    """uint8 [256, 256, 3] -> PIL-bicubic to size (8-bit: rounded and
    clamped after each pass) -> (x / 255 - 0.5) / 0.5. [size, size, 3]."""
    if raw.shape[:2] != (256, 256):
        raise ValueError("the verifier's antialiased 256 resize is not "
                         "part of this reference: frames are 256 x 256")
    x = torch.from_numpy(raw).to(dev).float()
    mw = torch.from_numpy(_bicubic_weights(256, size)).to(dev)
    x = torch.einsum("ws,hsc->hwc", mw, x).round().clamp(0, 255)
    x = torch.einsum("hs,swc->hwc", mw, x).round().clamp(0, 255)
    return (x / 255.0 - 0.5) / 0.5


def policy_image(raw: np.ndarray, size: int, dev) -> torch.Tensor:
    x = torch.from_numpy(lanczos4_uint8(raw, size)).to(dev).float()
    return (x / 255.0 - 0.5) / 0.5


# ---------------------------------------------------------------------------
# Numerics and building blocks. Tensors are float32 throughout; `num.r`
# rounds a value to the stored precision and back.
# ---------------------------------------------------------------------------


class Numerics:
    """The stored precision (`dtype` of the configuration) and the w8a8
    grid (`levels`: None, 127 or 7)."""

    def __init__(self, dtype: str, levels=None):
        self.store = {"bfloat16": torch.bfloat16,
                      "float32": torch.float32}[dtype]
        self.levels = levels

    def r(self, x):
        return x.to(self.store).float()

    def mm(self, x, w, quantized: bool):
        """x @ w of a transformer stack, its result stored. On the w8a8
        grid: activations per token and weights per output channel,
        symmetric absmax / levels, rounded half to even and clamped; the
        integer products summed exactly and rescaled as (acc * sx) * sw."""
        w = w.float()
        if not (quantized and self.levels is not None):
            return self.r(x @ w)
        lv = torch.tensor(float(self.levels), device=x.device)
        sx = (x.abs().amax(-1, keepdim=True) / lv).clamp_min(1e-12)
        sw = (w.abs().amax(-2, keepdim=True) / lv).clamp_min(1e-12)
        xq = torch.round(x / sx).clamp(-lv, lv).double()
        wq = torch.round(w / sw).clamp(-lv, lv).double()
        return self.r((xq @ wq).float() * sx * sw)

    def dense(self, x, p, quantized: bool):
        """A ViT matmul with its bias: x @ kernel, stored, plus the bias,
        stored."""
        return self.r(self.mm(x, p["kernel"], quantized) + p["bias"].float())


def layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, x.shape[-1:], scale.float(), bias.float(), eps)


def rms_norm(x, w, eps=1e-6):
    """Gemma RMSNorm: x / rms(x) * (1 + w)."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + w.float())


def rope(x, pos, theta=10_000.0):
    """Half-split rotary embedding. x [..., T, H, D]; pos [..., T]."""
    d = x.shape[-1]
    freq = theta ** (torch.arange(d // 2, device=x.device,
                                  dtype=torch.float32) * (2.0 / d))
    ang = (pos.float()[..., None] / freq)[..., None, :]
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mask=None, store=None):
    """q [B, Tq, H, D]; k, v [B, Tk, Hkv, D] (H a multiple of Hkv); mask
    bool [B, Tq, Tk]. -> [B, Tq, H * D]. `store` (a Numerics' rounding):
    the flash-attention convention of bf16 attention, the exponentials
    stored before the product with V and summed as stored for the
    normaliser; without it, a float32 softmax."""
    b, tq, h, d = q.shape
    g = h // k.shape[2]
    k = k.repeat_interleave(g, dim=2)
    v = v.repeat_interleave(g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if mask is not None:
        s = torch.where(mask[:, None], s, torch.full_like(s, NEG))
    if store is None:
        p, norm = torch.softmax(s, dim=-1), 1.0
    else:
        p = store(torch.exp(s - s.amax(dim=-1, keepdim=True)))
        norm = p.sum(dim=-1)[..., None].transpose(1, 2)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v) / norm
    return out.reshape(b, tq, h * d)


def patches(img, p):
    """[H, W, C] -> [(H/p) * (W/p), p * p * C], row-major patches."""
    h, w, c = img.shape
    x = img.reshape(h // p, p, w // p, p, c).permute(0, 2, 1, 3, 4)
    return x.reshape((h // p) * (w // p), p * p * c)


def vit_block(lw, h, heads, eps, exact_gelu, num, quantized):
    """Pre-LN block -> (h, attention sublayer output)."""
    t, w = h.shape[-2:]
    x = num.r(layer_norm(h, lw["ln1"]["scale"], lw["ln1"]["bias"], eps))
    a = lw["attn"]
    q, k, v = (num.dense(x, a[n], quantized).reshape(-1, t, heads, w // heads)
               for n in ("q", "k", "v"))
    attn_out = num.dense(num.r(attention(q, k, v, store=num.r)), a["o"],
                         quantized)
    h = num.r(h + attn_out)
    y = num.r(layer_norm(h, lw["ln2"]["scale"], lw["ln2"]["bias"], eps))
    m = lw["mlp"]
    y = num.r(F.gelu(num.dense(y, m["fc1"], quantized),
                     approximate="none" if exact_gelu else "tanh"))
    return num.r(h + num.dense(y, m["fc2"], quantized)), attn_out


def layer(tree, i):
    """Layer i of a tree stacked along its first axis."""
    return {k: (layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def vit(wts, cfg, img, exact_gelu, num):
    """-> (final-LN tokens [T, W], last block's attention output [T, W])."""
    pe = wts["patch_embed"]
    h = num.dense(num.r(patches(img, cfg["patch_size"])), pe, False)
    h = num.r(h + wts["pos_emb"].float())[None]
    attn_out = None
    for i in range(cfg["depth"]):
        h, attn_out = vit_block(layer(wts["blocks"], i), h, cfg["num_heads"],
                                1e-6, exact_gelu, num, True)
    fl = wts["final_ln"]
    return (num.r(layer_norm(h, fl["scale"], fl["bias"], 1e-6))[0],
            attn_out[0])


# ---------------------------------------------------------------------------
# π0: prefix, flow decode (the backbone's layers in its module)
# ---------------------------------------------------------------------------


def time_embedding(t: float, dim: int, lo: float, hi: float, dev):
    frac = np.linspace(0.0, 1.0, dim // 2, dtype=np.float64)
    scaling = torch.from_numpy(
        (2 * np.pi / (lo * (hi / lo) ** frac)).astype(np.float32)).to(dev)
    x = scaling * torch.tensor(t, dtype=torch.float32, device=dev)
    return torch.cat([torch.sin(x), torch.cos(x)])


def euler_to_rotvec(rpy):
    """[..., 3] sxyz Euler -> axis * angle, through qz * qy * qx."""
    r, p, y = rpy[..., 0] / 2, rpy[..., 1] / 2, rpy[..., 2] / 2
    w = torch.cos(y) * torch.cos(p) * torch.cos(r) \
        + torch.sin(y) * torch.sin(p) * torch.sin(r)
    x = torch.cos(y) * torch.cos(p) * torch.sin(r) \
        - torch.sin(y) * torch.sin(p) * torch.cos(r)
    yy = torch.cos(y) * torch.sin(p) * torch.cos(r) \
        + torch.sin(y) * torch.cos(p) * torch.sin(r)
    z = torch.sin(y) * torch.cos(p) * torch.cos(r) \
        - torch.cos(y) * torch.sin(p) * torch.sin(r)
    v = torch.stack([x, yy, z], dim=-1)
    nv = v.norm(dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(nv, w[..., None])
    angle = torch.where(angle > math.pi, angle - 2 * math.pi, angle)
    return torch.where(nv > 1e-12, v * angle / nv.clamp_min(1e-12),
                       torch.zeros_like(v))


def _lin(p, x):
    """A float32 linear layer: x @ kernel + bias."""
    return x @ p["kernel"].float() + p["bias"].float()


def propose(pw, cfg, stats, raw, proprio, prompts, noise, num, dev, bb):
    """The K x N candidates of one episode.

    pw: policy weights; cfg: the configuration's `policy` group; stats:
    {"action"|"proprio": {"p01", "p99"}}; prompts: K texts; noise fp32
    [K, N, chunk, max_action_dim]; bb: the configuration's backbone module
    (its embedding, prefill and expert layers). -> normalised actions
    [K * N, chunk, 7]."""
    vc = cfg["vision"]
    k_prompts, n = noise.shape[:2]
    chunk = cfg["chunk_size"]
    f32 = torch.float32

    # prefix: image tokens, then each prompt's valid tokens
    img = policy_image(raw, vc["image_size"], dev)
    tokens, _ = vit(pw["vision"], vc, img, False, num)
    toks = [tokenize(p, cfg["tokenizer_max_length"],
                     bb.prompt_vocab(cfg), True)
            for p in prompts]
    n_lang = [int(m.sum()) for _, m in toks]
    img_emb, txt_emb = bb.embed(
        pw, cfg, _lin(pw["mm_proj"], tokens),
        [torch.from_numpy(t[:n_lang[i]]).to(dev)
         for i, (t, _) in enumerate(toks)], num)
    n_img, width = img_emb.shape
    p_max = n_img + max(n_lang)
    emb = torch.zeros((k_prompts, p_max, width), dtype=f32, device=dev)
    valid = torch.zeros((k_prompts, p_max), dtype=torch.bool, device=dev)
    for i in range(k_prompts):
        emb[i, :n_img] = img_emb
        emb[i, n_img:n_img + n_lang[i]] = txt_emb[i]
        valid[i, :n_img + n_lang[i]] = True
    pos = torch.arange(p_max, device=dev).expand(k_prompts, p_max)
    mask = valid[:, :, None] & valid[:, None, :]
    cache = bb.prefill(pw, cfg, emb, pos, mask, num)

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
        h = bb.expert(pw, cfg, h, s_pos, cache, key_mask, k_prompts, n, num)
        return _lin(pw["action_out_proj"], h[:, -chunk:])

    steps = cfg["num_denoise_steps"]
    dt = -1.0 / steps
    x_t = noise.reshape(k_prompts * n, chunk, -1).float()
    for i in range(steps):
        t = float(np.float32(1.0) + np.float32(dt) * np.float32(i))
        x_t = x_t + dt * velocity(x_t, t)
    return x_t[..., :7], ap01, ap99


def decode(actions, ap01, ap99):
    """normalised [..., 7] -> (exec [xyz | axis-angle | +-1], verifier
    [xyz | euler | 0/1])."""
    body = (actions[..., :6] + 1) / 2 * (ap99[:6] - ap01[:6]) + ap01[:6]
    g = actions[..., 6:]
    exec_ = torch.cat([body[..., :3], euler_to_rotvec(body[..., 3:6]),
                       torch.where(g > 0.5, 1.0, -1.0)], dim=-1)
    verif = torch.cat([body, (g >= 0.5).float()], dim=-1)
    return exec_, verif


# ---------------------------------------------------------------------------
# The verifier: SigLIP2 towers (stored precision) and the ensemble heads
# (float32)
# ---------------------------------------------------------------------------


def _l2(x):
    return x / x.norm(dim=-1, keepdim=True)


def _sincos(n: int, dim: int) -> np.ndarray:
    inv = 1.0 / (10_000 ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    ang = np.einsum("i,j->ij", np.arange(n, dtype=np.float32), inv)
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


def _pool(p, kv, heads):
    """Learned-readout cross-attention pooling of one member over kv
    [T, dim] -> [R * inter]: q_ln, attention, residual on the NORMED query,
    LN, GELU MLP, residual; final LN."""
    q = p["query"].float()                                    # [R, inter]
    r, inter = q.shape
    for i in range(p["blocks"]["q_ln"]["scale"].shape[0]):
        lw = layer(p["blocks"], i)
        qn = layer_norm(q, lw["q_ln"]["scale"], lw["q_ln"]["bias"], 1e-5)
        a = lw["attn"]
        att = attention(_lin(a["q"], qn).reshape(1, r, heads, -1),
                        _lin(a["k"], kv).reshape(1, -1, heads, inter // heads),
                        _lin(a["v"], kv).reshape(1, -1, heads, inter // heads))
        qn = qn + _lin(a["o"], att[0])
        qn = layer_norm(qn, lw["ln"]["scale"], lw["ln"]["bias"], 1e-5)
        q = qn + _lin(lw["mlp"]["fc2"],
                      F.gelu(_lin(lw["mlp"]["fc1"], qn), approximate="none"))
    q = layer_norm(q, p["final_ln"]["scale"], p["final_ln"]["bias"], 1e-5)
    return q.reshape(-1)


def _traj(p, x, valid, heads):
    """Post-LN encoder over [C, H, dim] with key mask valid [C, H]."""
    c, h, dim = x.shape
    mask = valid[:, None, :].expand(c, h, h)
    for i in range(p["ln1"]["scale"].shape[0]):
        lw = layer(p, i)
        a = lw["attn"]
        att = attention(*(_lin(a[n], x).reshape(c, h, heads, dim // heads)
                          for n in ("q", "k", "v")), mask)
        x = layer_norm(x + _lin(a["o"], att), lw["ln1"]["scale"],
                       lw["ln1"]["bias"], 1e-5)
        y = _lin(lw["fc2"], F.relu(_lin(lw["fc1"], x)))
        x = layer_norm(x + y, lw["ln2"]["scale"], lw["ln2"]["bias"], 1e-5)
    return x


def member(members, m: int) -> dict:
    return {k: (member(v, m) if isinstance(v, dict) else v[m])
            for k, v in members.items()}


def scores(vw, cfg, raw, task, trajectories, num, dev):
    """Cosine similarities of the candidates' trajectories [C, H, 7]
    against the scene and instruction, under the ensemble fused as mean
    then renorm. cfg: the configuration's `verifier` group."""
    vc, tc = cfg["vision"], cfg["text"]
    img = verifier_image(raw, vc["image_size"], dev)
    _, patch = vit(vw["backbone"]["vision"], vc, img, True, num)
    patch = _l2(patch)
    tw = vw["backbone"]["text"]
    ids, _ = tokenize(task, tc["context_length"], tc["vocab_size"], False)
    h = num.r(tw["token_embed"][torch.from_numpy(ids).to(dev)].float()
              + tw["pos_emb"].float())[None]
    for i in range(tc["depth"]):
        h, _ = vit_block(layer(tw["blocks"], i), h, tc["num_heads"], 1e-6,
                         True, num, False)
    h = num.r(layer_norm(h[0], tw["ln_final"]["scale"],
                         tw["ln_final"]["bias"], 1e-6))
    text = _l2(_lin(tw["text_projection"], h))

    pos = torch.from_numpy(_sincos(*patch.shape)).to(dev)
    valid = trajectories[..., 0] != PAD_VALUE
    it, ac = [], []
    n_members = vw["members"]["tave_temperature"].shape[0]
    heads = cfg["pooling_heads"]
    for m in range(n_members):
        p = member(vw["members"], m)
        temp = p["tave_temperature"].float().clamp(0.0, 100.0)
        attn = torch.softmax(text @ patch.T / temp, dim=-1)
        tave = attn @ (patch + pos)
        fused = torch.cat([_pool(p["text_pooling"], text, heads),
                           _pool(p["vision_pooling"], tave, heads)])
        it.append(_l2(_lin(p["input_projection"], fused)))
        x = _traj(p["traj"], _lin(p["action_in"], trajectories), valid,
                  cfg["traj_heads"])
        vmask = valid[..., None].float()
        ac.append(_l2((x * vmask).sum(1) / vmask.sum(1).clamp_min(1e-9)))
    it = _l2(torch.stack(it).mean(0))
    ac = _l2(torch.stack(ac).mean(0))
    return ac @ it


def trajectories(verif, history, history_len, max_history):
    """[C, chunk, 7] candidate futures after the shared [max_history, 7]
    past -> [C, max_history + chunk, 7], top-padded where the past has no
    entry."""
    c = verif.shape[0]
    hist = torch.as_tensor(history, dtype=torch.float32,
                           device=verif.device)[None].expand(c, -1, -1)
    traj = torch.cat([hist, verif], dim=1)
    rows = torch.arange(traj.shape[1], device=verif.device)
    keep = (rows >= max_history - int(history_len))[None, :, None]
    return torch.where(keep, traj, torch.full_like(traj, PAD_VALUE))


# ---------------------------------------------------------------------------
# Selection
# ---------------------------------------------------------------------------


def select(scores_: np.ndarray, n: int, threshold: float):
    """Two-stage selection over one episode's [K * N] scores: candidate 0
    when its score reaches the threshold, else the best candidate of the
    language group whose mean score is highest. -> (winner, used_stage2,
    winning score). Group means in float64."""
    s = np.asarray(scores_, np.float64)
    groups = s.reshape(-1, n)
    g = int(groups.mean(axis=1).argmax())
    stage2 = bool(s[0] < threshold)
    winner = g * n + int(groups[g].argmax()) if stage2 else 0
    return winner, stage2, float(scores_[winner])


def vote(grippers_exec: np.ndarray, tie: float) -> float:
    """Majority of +-1 grippers (>= 0 counts as closed); a tie keeps `tie`."""
    close = int((grippers_exec >= 0).sum())
    open_ = len(grippers_exec) - close
    if close > open_:
        return 1.0
    if open_ > close:
        return -1.0
    return 1.0 if tie >= 0 else -1.0


def episode(weights, cfg, stats, raw, proprio, prompts, task, history,
            history_len, noise, quant_levels, dev):
    """The reference's candidates and scores of one episode.
    -> dict of float32 CPU tensors: actions [K * N, chunk, 7] (normalised),
    exec, verif (same shape) and scores [K * N]."""
    from coverbench import backbones
    num = Numerics(cfg["dtype"], quant_levels)
    with torch.no_grad():
        actions, ap01, ap99 = propose(weights["policy"], cfg["policy"], stats,
                                      raw, proprio, prompts, noise, num, dev,
                                      backbones.load(cfg))
        exec_, verif = decode(actions, ap01, ap99)
        traj = trajectories(verif, history, history_len,
                            cfg["cover"]["max_history"])
        s = scores(weights["verifier"], cfg["verifier"], raw, task, traj,
                   num, dev)
    return {"actions": actions.cpu(), "exec": exec_.cpu(),
            "verif": verif.cpu(), "scores": s.cpu()}
