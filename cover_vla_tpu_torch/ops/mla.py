"""Multi-head latent attention (MLA, DeepSeek-V2, arXiv 2405.04434) ops:
the interleaved-pair rotary embedding and the absorbed shared-prefix
decode of the action expert over a latent prefix cache.

The prefix cache holds, per layer and token, [c_kv | k_pe]: the normed
latent (kv_lora_rank) and the rope key shared by every head. The explicit
prefix keys and values would be, per head h,

    k_h = [c_kv W_UK[:, h] | k_pe],   v_h = c_kv W_UV[:, h]

(W_UK, W_UV: the backbone layer's kv_b split per head). The decode never
forms them: q_nope . (c_kv W_UK[:, h]) = (W_UK[:, h] q_nope) . c_kv, so each
query is absorbed into the latent space once (q_lat = W_UK[:, h] q_nope)
and scores the cache's [c_kv | k_pe] as one key of kv_lora_rank +
qk_rope_dim; the probabilities weight c_kv itself, and the latent output
is taken to the head's value space after the sum (W_UV[:, h]^T). All N
candidates of a prompt share its cache rows: the products are batched by
prompt, never copied per candidate.

Numerics: the score products take bf16 operands (fp32 ones on the CPU)
and give fp32 scores; one fp32 softmax runs jointly over [prefix | own
suffix]; the probabilities are rounded to the cache's dtype for their
products with c_kv and with the suffix's values, whose sums are fp32.
"""

from __future__ import annotations

import torch

from cover_vla_tpu_torch.ops.attention import BIG_NEG


def rope_pairs(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """DeepSeek's rotary embedding: the pair (x[2i], x[2i+1]) rotated by
    position / theta**(2i/d), in fp32, returned de-interleaved as
    [x'[0::2] | x'[1::2]] (HF's order; dot products of two roped vectors
    do not depend on it). x: [..., T, H, d]; positions: [..., T]."""
    d = x.shape[-1]
    x32 = x.float()
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = (positions[..., None].float() * inv)[..., None, :]   # [..., T, 1, d/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    a, b = x32[..., 0::2], x32[..., 1::2]
    return torch.cat([a * cos - b * sin, b * cos + a * sin],
                     dim=-1).to(x.dtype)


def bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, with an fp32 result: bf16 operands through the
    tensor cores with fp32 output on CUDA, fp32 operands elsewhere."""
    if a.is_cuda and a.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def absorbed_decode(q_nope: torch.Tensor, q_pe: torch.Tensor,
                    k_nope: torch.Tensor, k_pe: torch.Tensor,
                    v: torch.Tensor, kv_pre: torch.Tensor,
                    w_uk: torch.Tensor, w_uv: torch.Tensor,
                    prefix_pad: torch.Tensor,
                    suffix_mask: torch.Tensor) -> torch.Tensor:
    """Candidate suffix queries over [shared latent prefix | own suffix].

    q_nope: [B, N, S, H, dn]; q_pe: [B, N, S, H, dr] (roped); the
    suffix's explicit keys k_nope [B, N, S, H, dn], k_pe [B, N, S, dr]
    (roped, shared by the heads) and values v [B, N, S, H, dv];
    kv_pre: [B, P, r + dr], the prefix cache's layer ([c_kv | k_pe]);
    w_uk: [r, H, dn], w_uv: [r, H, dv], the backbone layer's up
    projections; prefix_pad: bool[B, P]; suffix_mask: bool[B, S, S].
    The softmax scale is (dn + dr)**-0.5. Returns [B, N, S, H * dv] in
    v's dtype.

    The joint scores [B, N, S, H, P + S] are written once, scaled and
    masked (an additive -inf-like bias) on the way in; one softmax; the
    prefix probabilities go to the latent product in the cache's dtype,
    the suffix's to their values, both with fp32 results."""
    b, n, s, h, dn = q_nope.shape
    dr = q_pe.shape[-1]
    r, dv = w_uk.shape[0], w_uv.shape[-1]
    p_len = kv_pre.shape[1]
    scale = (dn + dr) ** -0.5
    dtype = kv_pre.dtype

    # the queries absorbed into the latent: [B, N*S*H, r + dr]
    q_lat = torch.einsum("bnshd,rhd->bnshr", q_nope.to(dtype), w_uk.to(dtype))
    q_cat = torch.cat([q_lat, q_pe.to(dtype)], dim=-1).reshape(
        b, n * s * h, r + dr)
    # each candidate's own suffix, per (B, N, H): [B*N*H, S, dn + dr]
    q_s = torch.cat([q_nope, q_pe], dim=-1).to(dtype).permute(
        0, 1, 3, 2, 4).reshape(b * n * h, s, dn + dr)
    k_s = torch.cat([k_nope, k_pe[..., None, :].expand(b, n, s, h, dr)],
                    dim=-1).to(dtype).permute(0, 1, 3, 4, 2).reshape(
                        b * n * h, dn + dr, s)

    # the masks as additive biases (host scalars: no copy to the device)
    joint = torch.empty((b, n, s, h, p_len + s), dtype=torch.float32,
                        device=kv_pre.device)
    torch.add(torch.where(prefix_pad, 0.0, BIG_NEG)[:, None, None, None, :],
              bmm_f32(q_cat, kv_pre.transpose(1, 2)).view(b, n, s, h, p_len),
              alpha=scale, out=joint[..., :p_len])
    torch.add(torch.where(suffix_mask, 0.0, BIG_NEG)[:, None, :, None, :],
              bmm_f32(q_s, k_s).view(b, n, h, s, s).transpose(2, 3),
              alpha=scale, out=joint[..., p_len:])
    p = torch.softmax(joint, dim=-1)

    p_pre = p[..., :p_len].to(dtype).reshape(b, n * s * h, p_len)
    lat = torch.bmm(p_pre, kv_pre[..., :r])                 # [B, N*S*H, r]
    out = torch.einsum("bnshr,rhd->bnshd", lat.view(b, n, s, h, r),
                       w_uv.to(dtype)).float()
    p_suf = p[..., p_len:].to(dtype).transpose(2, 3).reshape(b * n * h, s, s)
    v_s = v.to(dtype).permute(0, 1, 3, 2, 4).reshape(b * n * h, s, dv)
    out = out + bmm_f32(p_suf, v_s).view(b, n, h, s, dv).transpose(2, 3)
    return out.to(v.dtype).reshape(b, n, s, h * dv)
