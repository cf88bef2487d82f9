"""SigLIP-family encoders: ViT vision tower + SigLIP2 text tower.

One ViT implementation serves both PaliGemma's so400m/14 vision tower
(pre-LN blocks, learned pos-emb, no CLS token, tanh-GELU MLP, final
post-LayerNorm) and the verifier's SigLIP2 ViT-L/16-384 trunk, whose
consumer takes the attention-sublayer output of the last block
(`last_attn_out`). The text tower is embedding + learned positional
embedding, a bidirectional pre-LN transformer, ln_final and an fp32
Linear text_projection applied per token.

Layers are [depth]-stacked; weights bf16; LayerNorm/softmax fp32. The
tower attention runs eager or through kernel K2 (`attn_impl="cuda"`). A
ViT stack quantized by ops/quant runs its block matmuls as w8a8 products
in the biases' dtype; the patch embed and the text tower stay as they are.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from cover_vla_tpu_torch.configs import SiglipTextConfig, VitConfig
from cover_vla_tpu_torch.models.params import Init, ParamTree, iter_layers
from cover_vla_tpu_torch.ops import quant
from cover_vla_tpu_torch.ops.attention import mha_attention
from cover_vla_tpu_torch.ops.image import patchify
from cover_vla_tpu_torch.ops.norms import layer_norm


def _dense_init(init: Init, fan_in: int, *shape, dtype=torch.bfloat16):
    return init.normal(shape, fan_in ** -0.5, dtype)


def _init_block_stack(init: Init, depth: int, width: int, mlp_dim: int,
                      dtype=torch.bfloat16) -> dict:
    def dense(fan_in, fan_out):
        return {"kernel": _dense_init(init, fan_in, depth, fan_in, fan_out,
                                      dtype=dtype),
                "bias": init.zeros((depth, fan_out), dtype)}

    def ln():
        return {"scale": init.ones((depth, width)),
                "bias": init.zeros((depth, width))}

    return {
        "ln1": ln(),
        "attn": {"q": dense(width, width), "k": dense(width, width),
                 "v": dense(width, width), "o": dense(width, width)},
        "ln2": ln(),
        "mlp": {"fc1": dense(width, mlp_dim), "fc2": dense(mlp_dim, width)},
    }


class VitOutput(NamedTuple):
    tokens: torch.Tensor         # [B, T, W] after final post-LN
    last_attn_out: torch.Tensor  # [B, T, W] attn sublayer output of last block


def init_vit(init: Init, cfg: VitConfig, dtype=torch.bfloat16) -> dict:
    patch_dim = cfg.patch_size * cfg.patch_size * 3
    return {
        "patch_embed": {
            "kernel": _dense_init(init, patch_dim, patch_dim, cfg.width,
                                  dtype=dtype),
            "bias": init.zeros((cfg.width,), dtype),
        },
        "pos_emb": init.normal((cfg.num_patches, cfg.width), 0.02, dtype),
        "blocks": _init_block_stack(init, cfg.depth, cfg.width, cfg.mlp_dim,
                                    dtype=dtype),
        "final_ln": {"scale": init.ones((cfg.width,)),
                     "bias": init.zeros((cfg.width,))},
    }


def _dense_dtype(sub) -> torch.dtype:
    """Compute dtype of a {kernel, bias} matmul: the bias dtype when the
    kernel is int8-quantized (ops/quant.quantize_vit_stack)."""
    d = sub["kernel"].dtype
    return sub["bias"].dtype if d == torch.int8 else d


def _vmm(x: torch.Tensor, sub, xq=None, xs=None) -> torch.Tensor:
    """x @ sub['kernel'] + sub['bias'], or the int8 product when the
    sub-dict carries `scale`. A pre-quantized (xq, xs) shares one
    activation quant across q/k/v."""
    s = sub.get("scale")
    if s is None:
        return x @ sub["kernel"] + sub["bias"]
    if xq is None:
        xq, xs = quant.quant_act(x)
    return quant.int8_matmul(xq, xs, sub["kernel"], s,
                             out_dtype=sub["bias"].dtype, bias=sub["bias"])


def _block(layer: dict, h: torch.Tensor, num_heads: int, eps: float,
           mask: torch.Tensor | None = None, gelu_approx: bool = True,
           attn_impl: str = "eager"):
    """Pre-LN transformer block. Returns (h, attn_sublayer_output).

    gelu_approx: tanh-approximate GELU (the PaliGemma SigLIP tower) vs
    exact erf GELU (the SigLIP2 verifier towers)."""
    b, t, w = h.shape
    d = w // num_heads
    x = layer_norm(h, layer["ln1"]["scale"], layer["ln1"]["bias"], eps)
    x = x.to(_dense_dtype(layer["attn"]["q"]))
    xq = xs = None
    if "scale" in layer["attn"]["q"]:   # quantize the normed input once
        xq, xs = quant.quant_act(x)
    q = _vmm(x, layer["attn"]["q"], xq, xs).reshape(b, t, num_heads, d)
    k = _vmm(x, layer["attn"]["k"], xq, xs).reshape(b, t, num_heads, d)
    v = _vmm(x, layer["attn"]["v"], xq, xs).reshape(b, t, num_heads, d)
    attn = mha_attention(q, k, v, mask=mask, backend=attn_impl)
    attn_out = _vmm(attn.to(_dense_dtype(layer["attn"]["o"])),
                    layer["attn"]["o"])
    h = h + attn_out
    y = layer_norm(h, layer["ln2"]["scale"], layer["ln2"]["bias"], eps)
    y = y.to(_dense_dtype(layer["mlp"]["fc1"]))
    y = F.gelu(_vmm(y, layer["mlp"]["fc1"]),
               approximate="tanh" if gelu_approx else "none")
    y = _vmm(y, layer["mlp"]["fc2"])
    return h + y, attn_out


def vit_forward(params: ParamTree, cfg: VitConfig,
                images: torch.Tensor) -> VitOutput:
    """images: [B, H, W, 3] in [-1, 1] float. Returns token features."""
    pe = params["patch_embed"]
    patches = patchify(images, cfg.patch_size).to(pe["kernel"].dtype)
    h = patches @ pe["kernel"] + pe["bias"]
    h = h + params["pos_emb"][None]
    last_attn = torch.zeros_like(h)
    for layer in iter_layers(params["blocks"], cfg.depth):
        h, last_attn = _block(layer, h, cfg.num_heads, cfg.ln_eps,
                              gelu_approx=cfg.gelu_approx,
                              attn_impl=cfg.attn_impl)
    tokens = layer_norm(h, params["final_ln"]["scale"],
                        params["final_ln"]["bias"], cfg.ln_eps)
    return VitOutput(tokens=tokens, last_attn_out=last_attn)


# ---------------------------------------------------------------------------
# SigLIP2 text tower
# ---------------------------------------------------------------------------


class TextOutput(NamedTuple):
    seq_features: torch.Tensor   # [B, T, embed_dim] ln_final + projection per token
    pooled: torch.Tensor         # [B, embed_dim] last-token pool


def init_text_tower(init: Init, cfg: SiglipTextConfig,
                    dtype=torch.bfloat16) -> dict:
    return {
        "token_embed": init.normal((cfg.vocab_size, cfg.width), 0.02, dtype),
        "pos_emb": init.normal((cfg.context_length, cfg.width), 0.01, dtype),
        "blocks": _init_block_stack(init, cfg.depth, cfg.width, cfg.mlp_dim,
                                    dtype=dtype),
        "ln_final": {"scale": init.ones((cfg.width,)),
                     "bias": init.zeros((cfg.width,))},
        "text_projection": {
            "kernel": _dense_init(init, cfg.width, cfg.width, cfg.embed_dim,
                                  dtype=torch.float32),
            "bias": init.zeros((cfg.embed_dim,)),
        },
    }


def text_forward(params: ParamTree, cfg: SiglipTextConfig,
                 tokens: torch.Tensor) -> TextOutput:
    """tokens: int[B, T<=context_length]. Bidirectional (no causal mask)."""
    t = tokens.shape[1]
    h = params["token_embed"][tokens.long()]
    h = h + params["pos_emb"][:t][None]
    for layer in iter_layers(params["blocks"], cfg.depth):
        h, _ = _block(layer, h, cfg.num_heads, cfg.ln_eps,
                      gelu_approx=cfg.gelu_approx, attn_impl=cfg.attn_impl)
    h = layer_norm(h, params["ln_final"]["scale"], params["ln_final"]["bias"],
                   cfg.ln_eps)
    proj = params["text_projection"]
    seq = h.float() @ proj["kernel"] + proj["bias"]
    return TextOutput(seq_features=seq, pooled=seq[:, -1])
