"""Model/architecture configurations for the PyTorch/CUDA CoVer-VLA stack.

The port's own copy of the reference package's configs: the same frozen
dataclasses, fields and published hyperparameters, so a config built for
one package describes the same model in the other.

  - PaliGemma-3B language model + SigLIP so400m vision tower
  - Gemma 300M action expert
  - pi0 flow-matching policy config
  - Kimi-VL-A3B's MLA + MoE language model, as an alternative pi0 backbone
  - SigLIP2 ViT-L/16-384 verifier backbone + trainable heads

Attention backends are "eager" (plain PyTorch, fp32 scores) or "cuda"
(the hand-written kernels in ``ops/cuda_attention.py``). ``fast_math`` is
kept as a field so configs round-trip, but the eager score products always
run in full fp32.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


# ---------------------------------------------------------------------------
# Transformer backbones
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class GemmaConfig:
    """Gemma-family decoder config (RMSNorm + GQA + GeGLU)."""

    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    vocab_size: int = 0  # 0 => no token embedding table (e.g. action expert)
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-6

    @property
    def qkv_dim(self) -> int:
        return self.num_heads * self.head_dim


@dataclass(frozen=True)
class MlaMoeConfig:
    """DeepSeek-V3-shaped decoder (RMSNorm w * x / rms(x) + multi-head
    latent attention + SwiGLU feed-forwards, sigmoid-routed experts after
    the leading dense layers), as Kimi-VL-A3B's language model and an
    action expert that mirrors its attention geometry. The names of the
    published config.json in brackets.

    Attention (MLA, arXiv 2405.04434): q = x W_q per head [qk_nope_dim |
    qk_rope_dim]; [c_kv | k_pe] = x W_kv_a, c_kv RMS-normed, k_pe one rope
    key shared by every head; per head [k_nope | v] = c_kv W_kv_b. Routing
    (`noaux_tc`, arXiv 2412.19437): sigmoid scores of an fp32 router, the
    top `experts_per_token` chosen on score + correction bias, weighted by
    their scores normalised to sum 1 and times `routed_scaling`, plus the
    shared experts as one SwiGLU of num_shared_experts * moe_dim."""

    width: int                      # hidden_size
    depth: int                      # num_hidden_layers
    num_heads: int                  # num_attention_heads
    mlp_dim: int                    # intermediate_size (dense layers)
    kv_lora_rank: int = 512         # kv_lora_rank (no q_lora_rank)
    qk_nope_dim: int = 128          # qk_nope_head_dim
    qk_rope_dim: int = 64           # qk_rope_head_dim
    v_head_dim: int = 128           # v_head_dim
    num_experts: int = 0            # n_routed_experts; 0 = every layer dense
    experts_per_token: int = 6      # num_experts_per_tok
    moe_dim: int = 1408             # moe_intermediate_size
    num_shared_experts: int = 2     # n_shared_experts
    first_dense: int = 1            # first_k_dense_replace
    routed_scaling: float = 2.446   # routed_scaling_factor
    vocab_size: int = 0             # 0 => no token embedding table
    rope_theta: float = 800_000.0
    rms_eps: float = 1e-5

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_dim + self.qk_rope_dim

    @property
    def num_dense(self) -> int:
        """Layers with a dense SwiGLU (the leading ones)."""
        return min(self.first_dense, self.depth) if self.num_experts \
            else self.depth

    @property
    def num_moe(self) -> int:
        return self.depth - self.num_dense



@dataclass(frozen=True)
class VitConfig:
    """SigLIP-style ViT encoder config (pre-LN, learned pos-emb, no CLS)."""

    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    patch_size: int
    image_size: int
    ln_eps: float = 1e-6
    # tanh-approx GELU (HF gelu_pytorch_tanh) vs exact erf GELU
    # (timm/open_clip nn.GELU — the SigLIP2 verifier towers)
    gelu_approx: bool = True
    # tower MHA backend: "eager" | "cuda" (dense flash kernel)
    attn_impl: str = "eager"
    fast_math: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def head_dim(self) -> int:
        return self.width // self.num_heads


@dataclass(frozen=True)
class SiglipTextConfig:
    """SigLIP2 text tower (bidirectional transformer, last-token pool)."""

    width: int
    depth: int
    mlp_dim: int
    num_heads: int
    vocab_size: int
    context_length: int
    embed_dim: int  # output dim of text_projection
    ln_eps: float = 1e-6
    gelu_approx: bool = False  # open_clip TextTransformer uses exact GELU
    attn_impl: str = "eager"   # see VitConfig.attn_impl
    fast_math: bool = False


# Reference hyperparameters --------------------------------------------------

# PaliGemma-3B language model
PALIGEMMA_LM = GemmaConfig(
    width=2048, depth=18, mlp_dim=16384, num_heads=8, num_kv_heads=1,
    head_dim=256, vocab_size=257_152,
)

# Gemma 300M action expert
GEMMA_EXPERT = GemmaConfig(
    width=1024, depth=18, mlp_dim=4096, num_heads=8, num_kv_heads=1,
    head_dim=256, vocab_size=0,
)

# SigLIP so400m/14 vision tower at 224
SIGLIP_SO400M = VitConfig(
    width=1152, depth=27, mlp_dim=4304, num_heads=16, patch_size=14,
    image_size=224,
)

# SigLIP2 ViT-L/16 vision tower at 384 (open_clip ViT-L-16-SigLIP2-384)
SIGLIP2_L16_384_VISION = VitConfig(
    width=1024, depth=24, mlp_dim=4096, num_heads=16, patch_size=16,
    image_size=384, gelu_approx=False,  # timm ViT: exact nn.GELU
)

# SigLIP2 ViT-L text tower (width 1024 / 24 layers, gemma vocab 256000,
# context 64, Linear text_projection to embed_dim 1024)
SIGLIP2_L16_384_TEXT = SiglipTextConfig(
    width=1024, depth=24, mlp_dim=4096, num_heads=16, vocab_size=256_000,
    context_length=64, embed_dim=1024,
)


# ---------------------------------------------------------------------------
# pi0 policy
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Pi0Config:
    """pi0 flow-matching policy.

    CoVer uses chunk_size=4 / n_action_steps=4 and tokenizer_max_length=72;
    upstream pi0 defaults are 50/50/48. The VLM's language model
    (`paligemma`) and the action expert are both Gemma stacks, or both
    MLA + MoE stacks (`MlaMoeConfig`, `models/mla_moe.py`) of one
    attention geometry.
    """

    paligemma: GemmaConfig | MlaMoeConfig = PALIGEMMA_LM
    expert: GemmaConfig | MlaMoeConfig = GEMMA_EXPERT
    vision: VitConfig = SIGLIP_SO400M

    chunk_size: int = 4
    n_action_steps: int = 4
    max_state_dim: int = 32
    max_action_dim: int = 32
    proj_width: int = 1024
    num_denoise_steps: int = 10
    tokenizer_max_length: int = 72
    num_images: int = 1
    # sinusoidal time embedding periods
    time_min_period: float = 4e-3
    time_max_period: float = 4.0
    # prefill/decode attention backend: "eager" or "cuda" (the prefill
    # then runs kernel K3, the decode kernel K1)
    attention_impl: str = "eager"
    # decode (shared-prefix expert) backend; "" = inherit attention_impl
    decode_attn_impl: str = ""
    fast_math: bool = False
    # dtype of the reference's hard embedding casts (img/state/time
    # embeddings are rounded through bf16 before mixing with the fp32
    # projection outputs). "float32" disables the rounding — used for the
    # fp32 parity tests.
    compute_dtype: str = "bfloat16"

    @property
    def prefix_len(self) -> int:
        return self.num_images * self.vision.num_patches + self.tokenizer_max_length

    @property
    def suffix_len(self) -> int:
        return 1 + self.chunk_size  # state token + action tokens


def tiny_kimi_pi0_config(chunk_size: int = 4,
                         tokenizer_max_length: int = 8) -> Pi0Config:
    """A miniature pi0 over an MLA + MoE backbone for unit tests: 3 layers
    (one dense, two of 8 experts, top 3, 1 shared) and an MLA expert of
    the backbone's attention geometry."""
    mla = dict(num_heads=4, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
               v_head_dim=16, rope_theta=10_000.0)
    base = tiny_pi0_config(chunk_size, tokenizer_max_length)
    return replace(
        base,
        paligemma=MlaMoeConfig(width=64, depth=3, mlp_dim=128, num_experts=8,
                               experts_per_token=3, moe_dim=32,
                               num_shared_experts=1, first_dense=1,
                               routed_scaling=2.446, vocab_size=1024, **mla),
        expert=MlaMoeConfig(width=32, depth=3, mlp_dim=64, **mla))


def tiny_pi0_config(chunk_size: int = 4, tokenizer_max_length: int = 8) -> Pi0Config:
    """A miniature pi0 for unit tests."""
    return Pi0Config(
        paligemma=GemmaConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                              num_kv_heads=1, head_dim=16, vocab_size=1024),
        expert=GemmaConfig(width=32, depth=2, mlp_dim=64, num_heads=4,
                           num_kv_heads=1, head_dim=16, vocab_size=0),
        vision=VitConfig(width=32, depth=2, mlp_dim=64, num_heads=4,
                         patch_size=14, image_size=56),
        chunk_size=chunk_size,
        n_action_steps=chunk_size,
        max_state_dim=32,
        max_action_dim=32,
        proj_width=32,
        num_denoise_steps=3,
        tokenizer_max_length=tokenizer_max_length,
    )


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class VerifierConfig:
    """SigLIP2 contrastive trajectory verifier."""

    vision: VitConfig = SIGLIP2_L16_384_VISION
    text: SiglipTextConfig = SIGLIP2_L16_384_TEXT

    text_pooling_output_dim: int = 512
    vision_pooling_output_dim: int = 512
    pooling_heads: int = 8
    pooling_layers: int = 4
    num_readouts: int = 1
    action_dim: int = 7
    history_length: int = 10  # trajectory length fed to the verifier
    traj_layers: int = 4       # TransformerEncoder num_layers
    traj_heads: int = 8
    use_transformer: bool = True
    action_padding_value: float = -5.0
    logit_scale_init: float = 2.6592
    tave_temperature_init: float = 0.07

    @property
    def fused_dim(self) -> int:
        return self.text_pooling_output_dim + self.vision_pooling_output_dim


def tiny_verifier_config() -> VerifierConfig:
    return VerifierConfig(
        vision=VitConfig(width=32, depth=2, mlp_dim=64, num_heads=4,
                         patch_size=16, image_size=64, gelu_approx=False),
        text=SiglipTextConfig(width=32, depth=2, mlp_dim=64, num_heads=4,
                              vocab_size=512, context_length=16, embed_dim=32),
        text_pooling_output_dim=16,
        vision_pooling_output_dim=16,
        pooling_heads=4,
        pooling_layers=2,
        traj_layers=2,
        traj_heads=4,
    )


# ---------------------------------------------------------------------------
# CoVer loop
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class CoVerConfig:
    """Best-of-N verified control loop."""

    n_samples: int = 5            # policy samples per prompt
    n_rephrases: int = 8          # rephrased prompts (incl. the original)
    noise_std: float = 1.0
    rescore_threshold: float = 0.1  # stage-2 gate
    max_history: int = 6          # past verifier actions kept
    gripper_vote: bool = True
    # candidate selection mode: "verifier" (two-stage verified selection)
    # | "random" (uniform over the K*N candidates) | "first" (candidate 0,
    # the plain-pi0 baseline). "random"/"first" skip the verifier.
    selection: str = "verifier"
    # Phase-aware deference: when the scene's fused image+text embedding
    # has cosine affinity below this threshold to the checkpoint's
    # calibration prototype (verifier_params["calibration"]["prototype"]),
    # approach-phase picks (gripper still open) defer to candidate 0.
    # -inf disables.
    defer_threshold: float = float("-inf")

    @property
    def batch_size(self) -> int:
        return self.n_samples * self.n_rephrases


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def fast_pi0_config(cfg: Pi0Config) -> Pi0Config:
    """Max-throughput variant: the dense flash kernel for the vision tower
    and the shared-prefix decode kernel. Prefill stays eager;
    `replace(fast_pi0_config(cfg), attention_impl="cuda")` is the
    all-kernel configuration, whose prefill runs kernel K3."""
    return replace(cfg, decode_attn_impl="cuda", fast_math=True,
                   vision=replace(cfg.vision, attn_impl="cuda",
                                  fast_math=True))


def fast_verifier_config(cfg: VerifierConfig) -> VerifierConfig:
    """Max-throughput verifier: the dense flash kernel for both towers."""
    return replace(cfg,
                   vision=replace(cfg.vision, attn_impl="cuda",
                                  fast_math=True),
                   text=replace(cfg.text, attn_impl="cuda",
                                fast_math=True))
