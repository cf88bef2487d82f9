"""pi0-FAST: autoregressive action-token VLA policy.

The policy tokenizes the observation as
    [image tokens | "Task: {task}, State: {256-bin discretised state};\\n"]
(bidirectional prefix), then greedily decodes FAST action tokens with the
PaliGemma LM head, mapped into the tail of the PaliGemma vocabulary as
    pg_token = vocab_size - 1 - fast_skip_tokens - fast_token.
Decoded tokens are inverted through the DCT+BPE FAST tokenizer
(`data/fast_tokenizer.py`).

The greedy decode runs over a preallocated KV cache (`gemma.ar_generate`);
the prefix stays right-padded (invalid slots are masked, nothing is
shifted). The prefill and decode attention are eager, as in the reference
package, whose decode attention is XLA, not a Pallas kernel. Training is
teacher-forced CE over the action tokens (`token_ce_loss`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from cover_vla_tpu_torch.configs import (
    GemmaConfig, PALIGEMMA_LM, SIGLIP_SO400M, VitConfig)
from cover_vla_tpu_torch.data.fast_tokenizer import FastActionTokenizer
from cover_vla_tpu_torch.data.tokenizer import (
    Tokenizer, make_policy_tokenizer)
from cover_vla_tpu_torch.device import resolve_device
from cover_vla_tpu_torch.eval.adapters import lanczos4_resize_uint8
from cover_vla_tpu_torch.models import gemma, siglip
from cover_vla_tpu_torch.models.params import Init, ParamTree
from cover_vla_tpu_torch.models.pi0 import _linear
from cover_vla_tpu_torch.ops.masks import make_att_2d_masks


@dataclass(frozen=True)
class Pi0FastConfig:
    """The published pi0-FAST defaults."""
    paligemma: GemmaConfig = PALIGEMMA_LM
    vision: VitConfig = SIGLIP_SO400M
    chunk_size: int = 10            # action horizon
    n_action_steps: int = 5
    max_action_dim: int = 32
    max_decoding_steps: int = 256
    fast_skip_tokens: int = 128
    max_input_seq_len: int = 256
    num_images: int = 1
    eos_token_id: int = 1
    pad_token_id: int = 0


def tiny_pi0fast_config() -> Pi0FastConfig:
    return Pi0FastConfig(
        paligemma=GemmaConfig(width=64, depth=2, mlp_dim=128, num_heads=4,
                              num_kv_heads=1, head_dim=16, vocab_size=1024),
        vision=VitConfig(width=32, depth=2, mlp_dim=64, num_heads=4,
                         patch_size=14, image_size=56),
        chunk_size=4, n_action_steps=4, max_decoding_steps=8,
        fast_skip_tokens=16, max_input_seq_len=48)


def init_pi0fast(seed: int, cfg: Pi0FastConfig, *, device=None) -> ParamTree:
    """Randomly initialised policy (the reference's shapes, dtypes and
    scales) on `device` (CUDA unless given)."""
    init = Init(seed, resolve_device(device))
    return ParamTree({
        "vision": siglip.init_vit(init, cfg.vision),
        "mm_proj": init.linear(cfg.vision.width, cfg.paligemma.width),
        "paligemma": gemma.init_gemma(init, cfg.paligemma),
    })


# --------------------------------------------------------------------------
# token mapping + prompt construction (host)
# --------------------------------------------------------------------------


def act_tokens_to_paligemma(tokens: np.ndarray, cfg: Pi0FastConfig) -> np.ndarray:
    return cfg.paligemma.vocab_size - 1 - cfg.fast_skip_tokens - tokens


def paligemma_to_act_tokens(tokens: np.ndarray, cfg: Pi0FastConfig) -> np.ndarray:
    return cfg.paligemma.vocab_size - 1 - cfg.fast_skip_tokens - tokens


def discretize_state(state: np.ndarray, n_bins: int = 256) -> np.ndarray:
    """256-bin bucketize over [-1, 1) (torch.bucketize(right=False) - 1)."""
    bins = np.linspace(-1, 1, n_bins + 1)[:-1]
    return (np.digitize(state, bins) - 1)[..., :32]


def build_prompts(state: np.ndarray, tasks: Sequence[str]) -> List[str]:
    disc = discretize_state(np.asarray(state))
    out = []
    for task, d in zip(tasks, disc):
        cleaned = task.lower().strip().replace("_", " ")
        state_str = " ".join(str(int(v)) for v in d)
        out.append(f"Task: {cleaned}, State: {state_str};\n")
    return out


# --------------------------------------------------------------------------
# model forward (device)
# --------------------------------------------------------------------------


def embed_prefix(params: ParamTree, cfg: Pi0FastConfig, images: torch.Tensor,
                 img_masks: torch.Tensor, tokens: torch.Tensor,
                 token_masks: torch.Tensor):
    """[image tokens | prompt tokens] embeddings (bf16) and pad mask.
    images: [Bi, n, H, W, 3] in [-1, 1] with Bi = 1 or B."""
    b = tokens.shape[0]
    bi, n_img = images.shape[:2]
    flat = images.reshape(bi * n_img, *images.shape[2:])
    vit_out = siglip.vit_forward(params["vision"], cfg.vision, flat)
    img_emb = _linear(params["mm_proj"], vit_out.tokens.float()).to(
        torch.bfloat16)
    img_emb = img_emb.reshape(bi, n_img * cfg.vision.num_patches, -1)
    if bi == 1 and b > 1:
        img_emb = img_emb.expand(b, *img_emb.shape[1:])
        img_masks = img_masks.expand(b, n_img)

    tok_emb = gemma.embed_tokens(params["paligemma"], tokens)
    tok_emb = tok_emb * torch.tensor(cfg.paligemma.width ** 0.5,
                                     dtype=tok_emb.dtype)
    embs = torch.cat([img_emb, tok_emb.to(img_emb.dtype)], dim=1)
    img_pad = img_masks.bool().repeat_interleave(cfg.vision.num_patches,
                                                 dim=1)
    pad = torch.cat([img_pad, token_masks.bool()], dim=1)
    return embs, pad


@torch.no_grad()
def generate_action_tokens(params: ParamTree, cfg: Pi0FastConfig,
                           images: torch.Tensor, img_masks: torch.Tensor,
                           prompt_tokens: torch.Tensor,
                           prompt_masks: torch.Tensor) -> torch.Tensor:
    """Greedy decode: PaliGemma-vocab tokens int32[B, max_decoding_steps]
    (pad after EOS)."""
    embs, pad = embed_prefix(params, cfg, images, img_masks,
                             prompt_tokens, prompt_masks)
    return gemma.ar_generate(params["paligemma"], cfg.paligemma, embs, pad,
                             cfg.max_decoding_steps, cfg.eos_token_id,
                             cfg.pad_token_id)


def token_ce_loss(params: ParamTree, cfg: Pi0FastConfig, images: torch.Tensor,
                  img_masks: torch.Tensor, tokens: torch.Tensor,
                  pad_mask: torch.Tensor,
                  suffix_mask: torch.Tensor,
                  weight_total: Optional[torch.Tensor] = None
                  ) -> torch.Tensor:
    """Teacher-forced CE on the action-token suffix: the prefix attends
    bidirectionally, the suffix causally; targets are the next tokens, and
    the loss is the mean over positions in the suffix and not padding (the
    count clipped at 1). The LM head's logits are fp32 over the whole
    vocabulary. The prefill's attention is eager (the kernels have no
    backward pass). `weight_total` replaces the count the summed losses
    are divided by (a sharded step divides its rows' sum by the global
    batch's count)."""
    embs, pad = embed_prefix(params, cfg, images, img_masks, tokens, pad_mask)
    n_img_tokens = embs.shape[1] - tokens.shape[1]
    b = tokens.shape[0]
    att = torch.cat([torch.zeros((b, n_img_tokens), dtype=torch.int32,
                                 device=tokens.device),
                     suffix_mask.to(torch.int32)], dim=1)
    mask2d = make_att_2d_masks(pad, att)
    positions = torch.cumsum(pad.to(torch.int32), dim=1) - 1
    hidden, _ = gemma.prefill(params["paligemma"], cfg.paligemma, embs,
                              positions, mask2d, return_hidden=True)
    text_hidden = hidden[:, n_img_tokens:]
    logits = gemma.lm_logits(params["paligemma"], cfg.paligemma,
                             text_hidden[:, :-1])
    targets = tokens[:, 1:].long()
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None])[..., 0]
    weight = (suffix_mask[:, 1:] & pad_mask[:, 1:]).float()
    if weight_total is None:
        weight_total = weight.sum().clamp_min(1.0)
    return (nll * weight).sum() / weight_total


# --------------------------------------------------------------------------
# host-side policy
# --------------------------------------------------------------------------


class Pi0FastPolicy:
    """Host wrapper: prompt building, generation, FAST detokenisation, and
    the n_action_steps queue. The parameters must live on `device` (CUDA
    unless given). It also answers the serving verbs (`infer`, `reset`,
    `switch_model`), so the websocket server can serve it."""

    def __init__(self, params: ParamTree, cfg: Pi0FastConfig,
                 text_tokenizer: Optional[Tokenizer] = None,
                 fast_tokenizer=None,  # FastActionTokenizer or a
                 # data.fast_tokenizer.HubFastProcessor loaded from the
                 # saved hub artifact (HubFastProcessor.from_artifact)
                 action_dim: int = 7, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.cfg = cfg
        self.tok = text_tokenizer or make_policy_tokenizer(
            cfg.paligemma.vocab_size)
        self.fast = fast_tokenizer or FastActionTokenizer(
            time_horizon=cfg.chunk_size, action_dim=action_dim)
        self.action_dim = action_dim
        self.reset()

    def reset(self):
        self._queue: List[np.ndarray] = []

    def select_action(self, images: np.ndarray, state: np.ndarray,
                      tasks: Sequence[str]) -> np.ndarray:
        """images: [B, n, H, W, 3] in [-1,1]; state: [B, <=32] normalised;
        returns [B, action_dim] (popping an internal chunk queue)."""
        if not self._queue:
            prompts = build_prompts(state, tasks)
            toks, masks = self.tok.encode_batch(prompts,
                                                self.cfg.max_input_seq_len)
            dev = self.device
            images = torch.as_tensor(np.asarray(images, np.float32),
                                     device=dev)
            out_tokens = generate_action_tokens(
                self.params, self.cfg, images,
                torch.ones(images.shape[:2], dtype=torch.bool, device=dev),
                torch.as_tensor(np.asarray(toks), device=dev),
                torch.as_tensor(np.asarray(masks), device=dev))
            actions = self.decode_tokens(out_tokens.cpu().numpy())
            self._queue = [actions[:, i]
                           for i in range(self.cfg.n_action_steps)]
        return self._queue.pop(0)

    def infer(self, obs: Dict[str, Any]) -> Dict[str, Any]:
        """obs {image uint8[H, W, 3], state float[<=32] normalised to
        [-1, 1], task str} -> {actions [action_dim]}: one action of the
        current chunk per call. A new chunk's frame is LANCZOS4-resized to
        the tower's size and scaled to [-1, 1]."""
        if self._queue:
            action = self._queue.pop(0)
        else:
            size = self.cfg.vision.image_size
            image = lanczos4_resize_uint8(np.asarray(obs["image"], np.uint8),
                                          size, size)
            image = (image.astype(np.float32) / 255.0 - 0.5) / 0.5
            state = np.asarray(obs["state"], np.float32).reshape(1, -1)
            action = self.select_action(image[None, None], state,
                                        [str(obs.get("task", ""))])
        return {"actions": np.asarray(action[0])}

    def switch_model(self, path: str) -> None:
        """Swap the served checkpoint (a lerobot pi0-FAST .safetensors /
        .pt / .bin or save_pretrained directory, through
        `convert_pi0fast`, or a blob directory) onto the policy's device;
        the parameters change only after a successful load, then the
        queue resets."""
        from cover_vla_tpu_torch.convert.loaders import load_pi0fast_params
        self.params = load_pi0fast_params(path, self.cfg, device=self.device)
        self.reset()

    def decode_tokens(self, pg_tokens: np.ndarray) -> np.ndarray:
        """PaliGemma tokens -> [B, chunk, action_dim] actions."""
        batch = []
        for row in pg_tokens:
            row = row[(row != self.cfg.pad_token_id)
                      & (row != self.cfg.eos_token_id)]
            fast = paligemma_to_act_tokens(row, self.cfg)
            fast = fast[(fast >= 0) & (fast < self.fast.vocab_size)]
            batch.append(fast.tolist())
        return self.fast.decode(batch, time_horizon=self.cfg.chunk_size,
                                action_dim=self.action_dim)
