"""Hand-written CUDA attention kernels (``csrc/``), their plain PyTorch
twins, and launch counters.

  K1 `shared_prefix_gqa` — candidate-suffix decode attention of the action
     expert over [shared prefix KV cache | own suffix]. Replaces
     cover_vla_tpu/ops/pallas_attention.py:pallas_shared_prefix_gqa.
  K2 `mha_dense` — mask-free multi-head attention of the SigLIP towers.
     Replaces cover_vla_tpu/ops/pallas_attention.py:pallas_mha_dense.
  K3 `prefix_gqa` — masked prefix-LM GQA of the PaliGemma prefill, with
     fp32 probabilities. Replaces
     cover_vla_tpu/ops/pallas_attention.py:pallas_prefix_gqa.

Each wrapper takes the kernel for tensors on a CUDA device and the plain
twin for tensors on the CPU; there is no fallback from one to the other.
No kernel has a backward pass: a wrapper raises when grad is enabled and
an input requires grad.
The twins compute what the kernels compute with the same rounding points:
inputs rounded to bf16, fp32 scores and softmax, probabilities rounded to
bf16 before the PV product, and division by the sum of the rounded
probabilities at the end. (The kernels take their running maximum over
key tiles, K1 over each part of its key split, the twins over the whole
row, and the kernels compute 2^x on scores pre-scaled by log2 e, so p can
round one bf16 ulp apart.) K3 keeps its probabilities in fp32 (see
`prefix_gqa_plain`).
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import torch

from cover_vla_tpu_torch.ops.attention import BIG_NEG

# which body under csrc/ a kernel's C entry point dispatches to:
# "wgmma_tma_split" is decode_wgmma.cuh (warpgroup products fed by a TMA
# ring, the prefix keys split over a thread-block cluster), "wgmma" is
# flash_wgmma.cuh (warpgroup products over a cp.async ring)
kernel_designs = {"shared_prefix_gqa": "wgmma_tma_split", "mha_dense": "wgmma",
                  "prefix_gqa": "wgmma"}

# launches of each kernel since the last reset (CPU twin calls not counted)
launch_counts = {"shared_prefix_gqa": 0, "mha_dense": 0, "prefix_gqa": 0}

# while a list is set here, each launch appends (name, the tensors it was
# launched on) for `ops/kernel_work.py`'s reckoning of its FLOPs and bytes
# (scripts/torch_roofline.py --record); None costs a launch nothing
work_log = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _check_cuda_inputs(name: str, tensors: dict, dtypes: dict) -> None:
    dev = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        _check(t.device == dev, f"{name}: {arg} is on {t.device}, not {dev}")
        _check(t.dtype == dtypes[arg],
               f"{name}: {arg} must be {dtypes[arg]}, got {t.dtype}")
        _check(t.is_contiguous(), f"{name}: {arg} must be contiguous")


def _run(fn, *args) -> None:
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _refuse_autograd(name: str, *tensors: torch.Tensor) -> None:
    """The kernels have no backward pass: an output computed from an input
    that requires grad would come back silently detached. Refused on both
    routes, so a CPU run shows what the card would do."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward pass; call it under "
            "torch.no_grad() or on inputs that do not require grad")


def _route(name: str, device: torch.device) -> bool:
    """True for the kernel (CUDA tensors), False for the twin (CPU)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"{name}: unsupported device {device}")


# ---------------------------------------------------------------------------
# K1: shared-prefix decode attention
# ---------------------------------------------------------------------------

DECODE_BLOCK_ROWS = 128     # query rows of one block (two warpgroups)
DECODE_TILE_KEYS = 64       # prefix keys of one ring stage
DECODE_MAX_SPLIT = 8        # blocks of a cluster (the portable size)
DECODE_FIXED_TILES = 3      # a block's fixed work, in key tiles
DECODE_COMBINE_TILES = 0.5  # the combine's cost per part, in key tiles
H100_SMS = 132


@dataclass(frozen=True)
class DecodePlan:
    """How K1 cuts one launch: `split` parts of the prefix keys, each a
    block of a cluster and `tiles_per_part` 64-key tiles long (the last
    part also takes the suffix keys), over `row_blocks` 128-row blocks a
    (batch, kv-head) pair."""
    split: int
    tiles_per_part: int
    row_blocks: int
    blocks: int
    waves: float

    def parts(self, n_keys: int) -> list[tuple[int, int, bool]]:
        """Each part's prefix keys [lo, hi) and whether it runs the suffix
        keys (the last part does)."""
        step = self.tiles_per_part * DECODE_TILE_KEYS
        los = range(0, n_keys, step)
        return [(lo, min(lo + step, n_keys), i == len(los) - 1)
                for i, lo in enumerate(los)]


@functools.lru_cache(maxsize=256)
def decode_plan(batch_heads: int, rows: int, n_keys: int,
                sms: int = H100_SMS) -> DecodePlan:
    """K1's key split for `batch_heads` (batch, kv-head) pairs of `rows`
    query rows over `n_keys` prefix keys on a card of `sms` SMs: of the
    splits s <= 8 that leave no part empty, the one that minimises
    ceil(R s / sms) * (ceil(T / s) + 3) + (s > 1) * s / 2, R the 128-row
    blocks and T the 64-key tiles (waves of blocks times the tiles a block
    runs plus its fixed work, plus the combine of the parts; both costs in
    key tiles, as probe builds measured them on the H100), the smaller s
    on a tie."""
    row_blocks = math.ceil(rows / DECODE_BLOCK_ROWS)
    n_blocks = batch_heads * row_blocks
    tiles = math.ceil(n_keys / DECODE_TILE_KEYS)
    best = None
    for split in range(1, min(DECODE_MAX_SPLIT, tiles) + 1):
        per = math.ceil(tiles / split)
        if math.ceil(tiles / per) != split:
            continue                          # a part would be empty
        cost = (math.ceil(n_blocks * split / sms) * (per + DECODE_FIXED_TILES)
                + (split > 1) * DECODE_COMBINE_TILES * split)
        if best is None or cost < best[0]:
            best = (cost, split, per)
    _, split, per = best
    return DecodePlan(split=split, tiles_per_part=per, row_blocks=row_blocks,
                      blocks=n_blocks * split,
                      waves=n_blocks * split / sms)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def shared_prefix_gqa_plain(q, k_suf, v_suf, k_pre, v_pre, prefix_pad,
                            suffix_mask) -> torch.Tensor:
    """Plain twin of K1. q: [B, N, S, Hq, D]; k_suf/v_suf: [B, N, S, Hkv, D];
    k_pre/v_pre: [B, P, Hkv, D]; prefix_pad: bool[B, P]; suffix_mask:
    bool[B, S, S]. Returns [B, N, S, Hq*D] in v_suf.dtype."""
    b, n, s, hq, d = q.shape
    hkv = k_suf.shape[3]
    bf = torch.bfloat16
    q32 = q.to(bf).float().reshape(b, n, s, hkv, hq // hkv, d) * (d ** -0.5)
    sp = torch.einsum("bnshgd,bphd->bnhgsp", q32, k_pre.to(bf).float())
    sp = torch.where(prefix_pad[:, None, None, None, None, :], sp, BIG_NEG)
    ss = torch.einsum("bnshgd,bnthd->bnhgst", q32, k_suf.to(bf).float())
    ss = torch.where(suffix_mask[:, None, None, None], ss, BIG_NEG)
    joint = torch.cat([sp, ss], dim=-1)
    p = torch.exp(joint - joint.amax(dim=-1, keepdim=True)).to(bf).float()
    l = p.sum(dim=-1, keepdim=True)                      # [B, N, Hkv, G, S, 1]
    p_len = sp.shape[-1]
    out = torch.einsum("bnhgsp,bphd->bnhgsd", p[..., :p_len],
                       v_pre.to(bf).float())
    out = out + torch.einsum("bnhgst,bnthd->bnhgsd", p[..., p_len:],
                             v_suf.to(bf).float())
    out = out / l.clamp_min(1e-37)
    out = out.permute(0, 1, 4, 2, 3, 5)                  # [B, N, S, Hkv, G, D]
    return out.reshape(b, n, s, hq * d).to(v_suf.dtype)


def shared_prefix_gqa(q, k_suf, v_suf, k_pre, v_pre, prefix_pad,
                      suffix_mask) -> torch.Tensor:
    """K1 (shapes as in `shared_prefix_gqa_plain`). On CUDA all float
    inputs must be contiguous bf16 with a head dim that is a multiple of 8,
    at most 256, the masks contiguous bool, 1 <= S <= 32 and P >= 1; the
    key split comes from `decode_plan`."""
    _refuse_autograd("shared_prefix_gqa", q, k_suf, v_suf, k_pre, v_pre)
    if not _route("shared_prefix_gqa", q.device):
        return shared_prefix_gqa_plain(q, k_suf, v_suf, k_pre, v_pre,
                                       prefix_pad, suffix_mask)
    bf = torch.bfloat16
    _check_cuda_inputs(
        "shared_prefix_gqa",
        dict(q=q, k_suf=k_suf, v_suf=v_suf, k_pre=k_pre, v_pre=v_pre,
             prefix_pad=prefix_pad, suffix_mask=suffix_mask),
        dict(q=bf, k_suf=bf, v_suf=bf, k_pre=bf, v_pre=bf,
             prefix_pad=torch.bool, suffix_mask=torch.bool))
    b, n, s, hq, d = q.shape
    _check(k_suf.ndim == 5 and k_suf.shape[:3] == (b, n, s)
           and k_suf.shape[4] == d, f"k_suf shape {tuple(k_suf.shape)}")
    hkv = k_suf.shape[3]
    p_len = k_pre.shape[1]
    _check(hq % hkv == 0, f"{hq} query heads over {hkv} kv heads")
    _check(v_suf.shape == k_suf.shape, f"v_suf shape {tuple(v_suf.shape)}")
    _check(k_pre.shape == (b, p_len, hkv, d) and v_pre.shape == k_pre.shape,
           f"k_pre/v_pre shapes {tuple(k_pre.shape)}/{tuple(v_pre.shape)}")
    _check(prefix_pad.shape == (b, p_len), f"prefix_pad {tuple(prefix_pad.shape)}")
    _check(suffix_mask.shape == (b, s, s), f"suffix_mask {tuple(suffix_mask.shape)}")
    _check(d % 8 == 0 and d <= 256, f"head dim {d} (multiple of 8, <= 256)")
    _check(1 <= s <= 32, f"suffix length {s} (1..32)")
    _check(p_len >= 1, "no prefix keys")
    from cover_vla_tpu_torch import _build
    lib = _build.load().lib
    plan = decode_plan(b * hkv, n * s * (hq // hkv), p_len,
                       _sm_count(q.device.index or 0))
    out = torch.empty((b, n, s, hq * d), dtype=bf, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _run(lib.cvla_shared_prefix_gqa, q.data_ptr(), k_suf.data_ptr(),
         v_suf.data_ptr(), k_pre.data_ptr(), v_pre.data_ptr(),
         prefix_pad.data_ptr(), suffix_mask.data_ptr(), out.data_ptr(),
         b, n, s, hkv, hq // hkv, p_len, d, plan.split, d ** -0.5, stream)
    launch_counts["shared_prefix_gqa"] += 1
    if work_log is not None:
        work_log.append(("shared_prefix_gqa", (q, k_suf, v_suf, k_pre, v_pre,
                                               prefix_pad, suffix_mask)))
    return out


# ---------------------------------------------------------------------------
# K2: dense (mask-free) multi-head attention
# ---------------------------------------------------------------------------


def mha_dense_plain(q, k, v) -> torch.Tensor:
    """Plain twin of K2. q: [B, Sq, H, D]; k/v: [B, Skv, H, D].
    Returns [B, Sq, H*D] in v.dtype."""
    b, sq, h, d = q.shape
    bf = torch.bfloat16
    q32 = q.to(bf).float() * (d ** -0.5)
    scores = torch.einsum("bqhd,bkhd->bhqk", q32, k.to(bf).float())
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True)).to(bf).float()
    l = p.sum(dim=-1, keepdim=True)                      # [B, H, Sq, 1]
    out = torch.einsum("bhqk,bkhd->bhqd", p, v.to(bf).float())
    out = out / l.clamp_min(1e-37)
    return out.permute(0, 2, 1, 3).reshape(b, sq, h * d).to(v.dtype)


def mha_dense(q, k, v) -> torch.Tensor:
    """K2 (shapes as in `mha_dense_plain`). On CUDA the inputs must be
    contiguous floats with a head dim that is a multiple of 8, at most
    256. As in the JAX kernel and the twin, other float dtypes (an fp32
    tower) run in bf16 and the result comes back in v's dtype; the kernel
    writes bf16, so an fp32 result carries one more bf16 rounding than
    the twin's."""
    _refuse_autograd("mha_dense", q, k, v)
    if not _route("mha_dense", q.device):
        return mha_dense_plain(q, k, v)
    bf = torch.bfloat16
    out_dtype = v.dtype
    _check(all(x.is_floating_point() for x in (q, k, v)),
           "mha_dense: q, k and v must be floats")
    q, k, v = (x.to(bf) for x in (q, k, v))
    _check_cuda_inputs("mha_dense", dict(q=q, k=k, v=v),
                       dict(q=bf, k=bf, v=bf))
    b, sq, h, d = q.shape
    skv = k.shape[1]
    _check(k.shape == (b, skv, h, d) and v.shape == k.shape,
           f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} for q {tuple(q.shape)}")
    _check(d % 8 == 0 and d <= 256, f"head dim {d} (multiple of 8, <= 256)")
    _check(skv > 0, "no keys")
    from cover_vla_tpu_torch import _build
    lib = _build.load().lib
    out = torch.empty((b, sq, h * d), dtype=bf, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _run(lib.cvla_mha_dense, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         out.data_ptr(), b, sq, skv, h, d, d ** -0.5, stream)
    launch_counts["mha_dense"] += 1
    if work_log is not None:
        work_log.append(("mha_dense", (q, k, v)))
    return out.to(out_dtype)


# ---------------------------------------------------------------------------
# K3: masked prefix-LM GQA (prefill), fp32 probabilities
# ---------------------------------------------------------------------------


def prefix_gqa_plain(q, k, v, mask, out_dtype=None) -> torch.Tensor:
    """Plain twin of K3. q: [B, Sq, Hq, D]; k/v: [B, Skv, Hkv, D]
    (Hq % Hkv == 0); mask: bool[B, Sq, Skv], True = attend. Returns
    [B, Sq, Hq*D] in `out_dtype` (v.dtype when None).

    Inputs rounded to bf16, fp32 scores scaled by D**-0.5, masked scores
    set to BIG_NEG, an fp32 softmax over the whole row, fp32 probabilities
    times fp32-upcast V. A query row whose keys are all masked (a padding
    row) is a uniform softmax: the mean of V over the Skv keys, as the
    eager `gqa_attention` gives. (The kernel feeds p to the tensor cores as
    bf16(p) + bf16(p - bf16(p)), which differs from fp32 p by at most
    2^-18 of p.)"""
    b, sq, hq, d = q.shape
    hkv = k.shape[2]
    bf = torch.bfloat16
    q32 = q.to(bf).float().reshape(b, sq, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q32, k.to(bf).float())
    scores = torch.where(mask[:, None, None], scores * (d ** -0.5), BIG_NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.to(bf).float())
    return out.reshape(b, sq, hq * d).to(out_dtype or v.dtype)


def prefix_gqa(q, k, v, mask, out_dtype=None) -> torch.Tensor:
    """K3 (shapes as in `prefix_gqa_plain`). On CUDA q/k/v must be
    contiguous bf16 with a head dim that is a multiple of 8, at most 256,
    and mask contiguous bool; `out_dtype` is bfloat16 (None) or float32."""
    _refuse_autograd("prefix_gqa", q, k, v)
    if not _route("prefix_gqa", q.device):
        return prefix_gqa_plain(q, k, v, mask, out_dtype)
    bf = torch.bfloat16
    _check_cuda_inputs("prefix_gqa", dict(q=q, k=k, v=v, mask=mask),
                       dict(q=bf, k=bf, v=bf, mask=torch.bool))
    out_dtype = out_dtype or bf
    _check(out_dtype in (bf, torch.float32),
           f"out_dtype {out_dtype} (bfloat16 or float32)")
    _check(q.ndim == 4 and k.ndim == 4,
           f"q/k shapes {tuple(q.shape)}/{tuple(k.shape)}")
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _check(k.shape == (b, skv, hkv, d) and v.shape == k.shape,
           f"k/v shapes {tuple(k.shape)}/{tuple(v.shape)} for q {tuple(q.shape)}")
    _check(hkv > 0 and hq % hkv == 0, f"{hq} query heads over {hkv} kv heads")
    _check(mask.shape == (b, sq, skv), f"mask {tuple(mask.shape)}")
    _check(d % 8 == 0 and d <= 256, f"head dim {d} (multiple of 8, <= 256)")
    _check(sq > 0 and skv > 0, "no queries or no keys")
    from cover_vla_tpu_torch import _build
    lib = _build.load().lib
    out = torch.empty((b, sq, hq * d), dtype=out_dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _run(lib.cvla_prefix_gqa, q.data_ptr(), k.data_ptr(), v.data_ptr(),
         mask.data_ptr(), out.data_ptr(), b, sq, skv, hkv, hq // hkv, d,
         d ** -0.5, int(out_dtype == torch.float32), stream)
    launch_counts["prefix_gqa"] += 1
    if work_log is not None:
        work_log.append(("prefix_gqa", (q, k, v, mask)))
    return out
