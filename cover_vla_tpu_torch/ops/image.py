"""Image preprocessing ops on the device — channels-last [B, H, W, C].

  * `resize_lanczos4_uint8_device` (and its host numpy twin
    `resize_lanczos4_uint8`): cv2.resize(uint8, INTER_LANCZOS4),
    bit-exact (cv2's fixed-point tap tables, integer accumulation,
    rounding shift and saturation). It uses gather-multiply-sum, because
    the card has no integer matrix product in PyTorch.
  * `resize_lanczos4`: cv2's INTER_LANCZOS4 on float images (8 taps,
    a = 4, not widened on downscale, border taps clamped), with no
    clipping of over- or undershoot.
  * `resize_bicubic_pil`: PIL/torchvision BICUBIC (antialiased on
    downscale), rounding and clamping between the two separable passes as
    PIL does for 8-bit data.
  * `resize_bilinear_tf_antialias`: tf.image.resize(BILINEAR,
    antialias=True).
  * `resize_bilinear_torch` and `resize_with_pad`: torch's bilinear
    (align_corners=False, no antialias) and pi0's aspect-preserving
    resize with top/left padding (the training path's image resize).

The tap tables are built in numpy in float64 and applied as two separable
fp32 products. Those products must run in true fp32: callers keep TF32
off (`torch.backends.cuda.matmul.allow_tf32 = False`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from cover_vla_tpu_torch.utils.monitor import to_device


@functools.lru_cache(maxsize=64)
def _bicubic_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] PIL-style bicubic (a=-0.5) matrix: kernel support scales
    with the downscale factor; out-of-bounds taps are dropped and the
    remaining weights renormalised."""
    a = -0.5
    scale = src / dst
    support_scale = max(1.0, scale)
    support = 2.0 * support_scale

    def cubic(x):
        x = np.abs(x)
        return np.where(
            x <= 1.0, (a + 2) * x ** 3 - (a + 3) * x ** 2 + 1,
            np.where(x < 2.0, a * x ** 3 - 5 * a * x ** 2 + 8 * a * x - 4 * a,
                     0.0))

    coords = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    m = np.zeros((dst, src), dtype=np.float64)
    for i, c in enumerate(coords):
        lo = int(np.floor(c - support)) + 1
        taps = np.arange(lo, int(np.ceil(c + support)) + 1)
        w = cubic((c - taps) / support_scale)
        valid = (taps >= 0) & (taps < src)
        w = np.where(valid, w, 0.0)
        s = w.sum()
        if s > 0:
            w = w / s
        for t, wt in zip(taps[valid], w[valid]):
            m[i, t] += wt
    return m.astype(np.float32)


def _lanczos_kernel(x: np.ndarray, a: int) -> np.ndarray:
    out = np.sinc(x) * np.sinc(x / a)
    out[np.abs(x) >= a] = 0.0
    return out


@functools.lru_cache(maxsize=64)
def _lanczos4_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] float Lanczos-4 matrix of cv2 INTER_LANCZOS4: a fixed
    8-tap (a = 4) window around the source coordinate, not widened on
    downscale, taps outside the image clamped to the border."""
    a = 4
    scale = src / dst
    coords = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    m = np.zeros((dst, src), dtype=np.float64)
    for i, c in enumerate(coords):
        base = int(np.floor(c))
        taps = np.arange(base - a + 1, base + a + 1)
        w = _lanczos_kernel(c - taps, a)
        w = w / w.sum()
        taps = np.clip(taps, 0, src - 1)
        for t, wt in zip(taps, w):
            m[i, t] += wt
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _lanczos4_fixed_tables(src: int, dst: int):
    """cv2's fixed-point INTER_LANCZOS4 tap tables for 8-bit images:
    (indices int32[dst, 8], coefficients int32[dst, 8] at scale 2048).

    The source coordinate is computed in double then cast to float32;
    per-tap kernel values are evaluated in double via the sin/cos quadrant
    table, cast to float32, normalised in float32, and quantised with
    round-half-to-even at scale 2048. Border taps clamp to the edge.
    """
    scale = src / dst
    x = np.arange(dst)
    fxx = ((x + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fxx).astype(np.int64)
    fx = (fxx - sx).astype(np.float32)

    s45 = 0.70710678118654752440084436210485
    cs = np.array([[1, 0], [-s45, -s45], [0, 1], [s45, -s45],
                   [-1, 0], [s45, s45], [0, -1], [-s45, s45]])
    fx64 = fx.astype(np.float64)
    y0 = -(fx64 + 3) * np.pi * 0.25
    s0, c0 = np.sin(y0), np.cos(y0)
    coeffs = np.zeros((dst, 8), np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        for k in range(8):
            y = -(fx64 + 3 - k) * np.pi * 0.25
            coeffs[:, k] = ((cs[k, 0] * s0 + cs[k, 1] * c0)
                            / (y * y)).astype(np.float32)
    ssum = coeffs.sum(axis=1, dtype=np.float32)
    with np.errstate(invalid="ignore"):  # small-fx rows overwritten below
        coeffs = (coeffs * (np.float32(1.0) / ssum)[:, None]
                  ).astype(np.float32)
    small = fx < np.finfo(np.float32).eps
    coeffs[small] = 0.0
    coeffs[small, 3] = 1.0
    quant = np.rint((coeffs * np.float32(2048.0)
                     ).astype(np.float64)).astype(np.int32)
    idx = np.clip(sx[:, None] + np.arange(8)[None, :] - 3,
                  0, src - 1).astype(np.int32)
    return idx, quant


def resize_lanczos4_uint8(img: np.ndarray, height: int,
                          width: int) -> np.ndarray:
    """Host (numpy) cv2.resize(uint8, INTER_LANCZOS4), bit-exact: the same
    fixed-point coefficients, integer accumulation, rounding shift and
    saturation as cv2's 8-bit path. img: uint8[H, W, C]."""
    h, w = img.shape[:2]
    if (h, w) == (height, width):
        return img
    xi, xc = _lanczos4_fixed_tables(w, width)
    yi, yc = _lanczos4_fixed_tables(h, height)
    src = img.astype(np.int64)
    tmp = (src[:, xi, :] * xc[None, :, :, None]).sum(2)      # [h, W', C]
    acc = (tmp[yi, :, :] * yc[:, :, None, None]).sum(1)      # [H', W', C]
    out = (acc + (1 << 21)) >> 22
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_lanczos4_uint8_device(img: torch.Tensor, height: int,
                                 width: int) -> torch.Tensor:
    """uint8[B, H, W, C] -> uint8[B, height, width, C], bit-exact with
    cv2's 8-bit LANCZOS4 path (integer taps, `(acc + 2**21) >> 22`,
    saturation to [0, 255])."""
    h, w = img.shape[1:3]
    if (h, w) == (height, width):
        return img
    dev = img.device
    xi, xc = (to_device(t, dev) for t in _lanczos4_fixed_tables(w, width))
    yi, yc = (to_device(t, dev) for t in _lanczos4_fixed_tables(h, height))
    src = img.to(torch.int32)
    # horizontal taps: [B, h, W', 8, C] -> sum over taps (int64)
    tmp = (src[:, :, xi.long(), :] * xc[None, None, :, :, None]).sum(3)
    # vertical taps: [B, H', 8, W', C] -> sum over taps
    acc = (tmp[:, yi.long(), :, :] * yc[None, :, :, None, None]).sum(2)
    out = (acc + (1 << 21)) >> 22
    return out.clamp(0, 255).to(torch.uint8)


@functools.lru_cache(maxsize=64)
def _bilinear_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] interpolation matrix for align_corners=False bilinear."""
    scale = src / dst
    coords = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    coords = np.clip(coords, 0.0, src - 1)
    lo = np.floor(coords).astype(np.int64)
    hi = np.minimum(lo + 1, src - 1)
    frac = coords - lo
    m = np.zeros((dst, src), dtype=np.float32)
    m[np.arange(dst), lo] += (1.0 - frac).astype(np.float32)
    m[np.arange(dst), hi] += frac.astype(np.float32)
    return m


@functools.lru_cache(maxsize=64)
def _bilinear_antialias_tf_matrix(src: int, dst: int) -> np.ndarray:
    """[dst, src] matrix for tf.image.resize(BILINEAR, antialias=True):
    triangle kernel whose support scales with the downscale factor;
    out-of-range taps dropped and weights renormalised."""
    scale = src / dst
    kscale = max(1.0, scale)
    coords = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    m = np.zeros((dst, src), dtype=np.float64)
    for i, c in enumerate(coords):
        lo = int(np.floor(c - kscale)) + 1
        hi = int(np.ceil(c + kscale))
        taps = np.arange(lo, hi + 1)
        w = np.maximum(0.0, 1.0 - np.abs((taps - c) / kscale))
        valid = (taps >= 0) & (taps < src)
        w = np.where(valid, w, 0.0)
        s = w.sum()
        if s > 0:
            w = w / s
        for t, wt in zip(taps[valid], w[valid]):
            m[i, t] += wt
    return m.astype(np.float32)


def _separable_resize(img: torch.Tensor, h: int, w: int, matrix_fn,
                      clip_range=None) -> torch.Tensor:
    """Apply column then row interpolation matrices (PIL order).
    img: [B, H, W, C] float. clip_range: optional (lo, hi) applied, after
    rounding, after EACH 1-D pass (PIL's uint8 intermediates)."""
    _, src_h, src_w, _ = img.shape
    x = img.float()
    if src_w != w:
        mw = to_device(matrix_fn(src_w, w), img.device)   # [w, src_w]
        x = torch.einsum("ws,bhsc->bhwc", mw, x)
        if clip_range is not None:
            x = torch.round(x).clamp(*clip_range)
    if src_h != h:
        mh = to_device(matrix_fn(src_h, h), img.device)   # [h, src_h]
        x = torch.einsum("hs,bswc->bhwc", mh, x)
        if clip_range is not None:
            x = torch.round(x).clamp(*clip_range)
    return x.to(img.dtype)


def resize_lanczos4(img: torch.Tensor, height: int,
                    width: int) -> torch.Tensor:
    """cv2 INTER_LANCZOS4 resize of a float image (no clipping of over- or
    undershoot)."""
    return _separable_resize(img, height, width, _lanczos4_matrix)


def resize_bilinear_tf_antialias(img: torch.Tensor, height: int,
                                 width: int) -> torch.Tensor:
    """tf.image.resize(..., BILINEAR, antialias=True) equivalent."""
    return _separable_resize(img, height, width, _bilinear_antialias_tf_matrix)


def resize_bicubic_pil(img: torch.Tensor, height: int, width: int,
                       clip_range=(0.0, 255.0)) -> torch.Tensor:
    """PIL/torchvision BICUBIC resize (antialiased on downscale); pass
    clip_range=None for float semantics."""
    return _separable_resize(img, height, width, _bicubic_matrix,
                             clip_range=clip_range)


def resize_bilinear_torch(img: torch.Tensor, height: int,
                          width: int) -> torch.Tensor:
    """torch bilinear (align_corners=False, no antialias) resize."""
    return _separable_resize(img, height, width, _bilinear_matrix)


def resize_with_pad(img: torch.Tensor, height: int, width: int,
                    pad_value: float = 0.0) -> torch.Tensor:
    """pi0's resize_with_pad, channels-last: scale to fit inside (height,
    width) keeping the aspect ratio with non-antialiased bilinear, then
    pad on the TOP and LEFT with pad_value."""
    _, cur_h, cur_w, _ = img.shape
    ratio = max(cur_w / width, cur_h / height)
    resized_h = int(cur_h / ratio)
    resized_w = int(cur_w / ratio)
    out = resize_bilinear_torch(img, resized_h, resized_w)
    pad_h = max(0, height - resized_h)
    pad_w = max(0, width - resized_w)
    return torch.nn.functional.pad(out, (0, 0, pad_w, 0, pad_h, 0),
                                   value=pad_value)


def to_siglip_range(img_uint8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float [-1, 1] (SigLIP input convention)."""
    return img_uint8.float() / 127.5 - 1.0


def patchify(img: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, H, W, C] -> [B, (H/p)*(W/p), p*p*C] row-major patches."""
    b, h, w, c = img.shape
    gh, gw = h // patch, w // patch
    x = img.reshape(b, gh, patch, gw, patch, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, gh * gw, patch * patch * c)
