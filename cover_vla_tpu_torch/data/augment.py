"""Training image augmentation on the device: random resized crop and
colour jitter (the reference's tf.image frame transforms:
random_resized_crop scale [0.8, 1.0] / ratio [0.9, 1.1], brightness,
contrast, saturation and hue jitter).

Each transform is a draw from a `torch.Generator` (one set of numbers per
frame) and a deterministic apply over a batch of frames [B, H, W, 3], so
tests can hand the apply another package's draws. The apply keeps the
gather-based crop and bilinear resize at a fixed output size, the int32
truncation of the crop size, and the hue rotation in YIQ space.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


class CropDraw(NamedTuple):
    area_scale: torch.Tensor   # fp32 [B], share of the frame's area kept
    log_ratio: torch.Tensor    # fp32 [B], log of the crop's aspect ratio
    y0: torch.Tensor           # int32 [B], crop origin
    x0: torch.Tensor           # int32 [B]


class JitterDraw(NamedTuple):
    brightness: torch.Tensor   # fp32 [B], added
    contrast: torch.Tensor     # fp32 [B], factor about the frame mean
    saturation: torch.Tensor   # fp32 [B], factor about the gray value
    hue: torch.Tensor          # fp32 [B], rotation in turns


def _uniform(gen, n: int, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand((n,), generator=gen, device=device)


def crop_size(h: int, w: int, area_scale: torch.Tensor,
              log_ratio: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(crop_h, crop_w) int32: sqrt(area / r) and sqrt(area * r) clipped
    to [8, side] and truncated."""
    area = h * w * area_scale
    r = torch.exp(log_ratio)
    crop_w = torch.sqrt(area * r).clamp(8, w).to(torch.int32)
    crop_h = torch.sqrt(area / r).clamp(8, h).to(torch.int32)
    return crop_h, crop_w


def draw_crop(gen: Optional[torch.Generator], n: int, h: int, w: int,
              scale=(0.8, 1.0), ratio=(0.9, 1.1), device="cpu") -> CropDraw:
    area_scale = _uniform(gen, n, scale[0], scale[1], device)
    log_ratio = _uniform(gen, n, math.log(ratio[0]), math.log(ratio[1]),
                         device)
    crop_h, crop_w = crop_size(h, w, area_scale, log_ratio)
    u = torch.rand((2, n), generator=gen, device=device)
    y0 = (u[0] * (h - crop_h + 1)).floor().to(torch.int32)
    x0 = (u[1] * (w - crop_w + 1)).floor().to(torch.int32)
    return CropDraw(area_scale, log_ratio, y0, x0)


def apply_crop(img: torch.Tensor, draw: CropDraw,
               out_hw: Tuple[int, int]) -> torch.Tensor:
    """img: float [B, H, W, 3] -> [B, oh, ow, 3]: each frame's crop,
    bilinearly resized by gathers (no antialias)."""
    b, h, w, _ = img.shape
    oh, ow = out_hw
    crop_h, crop_w = crop_size(h, w, draw.area_scale, draw.log_ratio)
    dev = img.device

    def coords(origin, size, n, side):
        grid = torch.arange(n, device=dev, dtype=torch.float32)
        c = origin[:, None] + (grid[None] + 0.5) * size[:, None] / n - 0.5
        c = c.clamp(0, side - 1)
        lo = c.floor().to(torch.int64)
        return lo, torch.clamp(lo + 1, max=side - 1), c - lo

    y_lo, y_hi, wy = coords(draw.y0, crop_h, oh, h)
    x_lo, x_hi, wx = coords(draw.x0, crop_w, ow, w)
    rows = torch.arange(b, device=dev)[:, None, None]

    def gather(ys, xs):
        return img[rows, ys[:, :, None], xs[:, None, :]]

    wx, wy = wx[:, None, :, None], wy[:, :, None, None]
    top = gather(y_lo, x_lo) * (1 - wx) + gather(y_lo, x_hi) * wx
    bot = gather(y_hi, x_lo) * (1 - wx) + gather(y_hi, x_hi) * wx
    return top * (1 - wy) + bot * wy


def random_resized_crop(gen: Optional[torch.Generator], img: torch.Tensor,
                        out_hw: Tuple[int, int], scale=(0.8, 1.0),
                        ratio=(0.9, 1.1)) -> torch.Tensor:
    """img: float [B, H, W, 3]. Area-scale and aspect-ratio jittered crop
    of each frame, bilinearly resized to out_hw."""
    b, h, w, _ = img.shape
    draw = draw_crop(gen, b, h, w, scale, ratio, img.device)
    return apply_crop(img, draw, out_hw)


_RGB2YIQ = ((0.299, 0.596, 0.211),
            (0.587, -0.274, -0.523),
            (0.114, -0.322, 0.312))
_YIQ2RGB = ((1.0, 1.0, 1.0),
            (0.956, -0.272, -1.106),
            (0.621, -0.647, 1.703))


def draw_jitter(gen: Optional[torch.Generator], n: int, brightness=0.1,
                contrast=0.1, saturation=0.1, hue=0.025,
                device="cpu") -> JitterDraw:
    return JitterDraw(
        _uniform(gen, n, -brightness, brightness, device),
        _uniform(gen, n, 1 - contrast, 1 + contrast, device),
        _uniform(gen, n, 1 - saturation, 1 + saturation, device),
        _uniform(gen, n, -hue, hue, device))


def apply_jitter(img: torch.Tensor, draw: JitterDraw) -> torch.Tensor:
    """img in [0, 1], [B, H, W, 3]: additive brightness, mean-anchored
    contrast, grayscale-anchored saturation, hue rotation in YIQ space,
    then clipped to [0, 1]."""
    dev = img.device

    def per_frame(x):
        return x[:, None, None, None]

    img = img + per_frame(draw.brightness)
    mean = img.mean(dim=(-3, -2), keepdim=True)
    img = (img - mean) * per_frame(draw.contrast) + mean
    gray = (img * torch.tensor([0.299, 0.587, 0.114], device=dev)
            ).sum(-1, keepdim=True)
    img = gray + (img - gray) * per_frame(draw.saturation)
    theta = draw.hue * 2 * math.pi
    cos, sin = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(cos), torch.zeros_like(cos)
    rot = torch.stack([torch.stack([one, zero, zero], -1),
                       torch.stack([zero, cos, -sin], -1),
                       torch.stack([zero, sin, cos], -1)], -2)   # [B, 3, 3]
    yiq = img @ torch.tensor(_RGB2YIQ, device=dev)
    yiq = torch.einsum("bhwc,bdc->bhwd", yiq, rot)
    img = yiq @ torch.tensor(_YIQ2RGB, device=dev)
    return img.clamp(0.0, 1.0)


def color_jitter(gen: Optional[torch.Generator], img: torch.Tensor,
                 brightness=0.1, contrast=0.1, saturation=0.1,
                 hue=0.025) -> torch.Tensor:
    """img in [0, 1], [B, H, W, 3]: one jitter draw per frame, applied."""
    draw = draw_jitter(gen, img.shape[0], brightness, contrast, saturation,
                       hue, img.device)
    return apply_jitter(img, draw)


def augment_frames(img_uint8: torch.Tensor, out_hw: Tuple[int, int],
                   crop: CropDraw, jitter: JitterDraw) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float [-1, 1] [B, oh, ow, 3] under the given
    draws."""
    x = img_uint8.float() / 255.0
    x = apply_jitter(apply_crop(x, crop, out_hw), jitter)
    return x * 2.0 - 1.0


def augment_frame(gen: Optional[torch.Generator], img_uint8: torch.Tensor,
                  out_hw: Tuple[int, int]) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> augmented float [-1, 1] at out_hw (the
    training path): the crop draws, then the jitter draws, then both
    applied."""
    b, h, w, _ = img_uint8.shape
    dev = img_uint8.device
    crop = draw_crop(gen, b, h, w, device=dev)
    return augment_frames(img_uint8, out_hw, crop,
                          draw_jitter(gen, b, device=dev))
