"""On-device image augmentation ops on batched NHWC tensors
(counterpart of pocketflow_tpu/datasets/augment.py).

Random ops draw from an explicit ``torch.Generator`` on the images' device.
Its numbers differ from ``jax.random``'s, so parity tests compare the
deterministic paths.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import math

import torch


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) - mean) / std


def random_flip_lr(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per-sample horizontal flip with probability 1/2; images [B,H,W,C]."""
    flip = torch.rand(images.shape[0], generator=generator, device=images.device) < 0.5
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def _bilinear_sample(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear gather of images [B,H,W,C] at float row coords ys [B, h] and
    column coords xs [B, w]; returns fp32 [B, h, w, C]."""
    height, width = images.shape[1:3]
    y0 = torch.clamp(torch.floor(ys), 0, height - 2).long()
    x0 = torch.clamp(torch.floor(xs), 0, width - 2).long()
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :, None]
    f = images.to(torch.float32)
    b = torch.arange(images.shape[0], device=images.device)[:, None, None]
    r0, r1 = y0[:, :, None], (y0 + 1)[:, :, None]
    c0, c1 = x0[:, None, :], (x0 + 1)[:, None, :]
    return (f[b, r0, c0] * (1 - wy) * (1 - wx) + f[b, r0, c1] * (1 - wy) * wx
            + f[b, r1, c0] * wy * (1 - wx) + f[b, r1, c1] * wy * wx)


def _cast_like(out: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return torch.clamp(out, 0, 255).to(torch.uint8)
    return out.to(images.dtype)


def random_crop_resize(images: torch.Tensor, generator: torch.Generator,
                       out_size: Tuple[int, int],
                       area_range: Tuple[float, float] = (0.08, 1.0),
                       aspect_range: Tuple[float, float] = (3 / 4, 4 / 3)) -> torch.Tensor:
    """Inception-style random area + aspect-ratio crop, bilinear resize:
    per-sample (area, log-uniform aspect) -> a crop window clamped inside the
    image, sampled on a fixed [out_h, out_w] grid."""
    batch, height, width, _ = images.shape
    device = images.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(batch, generator=generator, device=device)

    area = uniform(*area_range)
    aspect = torch.exp(uniform(math.log(aspect_range[0]), math.log(aspect_range[1])))
    crop_h = torch.sqrt(area * height * width / aspect)
    crop_w = crop_h * aspect
    crop_h = torch.clamp(crop_h, 8.0, float(height))
    crop_w = torch.clamp(crop_w, 8.0, float(width))
    offy = uniform(0.0, 1.0) * (height - crop_h)
    offx = uniform(0.0, 1.0) * (width - crop_w)
    ry = torch.arange(out_size[0], dtype=torch.float32, device=device) / out_size[0]
    rx = torch.arange(out_size[1], dtype=torch.float32, device=device) / out_size[1]
    # sample strictly inside [off, off + crop - 1]
    ys = offy[:, None] + ry[None] * torch.clamp(crop_h - 1.0, min=1.0)[:, None]
    xs = offx[:, None] + rx[None] * torch.clamp(crop_w - 1.0, min=1.0)[:, None]
    return _cast_like(_bilinear_sample(images, ys, xs), images)


def center_crop_resize(images: torch.Tensor, out_size: Tuple[int, int],
                       crop_frac: float = 0.875) -> torch.Tensor:
    """Eval preproc: central crop (fraction) + bilinear resize."""
    batch, height, width, _ = images.shape
    device = images.device
    ry = torch.arange(out_size[0], dtype=torch.float32, device=device) / out_size[0]
    rx = torch.arange(out_size[1], dtype=torch.float32, device=device) / out_size[1]
    side = min(height, width) * crop_frac
    ys = ((height - side) / 2.0 + ry * side).expand(batch, -1)
    xs = ((width - side) / 2.0 + rx * side).expand(batch, -1)
    return _cast_like(_bilinear_sample(images, ys, xs), images)
