"""On-device image augmentation ops on batched NHWC tensors
(counterpart of pocketflow_tpu/datasets/augment.py).

Random ops draw from an explicit ``torch.Generator`` on the images' device.
Its numbers differ from ``jax.random``'s, so parity tests compare the
deterministic paths.  Under data parallelism every rank's generator is seeded
alike and each draw is made for the global batch, of which a rank takes its
rows: two ranks at batch B augment as one rank at 2B does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import math

import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.core import mesh


def _draw(sample, batch: int) -> torch.Tensor:
    """sample(n) -> [..., n] draws for the global batch; this data rank's
    `batch` columns of them."""
    world = mesh.num_workers()
    if world == 1:
        return sample(batch)
    rank = mesh.data_rank()
    return sample(batch * world)[..., rank * batch:(rank + 1) * batch]


def normalize(images: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    mean = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images.to(torch.float32) - mean) / std


def random_flip_lr(images: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Per-sample horizontal flip with probability 1/2; images [B,H,W,C]."""
    flip = _draw(lambda n: torch.rand(n, generator=generator, device=images.device),
                 images.shape[0]) < 0.5
    return torch.where(flip[:, None, None, None], images.flip(2), images)


def pad_random_crop(images: torch.Tensor, generator: Optional[torch.Generator], pad: int = 4,
                    offsets: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero-pad by `pad` on each side, then crop each sample back to its
    size at a random (row, column) offset in [0, 2 * pad]; images [B,H,W,C].
    `offsets` ([2, B] ints, rows then columns) replaces the draw."""
    batch, height, width, _ = images.shape
    if offsets is None:
        offsets = _draw(lambda n: torch.randint(0, 2 * pad + 1, (2, n), generator=generator,
                                                device=images.device), batch)
    padded = F.pad(images, (0, 0, pad, pad, pad, pad))
    rows = offsets[0].to(images.device)[:, None] + torch.arange(height, device=images.device)
    cols = offsets[1].to(images.device)[:, None] + torch.arange(width, device=images.device)
    b = torch.arange(batch, device=images.device)[:, None, None]
    return padded[b, rows[:, :, None], cols[:, None, :]]


def _bilinear_sample(images: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor) -> torch.Tensor:
    """Bilinear gather of images [B,H,W,C] at float row coords ys [B, h] and
    column coords xs [B, w]; returns fp32 [B, h, w, C].  The four corners
    are gathered in the images' dtype and only they are widened to fp32
    (a uint8 batch is never converted whole)."""
    height, width = images.shape[1:3]
    y0 = torch.clamp(torch.floor(ys), 0, height - 2).long()
    x0 = torch.clamp(torch.floor(xs), 0, width - 2).long()
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :, None]
    b = torch.arange(images.shape[0], device=images.device)[:, None, None]
    r0, r1 = y0[:, :, None], (y0 + 1)[:, :, None]
    c0, c1 = x0[:, None, :], (x0 + 1)[:, None, :]

    def corner(rows, cols):
        return images[b, rows, cols].to(torch.float32)

    return (corner(r0, c0) * (1 - wy) * (1 - wx) + corner(r0, c1) * (1 - wy) * wx
            + corner(r1, c0) * wy * (1 - wx) + corner(r1, c1) * wy * wx)


def _cast_like(out: torch.Tensor, images: torch.Tensor) -> torch.Tensor:
    if images.dtype == torch.uint8:
        return torch.clamp(out, 0, 255).to(torch.uint8)
    return out.to(images.dtype)


def _valid_extent(images: torch.Tensor, valid_hw: Optional[torch.Tensor]):
    """Each sample's valid (height, width) as fp32 [B] tensors: the whole
    array without `valid_hw`, else its rows clamped to [2, H] and [2, W]."""
    batch, height, width, _ = images.shape
    if valid_hw is None:
        return (torch.full((batch,), float(height), device=images.device),
                torch.full((batch,), float(width), device=images.device))
    valid_hw = valid_hw.to(device=images.device, dtype=torch.float32)
    return (torch.clamp(valid_hw[:, 0], 2.0, float(height)),
            torch.clamp(valid_hw[:, 1], 2.0, float(width)))


def random_crop_resize(images: torch.Tensor, generator: Optional[torch.Generator],
                       out_size: Tuple[int, int],
                       area_range: Tuple[float, float] = (0.08, 1.0),
                       aspect_range: Tuple[float, float] = (3 / 4, 4 / 3),
                       valid_hw: Optional[torch.Tensor] = None,
                       draws: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inception-style random area + aspect-ratio crop, bilinear resize:
    per-sample (area, log-uniform aspect) -> a crop window clamped inside the
    sample's valid extent, sampled on a fixed [out_h, out_w] grid strictly
    inside [off, off + crop - 1], so no sample reads past the extent.

    `valid_hw` ([B, 2]: valid height, valid width; full-frame ILSVRC-12
    shards) bounds each sample's frame; without it the whole array is the
    frame.  `draws` ([4, B] fp32: area, aspect w/h, and the unit offsets of
    rows and columns) replaces the generator's draws."""
    batch = images.shape[0]
    device = images.device
    vh, vw = _valid_extent(images, valid_hw)
    if draws is None:
        def uniform(lo, hi):
            return lo + (hi - lo) * _draw(
                lambda n: torch.rand(n, generator=generator, device=device), batch)

        area = uniform(*area_range)
        aspect = torch.exp(uniform(math.log(aspect_range[0]), math.log(aspect_range[1])))
        unit_y, unit_x = uniform(0.0, 1.0), uniform(0.0, 1.0)
    else:
        area, aspect, unit_y, unit_x = draws.to(device=device, dtype=torch.float32)
    crop_h = torch.sqrt(area * vh * vw / aspect)
    crop_w = crop_h * aspect
    crop_h = torch.minimum(torch.clamp(crop_h, min=8.0), vh)
    crop_w = torch.minimum(torch.clamp(crop_w, min=8.0), vw)
    offy = unit_y * (vh - crop_h)
    offx = unit_x * (vw - crop_w)
    ry = torch.arange(out_size[0], dtype=torch.float32, device=device) / out_size[0]
    rx = torch.arange(out_size[1], dtype=torch.float32, device=device) / out_size[1]
    ys = offy[:, None] + ry[None] * torch.clamp(crop_h - 1.0, min=1.0)[:, None]
    xs = offx[:, None] + rx[None] * torch.clamp(crop_w - 1.0, min=1.0)[:, None]
    return _cast_like(_bilinear_sample(images, ys, xs), images)


def center_crop_resize(images: torch.Tensor, out_size: Tuple[int, int],
                       crop_frac: float = 0.875,
                       valid_hw: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eval preproc: central crop (fraction) + bilinear resize; with
    `valid_hw` ([B, 2]) the central crop of each sample's valid extent,
    sampled strictly inside it."""
    batch, height, width, _ = images.shape
    device = images.device
    ry = torch.arange(out_size[0], dtype=torch.float32, device=device) / out_size[0]
    rx = torch.arange(out_size[1], dtype=torch.float32, device=device) / out_size[1]
    if valid_hw is None:
        side = min(height, width) * crop_frac
        ys = ((height - side) / 2.0 + ry * side).expand(batch, -1)
        xs = ((width - side) / 2.0 + rx * side).expand(batch, -1)
    else:
        vh, vw = _valid_extent(images, valid_hw)
        side = torch.minimum(vh, vw) * crop_frac
        step = torch.clamp(side - 1.0, min=1.0)[:, None]
        ys = ((vh - side) / 2.0)[:, None] + ry[None] * step
        xs = ((vw - side) / 2.0)[:, None] + rx[None] * step
    return _cast_like(_bilinear_sample(images, ys, xs), images)
