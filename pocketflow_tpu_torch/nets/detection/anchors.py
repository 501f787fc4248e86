"""SSD anchors, IoU, box encode/decode and anchor matching
(counterpart of pocketflow_tpu/nets/detection/anchors.py).

Anchors are numpy at model-build time (a copy of the JAX package's
generator).  The rest are torch functions on the device that broadcast over
leading batch axes; ``match_anchors`` matches a whole batch at once, its
greedy claim loop running once over the ground-truth slots for every image
together.  Ties go to the first index, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import itertools
import math
from typing import Sequence

import numpy as np
import torch

VARIANCES = (0.1, 0.2)


def generate_anchors(feature_sizes: Sequence[int],
                     scales: Sequence[float],
                     aspect_ratios: Sequence[Sequence[float]]) -> np.ndarray:
    """Anchor boxes [A, 4] as (ymin, xmin, ymax, xmax), normalized to [0,1].

    scales has len(feature_sizes)+1 entries (the extra one forms the
    sqrt(s_k * s_{k+1}) anchor, standard SSD).
    """
    anchors = []
    for idx, fsize in enumerate(feature_sizes):
        s_k = scales[idx]
        s_k1 = scales[idx + 1] if idx + 1 < len(scales) else 1.0
        sizes = [(s_k, s_k)]
        sizes.append((math.sqrt(s_k * s_k1), math.sqrt(s_k * s_k1)))
        for ar in aspect_ratios[idx]:
            sizes.append((s_k / math.sqrt(ar), s_k * math.sqrt(ar)))
        for y, x in itertools.product(range(fsize), repeat=2):
            cy, cx = (y + 0.5) / fsize, (x + 0.5) / fsize
            for sh, sw in sizes:
                anchors.append([cy - sh / 2, cx - sw / 2,
                                cy + sh / 2, cx + sw / 2])
    return np.clip(np.asarray(anchors, np.float32), 0.0, 1.0)


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU: boxes_a [..., N, 4] x boxes_b [..., M, 4] -> [..., N, M]."""
    a = boxes_a.unsqueeze(-2)
    b = boxes_b.unsqueeze(-3)
    inter_ymin = torch.maximum(a[..., 0], b[..., 0])
    inter_xmin = torch.maximum(a[..., 1], b[..., 1])
    inter_ymax = torch.minimum(a[..., 2], b[..., 2])
    inter_xmax = torch.minimum(a[..., 3], b[..., 3])
    inter = ((inter_ymax - inter_ymin).clamp(min=0.0)
             * (inter_xmax - inter_xmin).clamp(min=0.0))
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    return inter / (area_a + area_b - inter).clamp(min=1e-8)


def _centers(boxes: torch.Tensor):
    cy = (boxes[..., 0] + boxes[..., 2]) / 2
    cx = (boxes[..., 1] + boxes[..., 3]) / 2
    h = (boxes[..., 2] - boxes[..., 0]).clamp(min=1e-8)
    w = (boxes[..., 3] - boxes[..., 1]).clamp(min=1e-8)
    return cy, cx, h, w


def encode_boxes(gt: torch.Tensor, anchors: torch.Tensor, variances=VARIANCES) -> torch.Tensor:
    """GT boxes -> regression targets relative to anchors ([..., A, 4] each,
    broadcast).  The variances divide as reciprocals, as XLA compiles the
    JAX package's division by a constant."""
    a_cy, a_cx, a_h, a_w = _centers(anchors)
    g_cy, g_cx, g_h, g_w = _centers(gt)
    inv0, inv1 = 1.0 / variances[0], 1.0 / variances[1]
    return torch.stack([
        (g_cy - a_cy) / a_h * inv0,
        (g_cx - a_cx) / a_w * inv0,
        torch.log(g_h / a_h) * inv1,
        torch.log(g_w / a_w) * inv1], dim=-1)


def decode_boxes(deltas: torch.Tensor, anchors: torch.Tensor, variances=VARIANCES) -> torch.Tensor:
    """Regression outputs -> (ymin, xmin, ymax, xmax), clipped to [0, 1]."""
    a_cy = (anchors[..., 0] + anchors[..., 2]) / 2
    a_cx = (anchors[..., 1] + anchors[..., 3]) / 2
    a_h = (anchors[..., 2] - anchors[..., 0]).clamp(min=1e-8)
    a_w = (anchors[..., 3] - anchors[..., 1]).clamp(min=1e-8)
    cy = deltas[..., 0] * variances[0] * a_h + a_cy
    cx = deltas[..., 1] * variances[0] * a_w + a_cx
    h = torch.exp((deltas[..., 2] * variances[1]).clamp(-10, 10)) * a_h
    w = torch.exp((deltas[..., 3] * variances[1]).clamp(-10, 10)) * a_w
    return torch.stack([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2], dim=-1).clamp(0.0, 1.0)


def gather_rows(values: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """values [B, M, ...] at idx [B, N] -> [B, N, ...] (per image)."""
    b = torch.arange(values.shape[0], device=values.device).view(-1, *([1] * (idx.dim() - 1)))
    return values[b, idx]


def match_anchors(gt_boxes: torch.Tensor, gt_classes: torch.Tensor, gt_valid: torch.Tensor,
                  anchors: torch.Tensor, pos_threshold: float = 0.5):
    """Match anchors [A, 4] to each image's ground truths (gt_boxes
    [B, M, 4], gt_classes and gt_valid [B, M]).

    Returns (cls_targets [B, A] int64, box_targets [B, A, 4], pos_mask [B, A]
    float).  Background class = 0.  Every valid ground truth claims its best
    still-free anchor (greedy over the slots, so two ground truths whose best
    anchor coincides both get one; padded or difficult rows claim none), then
    anchors with IoU >= threshold join.
    """
    iou = iou_matrix(anchors, gt_boxes) * gt_valid[:, None, :]     # [B, A, M]
    best_iou = iou.amax(dim=2)
    best_gt = iou.argmax(dim=2)  # the first maximum, as jnp.argmax
    nb_img, nb_anchors = iou.shape[:2]
    rows = torch.arange(nb_img, device=iou.device)
    forced = torch.zeros(nb_img, nb_anchors, dtype=torch.bool, device=iou.device)
    gt_of = torch.zeros(nb_img, nb_anchors, dtype=torch.int64, device=iou.device)
    ok_all = gt_valid > 0.5
    for g in range(gt_boxes.shape[1]):
        col = torch.where(forced, -1.0, iou[:, :, g])  # a claimed anchor is taken
        a = col.argmax(dim=1)
        ok = ok_all[:, g]
        forced[rows, a] |= ok
        gt_of[rows, a] = torch.where(ok, g, gt_of[rows, a])
    pos_mask = (best_iou >= pos_threshold) | forced
    gt_idx = torch.where(forced, gt_of, best_gt)
    cls_targets = torch.where(pos_mask, gather_rows(gt_classes, gt_idx).to(torch.int32), 0)
    box_targets = encode_boxes(gather_rows(gt_boxes, gt_idx), anchors)
    return cls_targets.long(), box_targets, pos_mask.to(torch.float32)
