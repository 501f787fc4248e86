"""Faster R-CNN pieces: the fixed-shape proposal layer, ROI-align, anchor
and proposal targets, ROI sampling and the two losses
(counterpart of pocketflow_tpu/nets/detection/faster_rcnn.py).

Every function takes a batch of images at once ([B, ...] leading axis) and
keeps the JAX package's fixed shapes: ``nms_fixed`` is a ``max_out``-step
greedy loop that always emits ``max_out`` slots (invalid ones flagged), so
nothing in a train step waits for the host.  Top-k selections are stable
sorts (on equal keys the lower index first, as ``jax.lax.top_k``) and every
argmax takes the first maximum.  ROI-align is a bilinear gather written out
in torch.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.nets.detection import anchors as anchor_lib
from pocketflow_tpu_torch.nets.detection.anchors import gather_rows
from pocketflow_tpu_torch.nets.detection.ssd_loss import smooth_l1

# the data-dependent tiebreak of sample_rois: frac(sin(<box, _HASH> * _HASH_SCALE))
_HASH = (12.9898, 78.233, 37.719, 4.581)
_HASH_SCALE = 43758.5453


def top_k_stable(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest of values [B, N] per row, in
    descending order, equal values in index order (``jax.lax.top_k``)."""
    out = torch.sort(values, dim=1, descending=True, stable=True)
    return out.values[:, :k], out.indices[:, :k]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
              iou_threshold: float = 0.7) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed number of outputs, for every image at once:
    boxes [B, N, 4], scores [B, N] -> (indices [B, max_out], valid
    [B, max_out]).  Picks in score order, suppressing overlaps above the
    threshold; slots past the last pick are invalid."""
    nb_img, nb = scores.shape
    area = ((boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
            * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0))
    rows = torch.arange(nb_img, device=scores.device)
    alive = torch.ones(nb_img, nb, dtype=torch.bool, device=scores.device)
    out_idx = torch.zeros(nb_img, max_out, dtype=torch.int64, device=scores.device)
    out_valid = torch.zeros(nb_img, max_out, dtype=torch.bool, device=scores.device)
    neg_inf = torch.tensor(float('-inf'), device=scores.device)
    for i in range(max_out):
        masked = torch.where(alive, scores, neg_inf)
        best = masked.argmax(dim=1)
        out_idx[:, i] = best
        out_valid[:, i] = masked[rows, best] > neg_inf
        pick = boxes[rows, best]                                     # [B, 4]
        yx1 = torch.maximum(pick[:, None, :2], boxes[..., :2])
        yx2 = torch.minimum(pick[:, None, 2:], boxes[..., 2:])
        wh = (yx2 - yx1).clamp(min=0.0)
        inter = wh[..., 0] * wh[..., 1]
        iou = inter / (area[rows, best][:, None] + area - inter).clamp(min=1e-8)
        alive &= iou <= iou_threshold
        alive[rows, best] = False
    return out_idx, out_valid


def propose(rpn_scores: torch.Tensor, rpn_deltas: torch.Tensor, anchors: torch.Tensor,
            nb_pre_nms: int, nb_proposals: int,
            iou_threshold: float = 0.7) -> Tuple[torch.Tensor, torch.Tensor]:
    """The proposal layer: the top nb_pre_nms anchors by objectness
    (rpn_scores [B, A]), decoded (rpn_deltas [B, A, 4], anchors [A, 4]), then
    NMS.  Returns (proposal boxes [B, nb_proposals, 4], valid [B, nb_proposals])."""
    scores, order = top_k_stable(rpn_scores, min(nb_pre_nms, rpn_scores.shape[1]))
    boxes = anchor_lib.decode_boxes(gather_rows(rpn_deltas, order), anchors[order])
    idx, valid = nms_fixed(boxes, scores, nb_proposals, iou_threshold)
    return gather_rows(boxes, idx), valid


def roi_linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` along a new last axis, in the arithmetic
    XLA compiles it to: t = i * (1 / (num - 1)), hi * t + lo * (1 - t) as one
    fused multiply-add (``addcmul``), the last point hi itself."""
    t = torch.arange(num - 1, dtype=torch.float32, device=lo.device) * (1.0 / (num - 1))
    inner = torch.addcmul(lo[..., None] * (1 - t), hi[..., None], t)
    return torch.cat([inner, hi[..., None]], dim=-1)


def roi_align(features: torch.Tensor, rois: torch.Tensor, output_size: int = 7) -> torch.Tensor:
    """Bilinear ROI-align: features [B, H, W, C] (NHWC), rois [B, R, 4]
    normalized (ymin, xmin, ymax, xmax) -> [B, R, S, S, C].  Each output
    point samples its 4 neighbours at (y0, x0) clipped to [0, H-2] x [0, W-2]."""
    nb_img, height, width, _ = features.shape
    ys = roi_linspace(rois[..., 0], rois[..., 2], output_size) * (height - 1)   # [B, R, S]
    xs = roi_linspace(rois[..., 1], rois[..., 3], output_size) * (width - 1)
    # a NaN coordinate indexes row 0 (XLA converts NaN to the integer 0) and
    # yields NaN through its weight, never an index out of range
    y0 = torch.nan_to_num(torch.floor(ys), nan=0.0).clamp(0, height - 2).long()
    x0 = torch.nan_to_num(torch.floor(xs), nan=0.0).clamp(0, width - 2).long()
    wy = (ys - y0).clamp(0.0, 1.0)[..., :, None, None]                         # [B, R, S, 1, 1]
    wx = (xs - x0).clamp(0.0, 1.0)[..., None, :, None]                         # [B, R, 1, S, 1]
    b = torch.arange(nb_img, device=features.device)[:, None, None, None]
    yi, xi = y0[..., :, None], x0[..., None, :]                                # [B, R, S, 1/S]
    f00 = features[b, yi, xi]
    f01 = features[b, yi, xi + 1]
    f10 = features[b, yi + 1, xi]
    f11 = features[b, yi + 1, xi + 1]
    return (f00 * (1 - wy) * (1 - wx) + f01 * (1 - wy) * wx
            + f10 * wy * (1 - wx) + f11 * wy * wx)


def _match_gt(boxes: torch.Tensor, gt_boxes: torch.Tensor, gt_valid: torch.Tensor):
    """(iou [B, N, M] zeroed on padded ground truths, best IoU [B, N], best
    ground truth [B, N]) of boxes [B, N, 4] against gt_boxes [B, M, 4]."""
    iou = anchor_lib.iou_matrix(boxes, gt_boxes) * gt_valid[:, None, :]
    return iou, iou.amax(dim=2), iou.argmax(dim=2)


def rpn_targets(gt_boxes: torch.Tensor, gt_valid: torch.Tensor, anchors: torch.Tensor,
                pos_iou: float = 0.7, neg_iou: float = 0.3):
    """Anchor-target layer: objectness labels [B, A] (1, 0, or -1 = ignore)
    and box targets [B, A, 4]; every valid ground truth claims its best anchor."""
    iou, best_iou, best_gt = _match_gt(anchors.expand(gt_boxes.shape[0], -1, -1),
                                       gt_boxes, gt_valid)
    best_anchor = iou.argmax(dim=1)                                            # [B, M]
    forced = torch.zeros(best_iou.shape, dtype=torch.float32, device=iou.device)
    forced.scatter_reduce_(1, best_anchor, gt_valid.to(torch.float32), 'amax')
    labels = torch.where(best_iou >= pos_iou, 1, -1)
    labels = torch.where(best_iou < neg_iou, 0, labels)
    labels = torch.where(forced > 0.5, 1, labels)
    box_t = anchor_lib.encode_boxes(gather_rows(gt_boxes, best_gt), anchors)
    return labels, box_t


def proposal_targets(proposals: torch.Tensor, valid: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_classes: torch.Tensor, gt_valid: torch.Tensor, fg_iou: float = 0.5):
    """Proposal-target layer over every proposal: (class labels, box
    targets, foreground mask, valid mask), each [B, N, ...]."""
    _, best_iou, best_gt = _match_gt(proposals, gt_boxes, gt_valid)
    fg = (best_iou >= fg_iou) & valid
    cls_t = torch.where(fg, gather_rows(gt_classes, best_gt).to(torch.int32), 0)
    box_t = anchor_lib.encode_boxes(gather_rows(gt_boxes, best_gt), proposals)
    return cls_t.long(), box_t, fg.to(torch.float32), valid.to(torch.float32)


def tie_hash(proposals: torch.Tensor) -> torch.Tensor:
    """The deterministic tiebreak in [0, 1) of sample_rois: frac(sin(
    <box, (12.9898, 78.233, 37.719, 4.581)> * 43758.5453)), in fp32.  For
    the large arguments it takes, a sin one ulp off moves it by ~1e-3."""
    coef = torch.tensor(_HASH, dtype=proposals.dtype, device=proposals.device)
    h = torch.sin((proposals * coef).sum(dim=-1) * _HASH_SCALE)
    return h - torch.floor(h)


def sample_rois(proposals: torch.Tensor, valid: torch.Tensor, gt_boxes: torch.Tensor,
                gt_classes: torch.Tensor, gt_valid: torch.Tensor, tie: torch.Tensor,
                nb_rois: int, fg_fraction: float = 0.25, fg_iou: float = 0.5,
                bg_iou_lo: float = 0.0):
    """Fixed-shape fg/bg ROI minibatch of each image: up to round(nb_rois *
    fg_fraction) foreground proposals (IoU >= fg_iou) and the rest
    background, each taken by priority (is_candidate + tie) with `tie` [B, P]
    in [0, 1) (``tie_hash(proposals)`` in the model).

    Returns (roi_idx [B, nb_rois], cls_t, box_t, fg, valid_mask)."""
    _, best_iou, best_gt = _match_gt(proposals, gt_boxes, gt_valid)
    is_fg = (best_iou >= fg_iou) & valid
    is_bg = (best_iou < fg_iou) & (best_iou >= bg_iou_lo) & valid
    k_fg = int(round(nb_rois * fg_fraction))
    k_bg = nb_rois - k_fg
    fg_rank = torch.where(is_fg, 1.0 + tie, tie * 1e-3)
    bg_rank = torch.where(is_bg, 1.0 + tie, tie * 1e-3)
    fg_idx = top_k_stable(fg_rank, k_fg)[1]
    bg_idx = top_k_stable(bg_rank, k_bg)[1]
    roi_idx = torch.cat([fg_idx, bg_idx], dim=1)
    # a slot is real fg/bg only if its candidate mask held (top-k may have
    # filled from non-candidates)
    fg_slot = gather_rows(is_fg, fg_idx)
    fg = torch.cat([fg_slot, torch.zeros_like(bg_idx, dtype=torch.bool)], dim=1)
    slot_valid = torch.cat([fg_slot, gather_rows(is_bg, bg_idx)], dim=1)
    gt_idx = gather_rows(best_gt, roi_idx)
    cls_t = torch.where(fg, gather_rows(gt_classes, gt_idx).to(torch.int32), 0)
    box_t = anchor_lib.encode_boxes(gather_rows(gt_boxes, gt_idx),
                                    gather_rows(proposals, roi_idx))
    return roi_idx, cls_t.long(), box_t, fg.to(torch.float32), slot_valid.to(torch.float32)


def rpn_loss(obj_logits: torch.Tensor, rpn_deltas: torch.Tensor, labels: torch.Tensor,
             box_targets: torch.Tensor, minibatch: int = 256,
             max_fg_fraction: float = 0.5) -> torch.Tensor:
    """Per image [B]: objectness BCE (labels -1 ignored), the classes
    weighted by the expected proportions of a 256-anchor minibatch with at
    most half positives, plus smooth-L1 on the positives."""
    valid = (labels >= 0).to(torch.float32)
    pos = (labels == 1).to(torch.float32)
    neg = valid * (1.0 - pos)
    bce = -(pos * F.logsigmoid(obj_logits) + (1.0 - pos) * F.logsigmoid(-obj_logits)) * valid
    nb_pos = pos.sum(dim=1).clamp(min=1.0)
    nb_neg = neg.sum(dim=1).clamp(min=1.0)
    pos_mean = (bce * pos).sum(dim=1) / nb_pos
    neg_mean = (bce * neg).sum(dim=1) / nb_neg
    n_pos_s = nb_pos.clamp(max=minibatch * max_fg_fraction)
    n_neg_s = minibatch - n_pos_s
    cls = (n_pos_s * pos_mean + n_neg_s * neg_mean) / minibatch
    loc = smooth_l1(rpn_deltas - box_targets).sum(dim=2) * pos
    return cls + loc.sum(dim=1) / nb_pos


def rcnn_loss(cls_logits: torch.Tensor, box_deltas: torch.Tensor, cls_targets: torch.Tensor,
              box_targets: torch.Tensor, fg: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per image [B]: per-ROI CE over the valid ROIs plus class-specific
    smooth-L1 on the foreground ones."""
    logp = F.log_softmax(cls_logits.to(torch.float32), dim=-1)
    ce = -logp.gather(2, cls_targets[..., None])[..., 0] * valid
    nb_valid = valid.sum(dim=1).clamp(min=1.0)
    nb_fg = fg.sum(dim=1).clamp(min=1.0)
    nb_classes = cls_logits.shape[-1]
    deltas = box_deltas.reshape(*box_deltas.shape[:2], nb_classes, 4)
    own = deltas.gather(2, cls_targets[..., None, None].expand(-1, -1, 1, 4))[:, :, 0]
    loc = smooth_l1(own - box_targets).sum(dim=2) * fg
    return ce.sum(dim=1) / nb_valid + loc.sum(dim=1) / nb_fg
