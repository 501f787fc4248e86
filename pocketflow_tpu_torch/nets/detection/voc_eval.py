"""VOC-style mAP on the host (a copy of pocketflow_tpu/nets/detection/voc_eval.py,
logic unchanged): per-class AP by the VOC protocol (ranked detections matched
greedily at IoU >= 0.5; all-points interpolated AP by default, 11-point
optional), averaged to mAP; 'difficult' ground truths are ignored.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def _voc_ap(recall: np.ndarray, precision: np.ndarray,
            use_07_metric: bool = False) -> float:
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(precision[recall >= t]) if np.any(recall >= t) else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou(box: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    yx1 = np.maximum(box[:2], boxes[:, :2])
    yx2 = np.minimum(box[2:], boxes[:, 2:])
    wh = np.maximum(yx2 - yx1, 0.0)
    inter = wh[:, 0] * wh[:, 1]
    area = (box[2] - box[0]) * (box[3] - box[1])
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.maximum(area + areas - inter, 1e-8)


def evaluate_detections(all_detections: List[List[Dict]],
                        all_groundtruth: Sequence[np.ndarray],
                        nb_classes: int,
                        iou_threshold: float = 0.5,
                        use_07_metric: bool = False) -> Dict[str, float]:
    """Compute per-class AP + mAP.

    all_detections[i]  = list of {'class','score','box'} for image i;
    all_groundtruth[i] = [M, 6] rows [class, ymin, xmin, ymax, xmax, valid]
    where valid is 1.0 (counted), 0.0 (padding) or -1.0 ('difficult' — the
    VOC protocol ignores it: not a positive, and a detection matching it is
    not a false positive either).
    """
    aps = {}
    for cls in range(1, nb_classes):
        records = []  # (score, image_idx, box)
        nb_gt = 0
        gt_boxes_per_img, gt_used_per_img, gt_ignore_per_img = [], [], []
        for gt in all_groundtruth:
            of_cls = gt[:, 0] == cls
            valid = (gt[:, 5] > 0.5) & of_cls
            ignore = (gt[:, 5] < -0.5) & of_cls
            sel = valid | ignore
            boxes = gt[sel, 1:5]
            gt_boxes_per_img.append(boxes)
            gt_used_per_img.append(np.zeros(len(boxes), bool))
            gt_ignore_per_img.append(gt[sel, 5] < -0.5)
            nb_gt += int(np.sum(valid))
        for img_idx, dets in enumerate(all_detections):
            for d in dets:
                if d['class'] == cls:
                    records.append((d['score'], img_idx, np.asarray(d['box'])))
        if nb_gt == 0:
            continue
        records.sort(key=lambda r: -r[0])
        tp = np.zeros(len(records))
        fp = np.zeros(len(records))
        for rank, (score, img_idx, box) in enumerate(records):
            gts = gt_boxes_per_img[img_idx]
            if len(gts) == 0:
                fp[rank] = 1
                continue
            ious = _iou(box, gts)
            best = int(np.argmax(ious))
            if ious[best] >= iou_threshold:
                if gt_ignore_per_img[img_idx][best]:
                    pass  # matched a 'difficult' box: ignored entirely
                elif not gt_used_per_img[img_idx][best]:
                    tp[rank] = 1
                    gt_used_per_img[img_idx][best] = True
                else:
                    fp[rank] = 1
            else:
                fp[rank] = 1
        cum_tp, cum_fp = np.cumsum(tp), np.cumsum(fp)
        recall = cum_tp / nb_gt
        precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-8)
        aps['ap_cls_%d' % cls] = _voc_ap(recall, precision, use_07_metric)
    mean_ap = float(np.mean(list(aps.values()))) if aps else 0.0
    return {'mAP': mean_ap, **aps}
