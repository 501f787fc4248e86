"""Detection post-processing on the host: greedy NMS and the per-class
select / filter / sort / NMS of one image's predictions (a copy of
pocketflow_tpu/nets/detection/nms.py, logic unchanged).  It runs once per
eval image, never in the train step.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float = 0.45,
        max_out: int = 200) -> np.ndarray:
    """Greedy NMS; boxes [N,4] (ymin,xmin,ymax,xmax), returns kept indices."""
    order = np.argsort(-scores)
    keep = []
    while order.size > 0 and len(keep) < max_out:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        yx1 = np.maximum(boxes[i, :2], boxes[rest, :2])
        yx2 = np.minimum(boxes[i, 2:], boxes[rest, 2:])
        wh = np.maximum(yx2 - yx1, 0.0)
        inter = wh[:, 0] * wh[:, 1]
        area_i = (boxes[i, 2] - boxes[i, 0]) * (boxes[i, 3] - boxes[i, 1])
        area_r = ((boxes[rest, 2] - boxes[rest, 0])
                  * (boxes[rest, 3] - boxes[rest, 1]))
        iou = inter / np.maximum(area_i + area_r - inter, 1e-8)
        order = rest[iou <= iou_threshold]
    return np.asarray(keep, np.int64)


def parse_detections(cls_probs: np.ndarray, boxes: np.ndarray,
                     score_threshold: float = 0.01,
                     iou_threshold: float = 0.45,
                     max_per_class: int = 200) -> List[Dict]:
    """Per-class select/filter/sort/NMS for ONE image.

    cls_probs [A, C] (class 0 = background); boxes [A, 4] (shared boxes,
    SSD-style) or [A, C, 4] (class-specific box deltas, Faster-RCNN-style).
    Returns a list of {'class', 'score', 'box'} detections.
    """
    out = []
    nb_classes = cls_probs.shape[1]
    for cls in range(1, nb_classes):
        scores = cls_probs[:, cls]
        sel = scores > score_threshold
        if not np.any(sel):
            continue
        cls_all_boxes = boxes[:, cls] if boxes.ndim == 3 else boxes
        cls_boxes, cls_scores = cls_all_boxes[sel], scores[sel]
        keep = nms(cls_boxes, cls_scores, iou_threshold, max_per_class)
        for i in keep:
            out.append({'class': cls, 'score': float(cls_scores[i]),
                        'box': cls_boxes[i].tolist()})
    out.sort(key=lambda d: -d['score'])
    return out
