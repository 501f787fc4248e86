"""SSD multibox loss with hard-negative mining
(counterpart of pocketflow_tpu/nets/detection/ssd_loss.py).

Cross-entropy on the matched anchors plus the ``negative_ratio`` x #positives
hardest negatives, smooth-L1 on the box targets, each normalized by the
image's positives and averaged over the batch.  The negatives are ranked by a
stable sort of their losses (equal losses keep anchor order), as
``jnp.argsort`` ranks them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.nets.detection import anchors as anchor_lib


def smooth_l1(x: torch.Tensor) -> torch.Tensor:
    absx = x.abs()
    return torch.where(absx < 1.0, 0.5 * x * x, absx - 0.5)


def stable_ranks(scores: torch.Tensor) -> torch.Tensor:
    """The rank of each entry of scores [B, N] in descending order, equal
    scores ranked by index (``argsort(argsort(-scores))`` with stable sorts)."""
    order = torch.sort(-scores, dim=1, stable=True).indices
    ranks = torch.empty_like(order)
    ranks.scatter_(1, order, torch.arange(scores.shape[1], device=scores.device)
                   .expand_as(order).contiguous())
    return ranks


def ssd_loss(cls_logits: torch.Tensor, box_deltas: torch.Tensor, labels: torch.Tensor,
             anchors: torch.Tensor, negative_ratio: float = 3.0,
             pos_threshold: float = 0.5) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """cls_logits [B,A,C], box_deltas [B,A,4], labels [B,M,6] -> (loss, metrics).

    labels rows: [class, ymin, xmin, ymax, xmax, valid].
    """
    cls_t, box_t, pos = anchor_lib.match_anchors(
        labels[..., 1:5], labels[..., 0], labels[..., 5], anchors, pos_threshold)
    nb_pos = pos.sum(dim=1).clamp(min=1.0)
    log_probs = F.log_softmax(cls_logits.to(torch.float32), dim=-1)
    ce = -log_probs.gather(2, cls_t[..., None])[..., 0]
    with torch.no_grad():  # hard negatives: the top (ratio * nb_pos) background anchors
        ranks = stable_ranks(torch.where(pos > 0.5, float('-inf'), ce))
        nb_neg = torch.clamp(negative_ratio * nb_pos, max=float(cls_logits.shape[1]))
        neg_mask = (ranks < nb_neg[:, None]).to(torch.float32) * (1.0 - pos)
    cls_losses = (ce * (pos + neg_mask)).sum(dim=1) / nb_pos
    loc = smooth_l1(box_deltas.to(torch.float32) - box_t)
    loc_losses = (loc.sum(dim=2) * pos).sum(dim=1) / nb_pos
    cls_loss, loc_loss = cls_losses.mean(), loc_losses.mean()
    metrics = {'cls_loss': cls_loss, 'loc_loss': loc_loss,
               'nb_pos_anchors': pos.sum(dim=1).mean()}
    return cls_loss + loc_loss, metrics
