"""Faster R-CNN (ResNet backbone) @ Pascal VOC
(counterpart of pocketflow_tpu/nets/faster_rcnn_at_pascalvoc.py).

``forward_w_labels=True``: anchor targets are assigned in the loss, but the
fg/bg ROI minibatch is sampled inside the train forward, so it needs the
ground truth.  A two-level RPN (stride 8 and 16, an FPN-style lateral 1x1
conv per level bringing both to 256 channels, then ``rpn_conv``,
``rpn_obj`` and ``rpn_box`` shared by the levels and called once per level),
the fixed-shape proposal layer, ROI-align with the level chosen by the ROI's
scale (>= 0.45 pools from stride 16), two fc layers and class-specific heads
(nets/detection/faster_rcnn.py).  Eval decodes the class-specific deltas
and runs per-class NMS on the host, then VOC mAP.

The trunk is ``backbone/``: the ImageNet ResNet's stem and stages 1-3 with
ResNetImageNet's names (nets/resnet.build_imagenet_trunk), so a
classification checkpoint grafts into it, or the compact `small` trunk for
tests.  Shrunk serving of the detector (``width_map``) is not ported.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.datasets.pascalvoc import PascalVocDataset
from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
from pocketflow_tpu_torch.nets.detection import anchors as anchor_lib
from pocketflow_tpu_torch.nets.detection import faster_rcnn as frcnn
from pocketflow_tpu_torch.nets.detection import nms as nms_lib
from pocketflow_tpu_torch.nets.detection.eval_loop import DetectionHelperMixin
from pocketflow_tpu_torch.nets.resnet import (
    IMAGENET_CONFIGS, BasicBlock, build_imagenet_trunk, imagenet_trunk)
from pocketflow_tpu_torch.nn.layers import (
    BatchNorm, PFConv, PFDense, compression, max_pool, relu, reset_parameters, set_paths)

FLAGS.DEFINE_string('frcnn_backbone', 'resnet50',
                    'Faster-RCNN backbone: resnet18 | resnet34 | resnet50 (ImageNet ResNet '
                    'trunks) or `small` (compact trunk for CPU smoke tests)')
FLAGS.DEFINE_integer('frcnn_nb_proposals', 300,
                     'Faster-RCNN: # of proposals kept after RPN NMS')
FLAGS.DEFINE_integer('frcnn_nb_pre_nms', 1024, 'Faster-RCNN: top-k before NMS')
FLAGS.DEFINE_float('frcnn_rpn_nms_threshold', 0.7, 'Faster-RCNN: RPN NMS IoU')
FLAGS.DEFINE_integer('frcnn_roi_size', 7, 'Faster-RCNN: ROI-align output size')
FLAGS.DEFINE_integer('frcnn_roi_batch', 128,
                     'Faster-RCNN: sampled ROI minibatch per image (train)')
FLAGS.DEFINE_float('frcnn_score_threshold', 0.05,
                   'Faster-RCNN: eval detection score threshold')
FLAGS.DEFINE_float('frcnn_nms_threshold', 0.45,
                   'Faster-RCNN: eval per-class NMS IoU threshold')
FLAGS.DEFINE_float('frcnn_fg_fraction', 0.25,
                   'Faster-RCNN: foreground fraction of the ROI minibatch')

# anchor scales per feature level (stride 8: small objects, stride 16: large)
RPN_LEVEL_SCALES = ((0.1, 0.2, 0.35), (0.5, 0.7, 0.95))
RPN_RATIOS = (0.5, 1.0, 2.0)
LATERAL_WIDTH = 256
COARSE_SCALE = 0.45  # ROIs at least this large pool from the stride-16 level


class SmallResNetBackbone(nn.Module):
    """Compact ResNet-style trunk: NHWC images -> (stride-8, stride-16) maps."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv_init = PFConv(3, 64, (7, 7), (2, 2), use_bias=False, dtype=dtype)
        self.bn_init = BatchNorm(64, dtype=dtype)
        self.block0 = BasicBlock(64, 64, (1, 1), dtype)
        self.block1 = BasicBlock(64, 128, (1, 1), dtype)
        self.block2 = BasicBlock(128, 128, (2, 2), dtype)
        self.block3 = BasicBlock(128, 256, (2, 2), dtype)
        self.out_features = (128, 256)

    def forward(self, x: torch.Tensor):
        x = relu(self.bn_init(self.conv_init(x.permute(0, 3, 1, 2))))
        x = max_pool(x, (3, 3), (2, 2), padding='SAME')
        x = self.block1(self.block0(x))
        c3 = self.block2(x)   # stride 8
        c4 = self.block3(c3)  # stride 16
        return c3, c4


class ResNetBackbone(nn.Module):
    """The ImageNet ResNet stem and stages 1-3 (ResNetImageNet's names):
    NHWC images -> (C3 stride 8, C4 stride 16)."""

    def __init__(self, resnet_size: int = 50, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_features = tuple(build_imagenet_trunk(self, resnet_size, dtype,
                                                       nb_stages=3)[1:])

    def forward(self, x: torch.Tensor):
        feats = imagenet_trunk(self, x)
        return feats[1], feats[2]


def build_backbone(name: str, dtype: torch.dtype) -> nn.Module:
    if name == 'small':
        return SmallResNetBackbone(dtype)
    if name.startswith('resnet') and int(name[len('resnet'):]) in IMAGENET_CONFIGS:
        return ResNetBackbone(int(name[len('resnet'):]), dtype)
    raise ValueError('unknown frcnn_backbone: %r' % name)


def anchors_for(fsize: int, scales) -> np.ndarray:
    """The RPN anchors [fsize * fsize * 9, 4] of one level, (y, x, scale,
    ratio) order, clipped to [0, 1]."""
    anchors = []
    for y in range(fsize):
        for x in range(fsize):
            cy, cx = (y + 0.5) / fsize, (x + 0.5) / fsize
            for s in scales:
                for r in RPN_RATIOS:
                    h, w = s * (r ** 0.5), s / (r ** 0.5)
                    anchors.append([cy - h / 2, cx - w / 2, cy + h / 2, cx + w / 2])
    return np.clip(np.asarray(anchors, np.float32), 0.0, 1.0)


class FasterRCNN(nn.Module):
    """Two-level RPN + sampled ROI heads.

    forward(images NHWC, labels=None) -> outputs dict.  With labels (the
    train forward) the ROI head runs on a sampled fg/bg minibatch and the
    outputs carry its targets; without, it scores every proposal.  The
    proposal, ROI and head settings are the ``frcnn_*`` flags at build time.
    """

    def __init__(self, nb_classes: int = 21, backbone_name: str = 'resnet50',
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        if len({len(s) for s in RPN_LEVEL_SCALES}) != 1:
            raise ValueError('RPN_LEVEL_SCALES tuples must have equal length (shared RPN '
                             'head): %r' % (RPN_LEVEL_SCALES,))
        self.nb_classes = nb_classes
        self.dtype = dtype
        self.nb_proposals = int(FLAGS.frcnn_nb_proposals)
        self.nb_pre_nms = int(FLAGS.frcnn_nb_pre_nms)
        self.rpn_nms_threshold = float(FLAGS.frcnn_rpn_nms_threshold)
        self.roi_size = int(FLAGS.frcnn_roi_size)
        self.roi_batch = int(FLAGS.frcnn_roi_batch)
        self.fg_fraction = float(FLAGS.frcnn_fg_fraction)
        self.backbone = build_backbone(backbone_name, dtype)
        c3, c4 = self.backbone.out_features
        self.lateral0 = PFConv(c3, LATERAL_WIDTH, (1, 1), dtype=dtype)
        self.lateral1 = PFConv(c4, LATERAL_WIDTH, (1, 1), dtype=dtype)
        nb_anchors = len(RPN_LEVEL_SCALES[0]) * len(RPN_RATIOS)
        self.rpn_conv = PFConv(LATERAL_WIDTH, LATERAL_WIDTH, (3, 3), dtype=dtype)
        self.rpn_obj = PFConv(LATERAL_WIDTH, nb_anchors, (1, 1), dtype=dtype)
        self.rpn_box = PFConv(LATERAL_WIDTH, nb_anchors * 4, (1, 1), dtype=dtype)
        self.fc1 = PFDense(self.roi_size * self.roi_size * LATERAL_WIDTH, 512, dtype=dtype)
        self.fc2 = PFDense(512, 512, dtype=dtype)
        self.cls_head = PFDense(512, nb_classes, dtype=dtype)
        self.box_head = PFDense(512, nb_classes * 4, dtype=dtype)
        self._anchors = {}
        set_paths(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def anchors(self, sizes, device) -> torch.Tensor:
        """The anchors of both levels [A, 4] for level sizes `sizes` on
        `device` (made once a key)."""
        key = (tuple(sizes), str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(np.concatenate(
                [anchors_for(s, scales) for s, scales in zip(sizes, RPN_LEVEL_SCALES)])
            ).to(device)
        return self._anchors[key]

    def pool_rois(self, f8: torch.Tensor, f16: torch.Tensor, boxes: torch.Tensor):
        """ROI-align from the level the ROI's scale picks: [B, R, S, S, C] fp32."""
        scale = torch.sqrt((boxes[..., 2] - boxes[..., 0]).clamp(min=0.0)
                           * (boxes[..., 3] - boxes[..., 1]).clamp(min=0.0))
        use_coarse = (scale >= COARSE_SCALE)[..., None, None, None]
        r8 = frcnn.roi_align(f8.to(torch.float32), boxes, self.roi_size)
        r16 = frcnn.roi_align(f16.to(torch.float32), boxes, self.roi_size)
        return torch.where(use_coarse, r16, r8)

    def forward(self, images: torch.Tensor, labels: Optional[torch.Tensor] = None):
        b = images.shape[0]
        levels = self.backbone(images)
        obj_list, delta_list, lat_feats, sizes = [], [], [], []
        for lateral, feats in zip((self.lateral0, self.lateral1), levels):
            feats = lateral(feats)
            lat_feats.append(feats.permute(0, 2, 3, 1))   # NHWC view for ROI-align
            rpn = relu(self.rpn_conv(feats))               # the shared RPN head
            obj_list.append(self.rpn_obj(rpn).permute(0, 2, 3, 1).reshape(b, -1)
                            .to(torch.float32))
            delta_list.append(self.rpn_box(rpn).permute(0, 2, 3, 1).reshape(b, -1, 4)
                              .to(torch.float32))
            sizes.append(feats.shape[2])
        obj_logits = torch.cat(obj_list, dim=1)
        rpn_deltas = torch.cat(delta_list, dim=1)
        anchors = self.anchors(sizes, images.device)

        # proposals are data to the second stage: no gradient into the RPN
        # through the ROI coordinates or the targets
        with torch.no_grad():
            props, valid = frcnn.propose(torch.sigmoid(obj_logits), rpn_deltas, anchors,
                                         self.nb_pre_nms, self.nb_proposals,
                                         self.rpn_nms_threshold)
        outputs = {'anchors': anchors, 'obj_logits': obj_logits, 'rpn_deltas': rpn_deltas,
                   'proposals': props, 'proposal_valid': valid}
        if labels is not None:
            labels = labels.to(torch.float32)
            gt_boxes, gt_cls, gt_valid = labels[..., 1:5], labels[..., 0], labels[..., 5]
            # the ground truths join the proposal pool, so foreground ROIs
            # exist from step 0
            pool = torch.cat([props, gt_boxes], dim=1)
            pool_valid = torch.cat([valid, gt_valid > 0.5], dim=1)
            nb_rois = min(self.roi_batch, self.nb_proposals)
            roi_idx, cls_t, box_t, fg, vmask = frcnn.sample_rois(
                pool, pool_valid, gt_boxes, gt_cls, gt_valid, frcnn.tie_hash(pool), nb_rois,
                self.fg_fraction)
            rois_boxes = anchor_lib.gather_rows(pool, roi_idx)
            outputs.update(roi_cls_targets=cls_t, roi_box_targets=box_t, roi_fg=fg,
                           roi_valid=vmask)
        else:
            nb_rois = self.nb_proposals
            rois_boxes = props
        outputs['roi_boxes'] = rois_boxes
        rois = self.pool_rois(lat_feats[0], lat_feats[1], rois_boxes)
        x = rois.reshape(b * nb_rois, -1).to(self.dtype)
        x = relu(self.fc1(x))
        x = relu(self.fc2(x))
        outputs['cls_logits'] = self.cls_head(x).to(torch.float32).reshape(
            b, nb_rois, self.nb_classes)
        outputs['box_deltas'] = self.box_head(x).to(torch.float32).reshape(
            b, nb_rois, self.nb_classes * 4)
        return outputs


class ModelHelper(DetectionHelperMixin, AbstractModelHelper):
    """Model helper for Faster R-CNN @ PascalVOC (forward_w_labels=True)."""

    model_name = 'faster_rcnn'
    dataset_name = 'pascalvoc'
    BACKBONE = 'backbone/'

    def __init__(self, data_format='channels_last'):
        super().__init__(data_format, forward_w_labels=True)
        self.dataset_train = PascalVocDataset(is_train=True)
        self.dataset_eval = PascalVocDataset(is_train=False)
        self.nb_classes = self.dataset_train.spec.nb_classes
        self._init_eval()

    def build_dataset_train(self, enbl_trn_val_split=False):
        return self.dataset_train

    def build_dataset_eval(self):
        return self.dataset_eval

    def create_model(self):
        dtype = torch.bfloat16 if FLAGS.compute_dtype == 'bfloat16' else torch.float32
        return FasterRCNN(nb_classes=self.nb_classes, backbone_name=FLAGS.frcnn_backbone,
                          dtype=dtype)

    def forward_train(self, model, inputs, policy=None, labels=None):
        """The train forward with labels: ROI sampling in the forward."""
        model.train()
        with compression(policy):
            return model(inputs, labels=labels)

    def calc_loss(self, labels, outputs, trainable_vars):
        labels = labels.to(torch.float32)
        gt_boxes, gt_cls, gt_valid = labels[..., 1:5], labels[..., 0], labels[..., 5]
        rpn_lab, rpn_t = frcnn.rpn_targets(gt_boxes, gt_valid, outputs['anchors'])
        l_rpn = frcnn.rpn_loss(outputs['obj_logits'], outputs['rpn_deltas'], rpn_lab, rpn_t)
        metrics = {}
        if 'roi_cls_targets' in outputs:  # the sampled minibatch: targets from the forward
            cls_t, box_t = outputs['roi_cls_targets'], outputs['roi_box_targets']
            fg, vmask = outputs['roi_fg'], outputs['roi_valid']
            metrics['nb_fg_rois'] = fg.sum(dim=1).mean()
        else:  # eval outputs (every proposal): targets assigned here
            cls_t, box_t, fg, vmask = frcnn.proposal_targets(
                outputs['roi_boxes'], outputs['proposal_valid'], gt_boxes, gt_cls, gt_valid)
        l_rcnn = frcnn.rcnn_loss(outputs['cls_logits'], outputs['box_deltas'], cls_t, box_t,
                                 fg, vmask)
        pred = outputs['cls_logits'].argmax(dim=-1)
        acc = ((pred == cls_t) * fg).sum(dim=1) / fg.sum(dim=1).clamp(min=1.0)
        loss = l_rpn.mean() + l_rcnn.mean()
        loss = loss + self.weight_decay_loss(trainable_vars, exclude_bn=True).to(loss.device)
        return loss, {'rpn_loss': l_rpn.mean(), 'rcnn_loss': l_rcnn.mean(),
                      'accuracy': acc.mean(), **metrics}

    def setup_lrn_rate(self, global_batch_size: int):
        nb_epochs = 25
        nb_smpls = self.dataset_train.spec.nb_smpls_train
        schedule = schedules.piecewise_constant(global_batch_size, [15, 20], [1.0, 0.1, 0.01],
                                                nb_smpls)
        nb_iters = int(nb_smpls * nb_epochs * FLAGS.nb_epochs_rat / global_batch_size)
        return schedule, nb_iters

    # -- the dump_n_eval protocol ------------------------------------------

    def decode(self, outputs, labels):
        """(class probabilities [B, R, C] zeroed on invalid proposals,
        class-specific boxes [B, R, C, 4], labels) as host arrays."""
        cls_logits, props = outputs['cls_logits'], outputs['roi_boxes']
        nb_c = cls_logits.shape[-1]
        boxes = anchor_lib.decode_boxes(
            outputs['box_deltas'].reshape(*props.shape[:2], nb_c, 4), props[:, :, None, :])
        probs = torch.softmax(cls_logits, dim=-1) * outputs['proposal_valid'][..., None]
        return probs.cpu().numpy(), boxes.cpu().numpy(), labels.cpu().numpy()

    def parse(self, probs, boxes):
        return nms_lib.parse_detections(probs, boxes,
                                        score_threshold=FLAGS.frcnn_score_threshold,
                                        iou_threshold=FLAGS.frcnn_nms_threshold)
