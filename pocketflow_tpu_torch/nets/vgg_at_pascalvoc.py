"""SSD-VGG16 @ Pascal VOC (counterpart of pocketflow_tpu/nets/vgg_at_pascalvoc.py).

* anchors, matching and encode/decode: nets/detection/anchors.py, on the
  device inside the train step;
* the loss: nets/detection/ssd_loss.py, with the classification loss ramped
  0 -> 1 over the first ``nb_iters_cls_wmup`` train steps;
* the prediction parse: nets/detection/nms.py on the host, eval only;
* mAP: nets/detection/voc_eval.py through the dump_n_eval protocol
  ('init' / 'dump' / 'eval'), driven by nets/detection/eval_loop.py.
"""

from __future__ import annotations

import numpy as np
import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.core.profiling import span
from pocketflow_tpu_torch.datasets.pascalvoc import PascalVocDataset
from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
from pocketflow_tpu_torch.nets.detection import anchors as anchor_lib
from pocketflow_tpu_torch.nets.detection import nms as nms_lib
from pocketflow_tpu_torch.nets.detection import ssd_loss as loss_lib
from pocketflow_tpu_torch.nets.detection.eval_loop import DetectionHelperMixin
from pocketflow_tpu_torch.nets.vgg import SSDVGG

FLAGS.DEFINE_float('ssd_negative_ratio', 3.0, 'SSD: hard-negative ratio')
FLAGS.DEFINE_float('ssd_match_threshold', 0.5, 'SSD: anchor-match IoU threshold')
FLAGS.DEFINE_float('ssd_nms_threshold', 0.45, 'SSD: NMS IoU threshold')
FLAGS.DEFINE_float('ssd_score_threshold', 0.05, 'SSD: detection score threshold')
# without the warm-up a from-scratch VGG-SSD (no BN anywhere) collapses to
# predicting background at every anchor
FLAGS.DEFINE_integer('nb_iters_cls_wmup', 10000,
                     'SSD: iterations to warm up the classification loss')
FLAGS.DEFINE_float('lrn_rate_min', 1e-6, 'SSD: minimal learning rate floor')

# anchor scales/aspect-ratios per feature map (SSD-300 defaults)
SSD_SCALES = [0.1, 0.2, 0.375, 0.55, 0.725, 0.9, 1.0]
SSD_ASPECTS = [[2.0, 0.5]] * 6


class ModelHelper(DetectionHelperMixin, AbstractModelHelper):
    """Model helper for SSD-VGG @ PascalVOC (detection)."""

    model_name = 'vgg_ssd'
    dataset_name = 'pascalvoc'
    BACKBONE = 'vgg/'

    def __init__(self, data_format='channels_last'):
        super().__init__(data_format, forward_w_labels=False)
        self.dataset_train = PascalVocDataset(is_train=True)
        self.dataset_eval = PascalVocDataset(is_train=False)
        self.nb_classes = self.dataset_train.spec.nb_classes
        self.image_size = self.dataset_train.spec.image_shape[0]
        sizes = SSDVGG.feature_sizes(self.image_size)
        self.anchors_np = anchor_lib.generate_anchors(
            sizes, SSD_SCALES[:len(sizes) + 1], SSD_ASPECTS[:len(sizes)])
        self._anchors = {}
        self._init_eval()

    def anchors(self, device) -> torch.Tensor:
        """The anchors [A, 4] on `device` (made once a device)."""
        key = str(device)
        if key not in self._anchors:
            self._anchors[key] = torch.from_numpy(self.anchors_np).to(device)
        return self._anchors[key]

    def build_dataset_train(self, enbl_trn_val_split=False):
        return self.dataset_train

    def build_dataset_eval(self):
        return self.dataset_eval

    def create_model(self):
        dtype = torch.bfloat16 if FLAGS.compute_dtype == 'bfloat16' else torch.float32
        # generate_anchors emits 2 + len(aspects) anchors a cell; the heads agree
        return SSDVGG(self.image_size, nb_classes=self.nb_classes,
                      nb_anchors_per_cell=2 + len(SSD_ASPECTS[0]), dtype=dtype)

    def calc_loss(self, labels, outputs, trainable_vars, step=None):
        with span('det.loss'):
            cls_logits, box_deltas = outputs
            labels = labels.to(torch.float32)
            loss, metrics = loss_lib.ssd_loss(
                cls_logits, box_deltas, labels, self.anchors(cls_logits.device),
                negative_ratio=FLAGS.ssd_negative_ratio, pos_threshold=FLAGS.ssd_match_threshold)
            if step is not None:
                # the train step's classification warm-up: w * cls + loc with
                # w = min(step / nb_iters_cls_wmup, 1) in fp32; eval and the
                # compression finetunes' own steps pass no step
                w_cls = min(np.float32(step) / np.float32(FLAGS.nb_iters_cls_wmup), np.float32(1.0))
                loss = float(w_cls) * metrics['cls_loss'] + metrics['loc_loss']
            loss = loss + self.weight_decay_loss(trainable_vars, exclude_bn=True).to(loss.device)
            # proxy accuracy: the share of images whose best-scoring anchor class
            # is among their ground truths
            fg = torch.softmax(cls_logits, dim=-1)[..., 1:]
            best_flat = fg.reshape(fg.shape[0], -1).argmax(dim=1)
            best_cls = best_flat % (self.nb_classes - 1) + 1
            gt_cls = labels[..., 0].to(torch.int32)
            hit = ((gt_cls == best_cls[:, None]) & (labels[..., 5] > 0.5)).any(dim=1)
            return loss, {**metrics, 'accuracy': hit.to(torch.float32).mean()}

    def setup_lrn_rate(self, global_batch_size: int):
        nb_epochs = 120  # SSD-VOC recipe
        nb_smpls = self.dataset_train.spec.nb_smpls_train
        base = schedules.piecewise_constant(global_batch_size, [80, 100], [1.0, 0.1, 0.01],
                                            nb_smpls)
        floor = float(np.float32(FLAGS.lrn_rate_min))
        nb_iters = int(nb_smpls * nb_epochs * FLAGS.nb_epochs_rat / global_batch_size)
        return (lambda step: max(base(step), floor)), nb_iters

    # -- the dump_n_eval protocol ------------------------------------------

    def decode(self, outputs, labels):
        """(class probabilities [B, A, C], boxes [B, A, 4], labels) of a batch
        as host arrays, decoded on the device."""
        cls_logits, box_deltas = outputs
        probs = torch.softmax(cls_logits, dim=-1)
        boxes = anchor_lib.decode_boxes(box_deltas, self.anchors(box_deltas.device))
        return probs.cpu().numpy(), boxes.cpu().numpy(), labels.cpu().numpy()

    def parse(self, probs, boxes):
        return nms_lib.parse_detections(probs, boxes, score_threshold=FLAGS.ssd_score_threshold,
                                        iou_threshold=FLAGS.ssd_nms_threshold)
