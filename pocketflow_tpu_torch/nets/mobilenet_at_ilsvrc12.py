"""MobileNet-v1/v2 @ ILSVRC-12 (counterpart of pocketflow_tpu/nets/mobilenet_at_ilsvrc12.py).

Schedule parity: v1 = 100 epochs, piecewise LR decays at epochs
[30,60,80,90]; v2 = 412 epochs of staircase-exponential decay (0.98^2.5 every
2.5 epochs).  Weight decay 0.5 * 4e-5 with BN excluded; 'accuracy' is top-5,
with acc_top1 and acc_top5 beside it.
"""

from __future__ import annotations

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
from pocketflow_tpu_torch.nets.mobilenet import MobileNetV1, MobileNetV2

FLAGS.DEFINE_integer('mobilenet_version', 1, "MobileNet's version (1 or 2)")
FLAGS.DEFINE_float('mobilenet_depth_mult', 1.0, "MobileNet's depth multiplier")


class ModelHelper(AbstractModelHelper):
    """Model helper for MobileNet @ ILSVRC-12."""

    dataset_name = 'ilsvrc_12'

    def __init__(self, data_format='channels_last', version=None, depth_mult=None):
        super().__init__(data_format)
        self.version = version or FLAGS.mobilenet_version
        if self.version not in (1, 2):
            raise ValueError('mobilenet_version must be 1 or 2, got %r' % (self.version,))
        self.depth_mult = depth_mult or FLAGS.mobilenet_depth_mult
        self.model_name = 'mobilenet_v%d' % self.version
        self.dataset_train = Ilsvrc12Dataset(is_train=True)
        self.dataset_eval = Ilsvrc12Dataset(is_train=False)

    def build_dataset_train(self, enbl_trn_val_split=False):
        return self.dataset_train

    def build_dataset_eval(self):
        return self.dataset_eval

    def create_model(self):
        dtype = torch.bfloat16 if FLAGS.compute_dtype == 'bfloat16' else torch.float32
        cls = MobileNetV1 if self.version == 1 else MobileNetV2
        return cls(nb_classes=self.dataset_train.spec.nb_classes, depth_mult=self.depth_mult,
                   dtype=dtype)

    def calc_loss(self, labels, outputs, trainable_vars):
        loss = self.softmax_cross_entropy(labels, outputs)
        loss = loss + self.weight_decay_loss(trainable_vars, exclude_bn=True, coeff=0.5 * 4e-5)
        acc1 = self.accuracy(labels, outputs)
        acc5 = self.accuracy(labels, outputs, topk=5)
        return loss, {'accuracy': acc5, 'acc_top1': acc1, 'acc_top5': acc5}

    def setup_lrn_rate(self, global_batch_size: int):
        nb_smpls_train = self.dataset_train.spec.nb_smpls_train
        if self.version == 1:
            nb_epochs = 100
            schedule = schedules.piecewise_constant(
                global_batch_size, [30, 60, 80, 90],
                [1.0, 0.1, 0.01, 0.001, 0.0001], nb_smpls_train)
        else:
            nb_epochs = 412
            schedule = schedules.exponential_decay(
                global_batch_size, 2.5, 0.98 ** 2.5, nb_smpls_train)
        nb_iters = int(nb_smpls_train * nb_epochs * FLAGS.nb_epochs_rat / global_batch_size)
        return schedule, nb_iters
