"""ResNet-18/34/50 @ ILSVRC-12 (counterpart of pocketflow_tpu/nets/resnet_at_ilsvrc12.py).

Schedule parity: 100 epochs, piecewise LR decays at epochs [30,60,80,90],
weight decay with BN excluded.
"""

from __future__ import annotations

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.datasets.ilsvrc12 import Ilsvrc12Dataset
from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
from pocketflow_tpu_torch.nets.resnet import IMAGENET_CONFIGS, ResNetImageNet

FLAGS.DEFINE_boolean('resnet_stem_s2d', False,
                     'fold the 7x7/s2 stem into a space-to-depth 4x4 conv')


class ModelHelper(AbstractModelHelper):
    """Model helper for ResNet @ ILSVRC-12."""

    model_name = 'resnet'
    dataset_name = 'ilsvrc_12'

    def __init__(self, data_format='channels_last', resnet_size=None):
        super().__init__(data_format)
        # --resnet_size defaults to 20 (resnet_at_cifar10's flag), which has no
        # ILSVRC-12 configuration: name the sizes there are
        self.resnet_size = resnet_size or FLAGS.get('resnet_size') or 50
        if self.resnet_size not in IMAGENET_CONFIGS:
            raise ValueError('resnet_size=%r has no ILSVRC-12 configuration; pass '
                             '--resnet_size with one of %s'
                             % (self.resnet_size, sorted(IMAGENET_CONFIGS)))
        self.model_name = 'resnet_%d' % self.resnet_size
        self.dataset_train = Ilsvrc12Dataset(is_train=True)
        self.dataset_eval = Ilsvrc12Dataset(is_train=False)

    def build_dataset_train(self, enbl_trn_val_split=False):
        return self.dataset_train

    def build_dataset_eval(self):
        return self.dataset_eval

    def create_model(self):
        dtype = torch.bfloat16 if FLAGS.compute_dtype == 'bfloat16' else torch.float32
        return ResNetImageNet(
            resnet_size=self.resnet_size,
            nb_classes=self.dataset_train.spec.nb_classes, dtype=dtype,
            stem_space_to_depth=FLAGS.get('resnet_stem_s2d', False))

    def calc_loss(self, labels, outputs, trainable_vars):
        loss = self.softmax_cross_entropy(labels, outputs)
        loss = loss + 0.5 * self.weight_decay_loss(trainable_vars, exclude_bn=True)
        metrics = {'accuracy': self.accuracy(labels, outputs),
                   'accuracy_top5': self.accuracy(labels, outputs, topk=5)}
        return loss, metrics

    def setup_lrn_rate(self, global_batch_size: int):
        nb_epochs = 100
        nb_smpls_train = self.dataset_train.spec.nb_smpls_train
        schedule = schedules.piecewise_constant(
            global_batch_size, [30, 60, 80, 90],
            [1.0, 0.1, 0.01, 0.001, 0.0001], nb_smpls_train)
        nb_iters = int(nb_smpls_train * nb_epochs * FLAGS.nb_epochs_rat / global_batch_size)
        return schedule, nb_iters
