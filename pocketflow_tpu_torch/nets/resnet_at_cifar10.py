"""ResNet-20/32/44/56 @ CIFAR-10 (counterpart of pocketflow_tpu/nets/resnet_at_cifar10.py).

Schedule parity: 250 epochs, piecewise LR decays at epochs [100,150,200] with
rates [1,0.1,0.01,0.001]; weight decay with BN params excluded.
"""

from __future__ import annotations

import torch

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.datasets.cifar10 import Cifar10Dataset
from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
from pocketflow_tpu_torch.nets.resnet import ResNetCifar

FLAGS.DEFINE_integer('resnet_size', 20, '# of layers in the ResNet model')


class ModelHelper(AbstractModelHelper):
    """Model helper for ResNet @ CIFAR-10."""

    model_name = 'resnet'
    dataset_name = 'cifar_10'

    def __init__(self, data_format='channels_last', resnet_size=None):
        super().__init__(data_format)
        self.resnet_size = resnet_size or FLAGS.resnet_size
        if (self.resnet_size - 2) % 6 != 0:
            raise ValueError('resnet_size must be 6n+2, got %d' % self.resnet_size)
        self.model_name = 'resnet_%d' % self.resnet_size
        self.dataset_train = Cifar10Dataset(is_train=True)
        self.dataset_eval = Cifar10Dataset(is_train=False)

    def build_dataset_train(self, enbl_trn_val_split=False):
        return self.dataset_train

    def build_dataset_eval(self):
        return self.dataset_eval

    def create_model(self):
        dtype = torch.bfloat16 if FLAGS.compute_dtype == 'bfloat16' else torch.float32
        return ResNetCifar(nb_blocks=(self.resnet_size - 2) // 6,
                           nb_classes=self.dataset_train.spec.nb_classes, dtype=dtype)

    def calc_loss(self, labels, outputs, trainable_vars):
        loss = self.softmax_cross_entropy(labels, outputs)
        loss = loss + self.weight_decay_loss(trainable_vars, exclude_bn=True)
        return loss, {'accuracy': self.accuracy(labels, outputs)}

    def setup_lrn_rate(self, global_batch_size: int):
        nb_epochs = 250
        nb_smpls_train = self.dataset_train.spec.nb_smpls_train
        schedule = schedules.piecewise_constant(
            global_batch_size, [100, 150, 200], [1.0, 0.1, 0.01, 0.001], nb_smpls_train)
        nb_iters = int(nb_smpls_train * nb_epochs * FLAGS.nb_epochs_rat / global_batch_size)
        return schedule, nb_iters
