"""LeNet @ CIFAR-10 (counterpart of pocketflow_tpu/nets/lenet_at_cifar10.py).

Architecture: conv5x5(32)+relu+pool2 -> conv5x5(64)+relu+pool2 -> fc(256)+relu
-> fc(nb_classes); VALID-padded convs: 32 -> 28 -> 14 -> 10 -> 5, so fc3
takes 5*5*64 = 1600 inputs, flattened in H, W, C order as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.datasets.cifar10 import Cifar10Dataset
from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
from pocketflow_tpu_torch.nn.layers import (
    PFConv, PFDense, flatten_hwc, max_pool, relu, reset_parameters, set_paths)


class LeNet(nn.Module):
    """Takes NHWC images [B, 32, 32, 3] and returns fp32 logits."""

    def __init__(self, nb_classes: int = 10, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = PFConv(3, 32, (5, 5), padding='VALID', dtype=dtype)
        self.conv2 = PFConv(32, 64, (5, 5), padding='VALID', dtype=dtype)
        self.fc3 = PFDense(5 * 5 * 64, 256, dtype=dtype)
        self.fc4 = PFDense(256, nb_classes, dtype=dtype)
        set_paths(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view with channels-last strides
        x = max_pool(relu(self.conv1(x)), (2, 2))
        x = max_pool(relu(self.conv2(x)), (2, 2))
        x = relu(self.fc3(flatten_hwc(x)))
        return self.fc4(x).to(torch.float32)


class ModelHelper(AbstractModelHelper):
    """Model helper for LeNet @ CIFAR-10."""

    model_name = 'lenet'
    dataset_name = 'cifar_10'

    def __init__(self, data_format='channels_last'):
        super().__init__(data_format)
        self.dataset_train = Cifar10Dataset(is_train=True)
        self.dataset_eval = Cifar10Dataset(is_train=False)

    def build_dataset_train(self, enbl_trn_val_split=False):
        return self.dataset_train

    def build_dataset_eval(self):
        return self.dataset_eval

    def create_model(self):
        dtype = torch.bfloat16 if FLAGS.compute_dtype == 'bfloat16' else torch.float32
        return LeNet(nb_classes=self.dataset_train.spec.nb_classes, dtype=dtype)

    def calc_loss(self, labels, outputs, trainable_vars):
        loss = self.softmax_cross_entropy(labels, outputs)
        loss = loss + self.weight_decay_loss(trainable_vars, exclude_bn=False)
        return loss, {'accuracy': self.accuracy(labels, outputs)}

    def setup_lrn_rate(self, global_batch_size: int):
        nb_epochs = 250
        nb_smpls_train = self.dataset_train.spec.nb_smpls_train
        schedule = schedules.piecewise_constant(
            global_batch_size, [100, 150, 200], [1.0, 0.1, 0.01, 0.001], nb_smpls_train)
        nb_iters = int(nb_smpls_train * nb_epochs * FLAGS.nb_epochs_rat / global_batch_size)
        return schedule, nb_iters
