"""Tutorial: bring your own model and dataset to the PyTorch port
(counterpart of examples/self_defined_convnet.py).

Define (1) a dataset, (2) a model built from the port's PF layers (so that
every compression learner can intercept its kernels and activations), and
(3) a ModelHelper binding them; then any learner from ``create_learner``
works unchanged.

Run (on the card; ``main(argv, device='cpu')`` runs it on the CPU):
    python -m pocketflow_tpu_torch.examples.self_defined_convnet --learner=weight-sparse \\
        --ws_prune_ratio_prtl=uniform --ws_prune_ratio=0.5 --synthetic_data
"""

import sys
from typing import Optional

import torch
from torch import nn

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import schedules
from pocketflow_tpu_torch.datasets.abstract import AbstractDataset, DatasetSpec
from pocketflow_tpu_torch.learners import create_learner
from pocketflow_tpu_torch.nets.abstract_model_helper import AbstractModelHelper
from pocketflow_tpu_torch.nn.layers import (
    PFConv, PFDense, flatten_hwc, max_pool, relu, reset_parameters, set_paths)


# -- 1. the dataset -----------------------------------------------------------

class MyDataset(AbstractDataset):
    """16x16 grayscale, 4 classes; synthetic."""

    SPEC = DatasetSpec(
        name='mydata', nb_classes=4,
        nb_smpls_train=2048, nb_smpls_val=256, nb_smpls_eval=512,
        batch_size=32, batch_size_eval=32, image_shape=(16, 16, 1))

    def _load_arrays(self):
        return self.synthesize_arrays()


# -- 2. the model (PF layers => compression-ready) ----------------------------

class MyConvNet(nn.Module):
    """NHWC images [B, 16, 16, 1] -> fp32 logits; 'SAME' convs, 16 -> 8 -> 4,
    so fc takes 4 * 4 * 32 inputs in H, W, C order."""

    def __init__(self, nb_classes: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = PFConv(1, 16, (3, 3), dtype=dtype)
        self.conv2 = PFConv(16, 32, (3, 3), dtype=dtype)
        self.fc = PFDense(4 * 4 * 32, nb_classes, dtype=dtype)
        set_paths(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view with channels-last strides
        x = max_pool(relu(self.conv1(x)), (2, 2))
        x = max_pool(relu(self.conv2(x)), (2, 2))
        return self.fc(flatten_hwc(x)).to(torch.float32)


# -- 3. the helper ------------------------------------------------------------

class ModelHelper(AbstractModelHelper):
    model_name = 'myconvnet'
    dataset_name = 'mydata'

    def __init__(self):
        super().__init__()
        self.dataset_train = MyDataset(is_train=True)
        self.dataset_eval = MyDataset(is_train=False)

    def build_dataset_train(self, enbl_trn_val_split=False):
        return self.dataset_train

    def build_dataset_eval(self):
        return self.dataset_eval

    def create_model(self):
        return MyConvNet(nb_classes=self.dataset_train.spec.nb_classes)

    def calc_loss(self, labels, outputs, trainable_vars):
        loss = self.softmax_cross_entropy(labels, outputs)
        loss = loss + self.weight_decay_loss(trainable_vars, exclude_bn=False)
        return loss, {'accuracy': self.accuracy(labels, outputs)}

    def setup_lrn_rate(self, global_batch_size):
        nb_smpls = self.dataset_train.spec.nb_smpls_train
        schedule = schedules.piecewise_constant(
            global_batch_size, [10, 20], [1.0, 0.1, 0.01], nb_smpls)
        nb_iters = int(nb_smpls * 30 * FLAGS.nb_epochs_rat / global_batch_size)
        return schedule, nb_iters


def main(argv=None, device='cuda'):
    """Train or evaluate (--exec_mode) the learner chosen by --learner on
    `device`; returns the learner."""
    from pocketflow_tpu_torch.main import register_flags
    register_flags()  # every learner's flags, before parsing
    leftovers = FLAGS.parse_args(sys.argv[1:] if argv is None else list(argv))
    if any(arg.startswith('-') for arg in leftovers):
        raise SystemExit('unrecognized flags %r (see --help)' % leftovers)
    learner = create_learner(None, ModelHelper(), device=device)
    if FLAGS.exec_mode == 'train':
        learner.train()
    else:
        learner.evaluate()
    return learner


if __name__ == '__main__':
    main()
