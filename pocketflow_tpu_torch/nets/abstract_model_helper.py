"""Abstract model helper — the contract between nets and learners
(counterpart of pocketflow_tpu/nets/abstract_model_helper.py).

* ``build_dataset_train/eval``  -> AbstractDataset objects (host pipelines),
* ``create_model``              -> an ``nn.Module`` taking NHWC images,
* ``forward_train/forward_eval``-> the forward pass under a compression policy
                                   (train mode moves the BN running statistics
                                   in place),
* ``calc_loss``                 -> (labels, outputs, named params) -> loss, metrics,
* ``setup_lrn_rate``            -> (schedule fn, nb_iters).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression, model_sum


class AbstractModelHelper(ABC):
    """Binds a network to a dataset; see the module docstring for the contract."""

    model_name: str = 'model'
    dataset_name: str = 'dataset'

    def __init__(self, data_format: str = 'channels_last', forward_w_labels: bool = False):
        if data_format != 'channels_last':
            raise ValueError('the port runs channels_last only, got %r' % data_format)
        self.data_format = data_format
        self.forward_w_labels = forward_w_labels

    # -- dataset ---------------------------------------------------------

    @abstractmethod
    def build_dataset_train(self):
        """Return the training AbstractDataset."""

    @abstractmethod
    def build_dataset_eval(self):
        """Return the evaluation AbstractDataset."""

    # -- model -----------------------------------------------------------

    @abstractmethod
    def create_model(self) -> torch.nn.Module:
        """Return the module implementing the forward pass (not initialized)."""

    def forward_train(self, model: torch.nn.Module, inputs: torch.Tensor,
                      policy: Optional[CompressionPolicy] = None, labels=None) -> torch.Tensor:
        """Training forward pass; BN running statistics move in place."""
        del labels  # classification nets ignore labels in forward
        model.train()
        with compression(policy):
            return model(inputs)

    def forward_eval(self, model: torch.nn.Module, inputs: torch.Tensor,
                     policy: Optional[CompressionPolicy] = None) -> torch.Tensor:
        """Evaluation forward pass (running statistics, no state change)."""
        model.eval()
        with compression(policy):
            return model(inputs)

    # -- loss / schedule ---------------------------------------------------

    @abstractmethod
    def calc_loss(self, labels, outputs, trainable_vars) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Loss value and extra metrics."""

    @abstractmethod
    def setup_lrn_rate(self, global_batch_size: int):
        """Return (lr schedule fn, nb_iters)."""

    def warm_start(self, state):
        """Initialize the model for warm-start (backbone restore); optional."""
        return state

    # -- shared loss pieces --------------------------------------------------

    @staticmethod
    def softmax_cross_entropy(labels: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
        """Mean softmax CE over the batch; labels are int class ids."""
        return F.cross_entropy(logits.to(torch.float32), labels.long())

    @staticmethod
    def accuracy(labels: torch.Tensor, logits: torch.Tensor, topk: int = 1) -> torch.Tensor:
        labels = labels.long()
        if topk == 1:
            return (logits.argmax(-1) == labels).to(torch.float32).mean()
        top = logits.to(torch.float32).topk(topk, dim=-1).indices
        return (top == labels[:, None]).any(-1).to(torch.float32).mean()

    @staticmethod
    def weight_decay_loss(named_params: Iterable[Tuple[str, torch.Tensor]],
                          exclude_bn: bool = True, coeff: Optional[float] = None) -> torch.Tensor:
        """L2 weight decay over kernels; with `exclude_bn`, every path that
        contains 'bn' is skipped.  `named_params` yields ('a/b/kernel', tensor)
        pairs; `coeff` overrides FLAGS.loss_w_dcy.  A tensor-parallel shard's
        squares are summed over the model group (one all-reduce for all of
        them), so the term is the full kernels' on every rank."""
        leaves = [leaf for path, leaf in named_params if path.split('/')[-1] == 'kernel'
                  and not (exclude_bn and any('bn' in key for key in path.split('/')))]
        squares = [leaf.to(torch.float32).square().sum() for leaf in leaves
                   if not isinstance(leaf, mesh.ModelShard)]
        shards = [leaf.to(torch.float32).square().sum() for leaf in leaves
                  if isinstance(leaf, mesh.ModelShard)]
        if shards:
            squares.append(model_sum(torch.stack(shards).sum()))
        total = torch.stack(squares).sum() if squares else torch.zeros(())
        return (FLAGS.loss_w_dcy if coeff is None else coeff) * total
