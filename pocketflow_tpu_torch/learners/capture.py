"""Capture policy for layerwise regression (counterpart of
pocketflow_tpu/learners/capture.py).

The RL searches need "the outputs of every conv/dense of the full network"
as regression targets.  A `CapturePolicy` records them during a forward, and
with ``stop_input_grads`` detaches every layer's input, so that one summed L2
loss gives each layer its own regression gradient (joint layerwise
regression: every layer trains at once).  It composes with an `inner`
compression policy (the quantization policy of the bit search), whose hooks
run first.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from pocketflow_tpu_torch.nn.layers import CompressionPolicy, compression, recomputing


class CapturePolicy(CompressionPolicy):
    """Records conv/dense outputs during a forward; optionally detaches every
    layer input."""

    def __init__(self, stop_input_grads: bool = False, inner: Optional[CompressionPolicy] = None):
        self.stop_input_grads = stop_input_grads
        self.inner = inner
        self.captured: List[Tuple[str, torch.Tensor]] = []

    def reset_trace(self):
        super().reset_trace()
        if self.inner is not None:
            self.inner.reset_trace()
        self.captured = []

    def prepare(self):
        if self.inner is not None:
            self.inner.prepare()

    def process_weight(self, path, kernel):
        if self.inner is not None:
            kernel = self.inner.process_weight(path, kernel)
        return kernel

    def process_act(self, path, act):
        if self.inner is not None:
            act = self.inner.process_act(path, act)
        # a layer's path: a conv/dense output (a block's recompute captures nothing)
        if not path.startswith('act/') and not recomputing():
            self.captured.append((path, act))
        return act

    def process_input(self, path, x):
        if self.inner is not None:
            x = self.inner.process_input(path, x)
        return x.detach() if self.stop_input_grads else x


def capture_forward_with_output(model: torch.nn.Module, images: torch.Tensor,
                                stop_input_grads: bool = False,
                                inner: Optional[CompressionPolicy] = None, train: bool = False):
    """One forward of `model` (train or eval mode; train mode moves the BN
    running statistics) under a CapturePolicy; returns ([(path, output)] for
    every conv/dense in call order, the model's output)."""
    policy = CapturePolicy(stop_input_grads=stop_input_grads, inner=inner)
    model.train(train)
    with compression(policy):
        out = model(images)
    return policy.captured, out


def capture_forward(model: torch.nn.Module, images: torch.Tensor, stop_input_grads: bool = False,
                    inner: Optional[CompressionPolicy] = None,
                    train: bool = False) -> List[Tuple[str, torch.Tensor]]:
    """[(path, output)] for every conv/dense of one forward, in call order."""
    return capture_forward_with_output(model, images, stop_input_grads, inner, train)[0]


def regression_paths_filter(model_name: str, path: str) -> bool:
    """Which conv/dense outputs are regression targets: MobileNets regress
    only the pointwise and final 1x1 convs, other nets every conv and fc."""
    if model_name.startswith('mobilenet'):
        return ('pw' in path) or ('logits' in path) or ('fc' in path)
    return True
