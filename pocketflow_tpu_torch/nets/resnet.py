"""ResNet modules for ILSVRC-12 (counterpart of pocketflow_tpu/nets/resnet.py).

Module names equal the Flax names (``conv_init``, ``stage1_block0/conv1``,
``bn1/bn/scale``, ``fc``), so quant sites, the bridge from JAX parameters and
checkpoints all resolve by the same paths.  Layer calls follow the Flax
order, which fixes both the weight-site order and the 'act/<idx>' ids.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from pocketflow_tpu_torch.nn.layers import (
    BatchNorm, PFConv, PFDense, global_avg_pool, max_pool, relu, set_paths)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.conv1 = PFConv(in_features, features, (3, 3), strides, use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = PFConv(features, features, (3, 3), use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        if tuple(strides) != (1, 1) or in_features != features:
            self.conv_sc = PFConv(in_features, features, (1, 1), strides, use_bias=False,
                                  dtype=dtype)
            self.bn_sc = BatchNorm(features, dtype=dtype)
        else:
            self.conv_sc = None

    def forward(self, x):
        shortcut = x
        y = relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.conv_sc is not None:
            shortcut = self.bn_sc(self.conv_sc(shortcut))
        return relu(y + shortcut)


class BottleneckBlock(nn.Module):
    """Bottleneck of width `features`; the output has 4x as many channels."""
    expansion = 4

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        out = 4 * features
        self.conv1 = PFConv(in_features, features, (1, 1), use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(features, dtype=dtype)
        self.conv2 = PFConv(features, features, (3, 3), strides, use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(features, dtype=dtype)
        self.conv3 = PFConv(features, out, (1, 1), use_bias=False, dtype=dtype)
        self.bn3 = BatchNorm(out, dtype=dtype)
        if tuple(strides) != (1, 1) or in_features != out:
            self.conv_sc = PFConv(in_features, out, (1, 1), strides, use_bias=False, dtype=dtype)
            self.bn_sc = BatchNorm(out, dtype=dtype)
        else:
            self.conv_sc = None

    def forward(self, x):
        shortcut = x
        y = relu(self.bn1(self.conv1(x)))
        y = relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.conv_sc is not None:
            shortcut = self.bn_sc(self.conv_sc(shortcut))
        return relu(y + shortcut)


# block-size table (reference resnet_at_ilsvrc12.py:36-58)
IMAGENET_CONFIGS = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (BottleneckBlock, (3, 4, 6, 3)),
    101: (BottleneckBlock, (3, 4, 23, 3)),
    152: (BottleneckBlock, (3, 8, 36, 3)),
}


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC space-to-depth: [B, H, W, C] -> [B, H/b, W/b, C*b*b]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block, c * block * block)


class ResNetImageNet(nn.Module):
    """ResNet-v1 for ILSVRC-12 (7x7 stem, 4 stages).

    Takes NHWC images, as the JAX model does, and returns fp32 logits.
    ``stem_space_to_depth`` replaces the 7x7/s2 stem conv on 3 channels with a
    4x4/s1 conv on the 2x2 space-to-depth input (12 channels).
    """

    def __init__(self, resnet_size: int = 50, nb_classes: int = 1001,
                 dtype: torch.dtype = torch.bfloat16, stem_space_to_depth: bool = False):
        super().__init__()
        block_cls, stage_sizes = IMAGENET_CONFIGS[resnet_size]
        self.dtype = dtype
        self.stem_space_to_depth = stem_space_to_depth
        if stem_space_to_depth:
            self.conv_init = PFConv(12, 64, (4, 4), (1, 1), use_bias=False, dtype=dtype)
        else:
            self.conv_init = PFConv(3, 64, (7, 7), (2, 2), use_bias=False, dtype=dtype)
        self.bn_init = BatchNorm(64, dtype=dtype)
        in_features = 64
        for stage, nb_blocks in enumerate(stage_sizes):
            width = 64 * (2 ** stage)
            for block in range(nb_blocks):
                strides = (2, 2) if (stage > 0 and block == 0) else (1, 1)
                self.add_module('stage%d_block%d' % (stage + 1, block),
                                block_cls(in_features, width, strides, dtype))
                in_features = width * block_cls.expansion
        self.fc = PFDense(in_features, nb_classes, dtype=dtype)
        set_paths(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Draw every parameter anew, in module order, from `generator`."""
        for module in self.modules():
            if module is not self and hasattr(module, 'reset_parameters'):
                module.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stem_space_to_depth:
            x = space_to_depth(x.to(self.dtype), 2)
        # NHWC -> NCHW view with channels-last strides (no copy)
        x = x.permute(0, 3, 1, 2)
        x = relu(self.bn_init(self.conv_init(x)))
        x = max_pool(x, (3, 3), (2, 2), padding='SAME')
        for name, module in self.named_children():
            if name.startswith('stage'):
                x = module(x)
        x = global_avg_pool(x)
        return self.fc(x).to(torch.float32)
