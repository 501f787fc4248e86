"""MobileNet-v1/v2 (counterpart of pocketflow_tpu/nets/mobilenet.py).

Module names equal the Flax names (``conv_init``, ``bn_init``, ``blockNN/dw``,
``bn_dw``, ``pw``, ``bn_pw``, ``pw_expand``, ``bn_expand``, ``pw_project``,
``bn_project``, ``pw_head``, ``bn_head``, ``logits``; v1 counts its blocks from
``block01``, v2 from ``block00``), so quant sites, the bridge and
``is_maskable_path`` (which skips ``dw*`` kernels) resolve by the same paths.
Layer calls follow the Flax order, which fixes the weight-site order and the
'act/<idx>' ids of the relu6 sites.  ``width_map`` builds the shrunk serving
net as in nets/resnet.py: a depthwise conv's channels follow its producer,
and a MobileNet-v2 block adds its residual where the dense net does.
Under ``--remat_blocks`` (``nn/layers.py:maybe_remat``) v1's separable
blocks and v2's inverted residuals are rematerialized in the backward, as in
the JAX package.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from pocketflow_tpu_torch.nets.resnet import WidthMapped, _w
from pocketflow_tpu_torch.nn.layers import (
    BatchNorm, PFConv, PFDense, PFDepthwiseConv, RematBlock, global_avg_pool, maybe_remat, relu6,
    reset_parameters, set_paths)


def _depth(channels: int, multiplier: float, divisor: int = 8, min_depth: int = 8) -> int:
    """slim's depth-multiplier rounding (multiple of 8, >= min_depth)."""
    channels = channels * multiplier
    new_c = max(min_depth, int(channels + divisor / 2) // divisor * divisor)
    if new_c < 0.9 * channels:  # do not round down by more than 10%
        new_c += divisor
    return int(new_c)


class SeparableBlock(RematBlock):
    """MobileNet-v1 block: 3x3 depthwise + BN + relu6, 1x1 pointwise + BN + relu6."""

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16, width_map=None, path: str = ''):
        super().__init__()
        self.out_features = _w(width_map, path + '/pw', features)
        self.dw = PFDepthwiseConv(in_features, (3, 3), strides, dtype=dtype)
        self.bn_dw = BatchNorm(in_features, dtype=dtype)
        self.pw = PFConv(in_features, self.out_features, (1, 1), use_bias=False, dtype=dtype)
        self.bn_pw = BatchNorm(self.out_features, dtype=dtype)

    def forward(self, x):
        x = relu6(self.bn_dw(self.dw(x)))
        return relu6(self.bn_pw(self.pw(x)))


# (features, stride) per block: the MobileNet-v1 body
V1_BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
             (512, 1), (512, 1), (512, 1), (512, 1), (512, 1),
             (1024, 2), (1024, 1)]


class _MobileNet(WidthMapped, nn.Module):
    """The stem shared by both versions, the NHWC entry and the fp32 logits."""

    def __init__(self, nb_classes: int, depth_mult: float, dtype: torch.dtype,
                 width_map: Optional[Dict[str, int]]):
        super().__init__()
        self.config = dict(nb_classes=nb_classes, depth_mult=depth_mult, dtype=dtype,
                           width_map=width_map)
        self.width_map = width_map
        self.stem = _w(width_map, 'conv_init', _depth(32, depth_mult))
        self.conv_init = PFConv(3, self.stem, (3, 3), (2, 2), use_bias=False, dtype=dtype)
        self.bn_init = BatchNorm(self.stem, dtype=dtype)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def body(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view with channels-last strides
        x = relu6(self.bn_init(self.conv_init(x)))
        return self.logits(global_avg_pool(self.body(x))).to(torch.float32)


class MobileNetV1(_MobileNet):
    """MobileNet-v1: the stem, 13 separable blocks, global average pool and a
    dense classifier (slim's 1x1 conv classifier on the pooled vector)."""

    def __init__(self, nb_classes: int = 1001, depth_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16,
                 width_map: Optional[Dict[str, int]] = None):
        super().__init__(nb_classes, depth_mult, dtype, width_map)
        in_features = self.stem
        for idx, (features, stride) in enumerate(V1_BLOCKS):
            name = 'block%02d' % (idx + 1)
            module = maybe_remat(SeparableBlock(in_features, _depth(features, depth_mult),
                                                (stride, stride), dtype, width_map, name))
            self.add_module(name, module)
            in_features = module.out_features
        self.logits = PFDense(in_features, nb_classes, dtype=dtype)
        set_paths(self)

    def body(self, x):
        for name, module in self.named_children():
            if name.startswith('block'):
                x = module(x)
        return x


class InvertedResidual(RematBlock):
    """MobileNet-v2 block: 1x1 expand + 3x3 depthwise + 1x1 linear project,
    the residual added where the stride is 1 and the widths are equal
    (`residual` overrides that test: the dense net's widths decide it for a
    width-mapped net)."""

    def __init__(self, in_features: int, features: int, strides=(1, 1), expand_ratio: int = 6,
                 dtype: torch.dtype = torch.bfloat16, width_map=None, path: str = '',
                 residual: Optional[bool] = None):
        super().__init__()
        if residual is None:
            residual = tuple(strides) == (1, 1) and in_features == features
        hidden = in_features
        if expand_ratio != 1:
            hidden = _w(width_map, path + '/pw_expand', in_features * expand_ratio)
            self.pw_expand = PFConv(in_features, hidden, (1, 1), use_bias=False, dtype=dtype)
            self.bn_expand = BatchNorm(hidden, dtype=dtype)
        else:
            self.pw_expand = None
        self.out_features = _w(width_map, path + '/pw_project', features)
        self.dw = PFDepthwiseConv(hidden, (3, 3), strides, dtype=dtype)
        self.bn_dw = BatchNorm(hidden, dtype=dtype)
        self.pw_project = PFConv(hidden, self.out_features, (1, 1), use_bias=False, dtype=dtype)
        self.bn_project = BatchNorm(self.out_features, dtype=dtype)
        self.residual = residual

    def forward(self, x):
        y = x
        if self.pw_expand is not None:
            y = relu6(self.bn_expand(self.pw_expand(y)))
        y = relu6(self.bn_dw(self.dw(y)))
        y = self.bn_project(self.pw_project(y))  # linear bottleneck: no activation
        return y + x if self.residual else y


# (expand_ratio, features, repeats, first_stride): the MobileNet-v2 body
V2_BLOCKS = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
             (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(_MobileNet):
    """MobileNet-v2: the stem, 17 inverted residual blocks, a 1x1 head conv
    (1280 wide, not scaled below 1280 for multipliers <= 1), global average
    pool and a dense classifier."""

    def __init__(self, nb_classes: int = 1001, depth_mult: float = 1.0,
                 dtype: torch.dtype = torch.bfloat16,
                 width_map: Optional[Dict[str, int]] = None):
        super().__init__(nb_classes, depth_mult, dtype, width_map)
        in_features, dense_in, idx = self.stem, _depth(32, depth_mult), 0
        for expand, features, repeats, first_stride in V2_BLOCKS:
            features = _depth(features, depth_mult)
            for rep in range(repeats):
                stride = first_stride if rep == 0 else 1
                name = 'block%02d' % idx
                module = maybe_remat(InvertedResidual(
                    in_features, features, (stride, stride), expand, dtype, width_map, name,
                    residual=stride == 1 and dense_in == features))
                self.add_module(name, module)
                in_features, dense_in, idx = module.out_features, features, idx + 1
        head = _w(width_map, 'pw_head', _depth(1280, max(1.0, depth_mult)))
        self.pw_head = PFConv(in_features, head, (1, 1), use_bias=False, dtype=dtype)
        self.bn_head = BatchNorm(head, dtype=dtype)
        self.logits = PFDense(head, nb_classes, dtype=dtype)
        set_paths(self)

    def body(self, x):
        for name, module in self.named_children():
            if name.startswith('block'):
                x = module(x)
        return relu6(self.bn_head(self.pw_head(x)))
