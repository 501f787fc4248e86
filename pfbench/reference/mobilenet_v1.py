"""MobileNet-v1 (Howard et al. 2017, https://arxiv.org/abs/1704.04861) at
depth multiplier 1.0, in slim's layout: a 3x3 stride-2 stem conv, 13
separable blocks (a 3x3 depthwise conv and a 1x1 pointwise conv, each
followed by BN and relu6 = min(max(x, 0), 6)), global average pooling and a
dense classifier.  'SAME' padding, the odd pixel at the end."""

from __future__ import annotations

from typing import Dict

import torch

from pfbench.reference.ops import Ops


def forward(cfg: Dict, ops: Ops, images: torch.Tensor) -> torch.Tensor:
    """Logits of NHWC float32 images."""
    x = images.permute(0, 3, 1, 2)
    layers = cfg['layers']
    x = ops.relu6(ops.bn('bn_init', ops.conv('conv_init', x, layers[0]['s'])))
    for layer in layers[1:-1]:
        block, kind = layer['p'].split('/')
        if kind == 'dw':
            x = ops.relu6(ops.bn(block + '/bn_dw', ops.conv(layer['p'], x, layer['s'],
                                                             depthwise=True)))
        else:
            x = ops.relu6(ops.bn(block + '/bn_pw', ops.conv(layer['p'], x, layer['s'])))
    return ops.dense(layers[-1]['p'], ops.mean_pool(x))
