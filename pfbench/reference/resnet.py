"""ResNet for ILSVRC-12 (He et al. 2016, https://arxiv.org/abs/1512.03385)
in the v1.5 layout: bottleneck blocks of 1x1, 3x3 (carrying the stride)
and 1x1 convs, each followed by BN, ReLU after the first two and after the
residual add; a 1x1 projection with BN on the shortcut of each stage's
first block; a 7x7 stride-2 stem with BN, ReLU and a 3x3 stride-2 max pool,
global average pooling and a dense classifier.  With ``stem_s2d`` the stem
runs as a 4x4 stride-1 conv on the 2x2 space-to-depth input (channel index
2 * 3 * dy + 3 * dx + c), a departure the configuration states.  'SAME'
padding throughout, the odd pixel at the end."""

from __future__ import annotations

from typing import Dict

import torch

from pfbench.reference.ops import Ops


def space_to_depth(x: torch.Tensor, block: int = 2) -> torch.Tensor:
    """NHWC [B, H, W, C] -> [B, H/b, W/b, C b b]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // block, block, w // block, block, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // block, w // block, c * block * block)


def forward(cfg: Dict, ops: Ops, images: torch.Tensor) -> torch.Tensor:
    """Logits of NHWC float32 images."""
    x = images
    if cfg.get('stem_s2d'):
        x = space_to_depth(x, 2)
    x = x.permute(0, 3, 1, 2)
    stem = cfg['layers'][0]
    x = ops.relu(ops.bn('bn_init', ops.conv('conv_init', x, stem['s'])))
    x = ops.max_pool(x, 3, 2)
    for stage, nb_blocks in enumerate(cfg['stage_blocks']):
        for block in range(nb_blocks):
            name = 'stage%d_block%d/' % (stage + 1, block)
            stride = 2 if (stage > 0 and block == 0) else 1
            y = ops.relu(ops.bn(name + 'bn1', ops.conv(name + 'conv1', x, 1)))
            y = ops.relu(ops.bn(name + 'bn2', ops.conv(name + 'conv2', y, stride)))
            y = ops.bn(name + 'bn3', ops.conv(name + 'conv3', y, 1))
            if (name.replace('/', '.') + 'conv_sc.kernel') in ops.params:
                x = ops.bn(name + 'bn_sc', ops.conv(name + 'conv_sc', x, stride))
            x = ops.relu(ops.add(y, x))
    return ops.dense('fc', ops.mean_pool(x))
