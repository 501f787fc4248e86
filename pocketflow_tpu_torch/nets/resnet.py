"""ResNet modules for CIFAR-10 and ILSVRC-12 (counterpart of pocketflow_tpu/nets/resnet.py).

Module names equal the Flax names (``conv_init``, ``stage1_block0/conv1``,
``bn1/bn/scale``, ``fc``), so quant sites, the bridge from JAX parameters and
checkpoints all resolve by the same paths.  Layer calls follow the Flax
order, which fixes both the weight-site order and the 'act/<idx>' ids.

``width_map`` (module path -> output channels, as
``tools/shrink_graph.width_map_from_packed`` gives it) builds the physically
smaller net that serves a channel-shrunk export: every conv takes its
producer's mapped width as its input width.  Whether a block has a shortcut
conv (or, in MobileNet-v2, a residual add) follows the dense net's widths, so
a shrink can never add or drop one.

Under ``--remat_blocks`` (``nn/layers.py:maybe_remat``) the residual blocks
of the CIFAR stages and of the ImageNet trunk, which ResNetImageNet and the
Faster R-CNN backbone share, are rematerialized in the backward, at the JAX
package's places.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from pocketflow_tpu_torch.nn.layers import (
    BatchNorm, PFConv, PFDense, RematBlock, global_avg_pool, max_pool, maybe_remat, relu,
    reset_parameters, set_paths)


def _w(width_map: Optional[Dict[str, int]], path: str, default: int) -> int:
    """The output width of the module at `path` (counterpart of the JAX
    package's ``_w``, keyed by the same full module paths)."""
    return int(width_map.get(path, default)) if width_map else default


class WidthMapped:
    """A net built from keyword arguments kept in ``config``; ``clone``
    builds it again with some of them changed (``width_map=...`` for the
    shrunk serving net, as Flax's ``model.clone``)."""

    def clone(self, **changes) -> nn.Module:
        return type(self)(**{**self.config, **changes})


class BasicBlock(RematBlock):
    """Two 3x3 convs and the shortcut.  `in_features` is the producer's
    width; `projection` (default: a stride or a width change) says whether
    the shortcut is a 1x1 conv."""
    expansion = 1

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16, width_map=None, path: str = '',
                 projection: Optional[bool] = None):
        super().__init__()
        if projection is None:
            projection = tuple(strides) != (1, 1) or in_features != features
        width = _w(width_map, path + '/conv1', features)
        self.out_features = _w(width_map, path + '/conv2', features)
        self.conv1 = PFConv(in_features, width, (3, 3), strides, use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(width, dtype=dtype)
        self.conv2 = PFConv(width, self.out_features, (3, 3), use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(self.out_features, dtype=dtype)
        self.conv_sc = None
        if projection:
            sc = _w(width_map, path + '/conv_sc', self.out_features)
            self.conv_sc = PFConv(in_features, sc, (1, 1), strides, use_bias=False, dtype=dtype)
            self.bn_sc = BatchNorm(sc, dtype=dtype)

    def forward(self, x):
        shortcut = x
        y = relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.conv_sc is not None:
            shortcut = self.bn_sc(self.conv_sc(shortcut))
        return relu(y + shortcut)


class BottleneckBlock(RematBlock):
    """Bottleneck of width `features`; the output has 4x as many channels.
    `in_features` and `projection` as in BasicBlock."""
    expansion = 4

    def __init__(self, in_features: int, features: int, strides=(1, 1),
                 dtype: torch.dtype = torch.bfloat16, width_map=None, path: str = '',
                 projection: Optional[bool] = None):
        super().__init__()
        if projection is None:
            projection = tuple(strides) != (1, 1) or in_features != 4 * features
        w1 = _w(width_map, path + '/conv1', features)
        w2 = _w(width_map, path + '/conv2', features)
        self.out_features = _w(width_map, path + '/conv3', 4 * features)
        self.conv1 = PFConv(in_features, w1, (1, 1), use_bias=False, dtype=dtype)
        self.bn1 = BatchNorm(w1, dtype=dtype)
        self.conv2 = PFConv(w1, w2, (3, 3), strides, use_bias=False, dtype=dtype)
        self.bn2 = BatchNorm(w2, dtype=dtype)
        self.conv3 = PFConv(w2, self.out_features, (1, 1), use_bias=False, dtype=dtype)
        self.bn3 = BatchNorm(self.out_features, dtype=dtype)
        self.conv_sc = None
        if projection:
            sc = _w(width_map, path + '/conv_sc', self.out_features)
            self.conv_sc = PFConv(in_features, sc, (1, 1), strides, use_bias=False, dtype=dtype)
            self.bn_sc = BatchNorm(sc, dtype=dtype)

    def forward(self, x):
        shortcut = x
        y = relu(self.bn1(self.conv1(x)))
        y = relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.conv_sc is not None:
            shortcut = self.bn_sc(self.conv_sc(shortcut))
        return relu(y + shortcut)


class ResNetCifar(WidthMapped, nn.Module):
    """ResNet-(6n+2) for CIFAR: a 3x3 stem, 3 stages of n BasicBlocks at
    widths 16/32/64, global average pool and dense.  Takes NHWC images and
    returns fp32 logits."""

    def __init__(self, nb_blocks: int, nb_classes: int = 10,
                 dtype: torch.dtype = torch.bfloat16,
                 width_map: Optional[Dict[str, int]] = None):
        super().__init__()
        self.config = dict(nb_blocks=nb_blocks, nb_classes=nb_classes, dtype=dtype,
                           width_map=width_map)
        self.width_map = width_map
        in_features = _w(width_map, 'conv_init', 16)
        self.conv_init = PFConv(3, in_features, (3, 3), use_bias=False, dtype=dtype)
        self.bn_init = BatchNorm(in_features, dtype=dtype)
        dense_in = 16
        for stage, width in enumerate((16, 32, 64)):
            for block in range(nb_blocks):
                strides = (2, 2) if (stage > 0 and block == 0) else (1, 1)
                name = 'stage%d_block%d' % (stage + 1, block)
                module = maybe_remat(BasicBlock(
                    in_features, width, strides, dtype, width_map, name,
                    projection=strides != (1, 1) or dense_in != width))
                self.add_module(name, module)
                in_features, dense_in = module.out_features, width
        self.fc = PFDense(in_features, nb_classes, dtype=dtype)
        set_paths(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view with channels-last strides
        x = relu(self.bn_init(self.conv_init(x)))
        for name, module in self.named_children():
            if name.startswith('stage'):
                x = module(x)
        return self.fc(global_avg_pool(x)).to(torch.float32)


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


class ResNetImageNet(WidthMapped, nn.Module):
    """ResNet-v1 for ILSVRC-12 (7x7 stem, 4 stages).

    Takes NHWC images, as the JAX model does, and returns fp32 logits.
    ``stem_space_to_depth`` replaces the 7x7/s2 stem conv on 3 channels with a
    4x4/s1 conv on the 2x2 space-to-depth input (12 channels).
    """

    def __init__(self, resnet_size: int = 50, nb_classes: int = 1001,
                 dtype: torch.dtype = torch.bfloat16, stem_space_to_depth: bool = False,
                 width_map: Optional[Dict[str, int]] = None):
        super().__init__()
        self.config = dict(resnet_size=resnet_size, nb_classes=nb_classes, dtype=dtype,
                           stem_space_to_depth=stem_space_to_depth, width_map=width_map)
        self.width_map = width_map
        in_features = build_imagenet_trunk(self, resnet_size, dtype, width_map,
                                           stem_space_to_depth)[-1]
        self.fc = PFDense(in_features, nb_classes, dtype=dtype)
        set_paths(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        reset_parameters(self, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = global_avg_pool(imagenet_trunk(self, x)[-1])
        return self.fc(x).to(torch.float32)


def build_imagenet_trunk(mdl: nn.Module, resnet_size: int, dtype: torch.dtype,
                         width_map: Optional[Dict[str, int]] = None,
                         stem_space_to_depth: bool = False,
                         nb_stages: Optional[int] = None) -> List[int]:
    """Add the ImageNet stem (``conv_init``, ``bn_init``) and the residual
    stages (``stage<s>_block<b>``, the first `nb_stages` of them) to `mdl`,
    with the JAX package's ``imagenet_trunk`` names, so that ResNetImageNet
    and the Faster R-CNN backbone share them and a classification
    checkpoint grafts into the detector.  Returns each stage's output width;
    ``imagenet_trunk`` runs them."""
    block_cls, stage_sizes = IMAGENET_CONFIGS[resnet_size]
    mdl.dtype = dtype
    mdl.stem_space_to_depth = stem_space_to_depth
    in_features = _w(width_map, 'conv_init', 64)
    if stem_space_to_depth:
        mdl.conv_init = PFConv(12, in_features, (4, 4), (1, 1), use_bias=False, dtype=dtype)
    else:
        mdl.conv_init = PFConv(3, in_features, (7, 7), (2, 2), use_bias=False, dtype=dtype)
    mdl.bn_init = BatchNorm(in_features, dtype=dtype)
    dense_in = 64
    mdl.trunk_stages, widths = [], []
    for stage, nb_blocks in enumerate(stage_sizes[:nb_stages]):
        width = 64 * (2 ** stage)
        names = []
        for block in range(nb_blocks):
            strides = (2, 2) if (stage > 0 and block == 0) else (1, 1)
            name = 'stage%d_block%d' % (stage + 1, block)
            out = width * block_cls.expansion
            module = maybe_remat(block_cls(in_features, width, strides, dtype, width_map, name,
                                           projection=strides != (1, 1) or dense_in != out))
            mdl.add_module(name, module)
            names.append(name)
            in_features, dense_in = module.out_features, out
        mdl.trunk_stages.append(names)
        widths.append(in_features)
    return widths


def imagenet_trunk(mdl: nn.Module, x: torch.Tensor) -> List[torch.Tensor]:
    """The forward of a trunk ``build_imagenet_trunk`` added to `mdl`: NHWC
    images -> each stage's NCHW feature map (stage i at stride 2^(i+2))."""
    if mdl.stem_space_to_depth:
        x = space_to_depth(x.to(mdl.dtype), 2)
    # NHWC -> NCHW view with channels-last strides (no copy)
    x = x.permute(0, 3, 1, 2)
    x = relu(mdl.bn_init(mdl.conv_init(x)))
    x = max_pool(x, (3, 3), (2, 2), padding='SAME')
    feats = []
    for names in mdl.trunk_stages:
        for name in names:
            x = getattr(mdl, name)(x)
        feats.append(x)
    return feats
