"""VGG-16 trunk and the SSD-300 detector (counterpart of pocketflow_tpu/nets/vgg.py).

VGG-16 through conv5_3, a 3x3/s1 'SAME' max-pool, conv6 (3x3, 1024; the JAX
code has no dilation, whatever its docstring says) and conv7 (1x1, 1024),
then extra stride-2 blocks while the map is larger than 1x1 (6 scales at
300x300), and per-scale 3x3 heads of class logits and box deltas.  Module
names are the Flax paths ('vgg/conv4_3', 'l2norm_conv4_3/scale', 'conv8_2',
'cls_head_0'), so quant sites, masks and the bridge resolve by the same
strings.  Every conv is a PFConv, so every compression policy applies.

Initialization: Xavier-uniform (variance_scaling(1, 'fan_avg', 'uniform'))
for the trunk and the extra blocks, normal(0.01) for the heads, zero biases,
the L2Norm scale at 20; drawn from an explicit generator.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch
from torch import nn

from pocketflow_tpu_torch.nn.layers import PFConv, max_pool, relu, set_paths

VGG_STAGES = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


def _xavier_uniform_(kernel: torch.Tensor, generator: Optional[torch.Generator]):
    kh, kw, cin, cout = kernel.shape
    limit = math.sqrt(3.0 / ((kh * kw * cin + kh * kw * cout) / 2.0))
    with torch.no_grad():
        kernel.uniform_(-limit, limit, generator=generator)


def _normal_(kernel: torch.Tensor, std: float, generator: Optional[torch.Generator]):
    with torch.no_grad():
        kernel.normal_(0.0, std, generator=generator)


class VGGBackbone(nn.Module):
    """VGG-16 feature extractor on NCHW input; returns [conv4_3, conv7]."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        in_features = 3
        for stage, (nb_convs, width) in enumerate(VGG_STAGES, start=1):
            for idx in range(nb_convs):
                self.add_module('conv%d_%d' % (stage, idx + 1),
                                PFConv(in_features, width, (3, 3), dtype=dtype))
                in_features = width
        self.conv6 = PFConv(512, 1024, (3, 3), dtype=dtype)
        self.conv7 = PFConv(1024, 1024, (1, 1), dtype=dtype)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for stage, (nb_convs, _) in enumerate(VGG_STAGES, start=1):
            for idx in range(nb_convs):
                x = relu(getattr(self, 'conv%d_%d' % (stage, idx + 1))(x))
            if stage == 4:
                feats.append(x)  # conv4_3, before its pool
            if stage < 5:
                x = max_pool(x, (2, 2), (2, 2), padding='SAME')
            else:
                x = max_pool(x, (3, 3), (1, 1), padding='SAME')
        x = relu(self.conv6(x))
        x = relu(self.conv7(x))
        feats.append(x)
        return feats


class L2Norm(nn.Module):
    """Channel-wise L2 normalization with a learned scale (init 20), in fp32,
    cast back to the input's dtype."""

    def __init__(self, features: int, init_scale: float = 20.0):
        super().__init__()
        self.init_scale = init_scale
        self.scale = nn.Parameter(torch.full((features,), init_scale))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(self.init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.to(torch.float32)
        norm = torch.sqrt(x32.square().sum(dim=1, keepdim=True) + 1e-10)
        return (x32 / norm * self.scale[:, None, None]).to(x.dtype)


def feature_sizes(image_size: int, max_extra_blocks: int = 4) -> List[int]:
    """Spatial sizes of the SSD feature maps for a square input."""
    s = image_size
    for _ in range(3):  # pools after stages 1-3
        s = -(-s // 2)
    conv4 = s
    s = -(-s // 2)      # pool after stage 4 -> conv7 size
    sizes = [conv4, s]
    for _ in range(max_extra_blocks):
        if s <= 1:
            break
        s = -(-s // 2)
        sizes.append(s)
    return sizes


class SSDVGG(nn.Module):
    """SSD detector for square `image_size` inputs: NHWC images ->
    (cls_logits [B, A, nb_classes], box_deltas [B, A, 4]), both fp32."""

    feature_sizes = staticmethod(feature_sizes)

    def __init__(self, image_size: int, nb_classes: int = 21, nb_anchors_per_cell: int = 4,
                 max_extra_blocks: int = 4, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.nb_classes = nb_classes
        self.vgg = VGGBackbone(dtype)
        self.l2norm_conv4_3 = L2Norm(512)
        nb_extra = len(feature_sizes(image_size, max_extra_blocks)) - 2
        widths = [512, 1024]
        in_features = 1024
        self.extras = []
        for idx in range(nb_extra):
            width = 256 if idx == 0 else 128
            self.add_module('conv%d_1' % (8 + idx), PFConv(in_features, width, (1, 1),
                                                           dtype=dtype))
            self.add_module('conv%d_2' % (8 + idx), PFConv(width, width * 2, (3, 3), (2, 2),
                                                           dtype=dtype))
            self.extras.append(('conv%d_1' % (8 + idx), 'conv%d_2' % (8 + idx)))
            in_features = width * 2
            widths.append(in_features)
        k = nb_anchors_per_cell
        for idx, width in enumerate(widths):
            self.add_module('cls_head_%d' % idx, PFConv(width, k * nb_classes, (3, 3), dtype=dtype))
            self.add_module('box_head_%d' % idx, PFConv(width, k * 4, (3, 3), dtype=dtype))
        self.nb_scales = len(widths)
        set_paths(self)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Xavier-uniform trunk and extras, normal(0.01) heads, zero biases,
        L2Norm at its initial scale; drawn in module order."""
        for module in self.modules():
            if isinstance(module, PFConv):
                if '_head_' in module.path:
                    _normal_(module.kernel, 0.01, generator)
                else:
                    _xavier_uniform_(module.kernel, generator)
                with torch.no_grad():
                    module.bias.zero_()
        self.l2norm_conv4_3.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW view
        feats = self.vgg(x)
        feats[0] = self.l2norm_conv4_3(feats[0])
        y = feats[-1]
        for name1, name2 in self.extras:
            y = relu(getattr(self, name1)(y))
            y = relu(getattr(self, name2)(y))
            feats.append(y)
        cls_outs, box_outs = [], []
        b = x.shape[0]
        for idx, feat in enumerate(feats):
            cls = getattr(self, 'cls_head_%d' % idx)(feat)
            box = getattr(self, 'box_head_%d' % idx)(feat)
            cls_outs.append(cls.permute(0, 2, 3, 1).reshape(b, -1, self.nb_classes))
            box_outs.append(box.permute(0, 2, 3, 1).reshape(b, -1, 4))
        return (torch.cat(cls_outs, dim=1).to(torch.float32),
                torch.cat(box_outs, dim=1).to(torch.float32))
