"""The reference of int8 serving: symmetric post-training quantization as
its formula reads.  Calibration runs eval forwards in float32 over the
calibration batches and takes each conv and dense layer's input absmax,
the scale max(absmax, 1e-8) / levels; each kernel's codes are symmetric per
output channel; a product quantizes its input with the scale, contracts
the codes (float32, TF32 off), multiplies by x_scale * w_scale and adds the
bias.  BN uses its running statistics.  ``levels`` is 127 for int8, 7 for
the control's int4.  Depthwise convs stay in float (the serving policy's
default).  ``on_site(path, x, y)`` sees each int8 site's input and
output (its bias added), and ``site_forward`` serves one site alone, for
the comparisons site by site."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from pfbench.reference import exact_float32, quant
from pfbench.reference.ops import Ops, pad_same
from pfbench.reference.train import net


def _params(weights: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to(device, torch.float32) for k, v in weights.items()}


@torch.no_grad()
def calibrate(cfg: Dict, weights: Dict[str, torch.Tensor], batches: List[torch.Tensor],
              levels: int = 127) -> Dict[str, float]:
    exact_float32()
    params = _params(weights, batches[0].device)
    absmax: Dict[str, float] = {}

    def record(path, x):
        absmax[path] = max(absmax.get(path, 0.0), float(x.abs().amax()))

    forward = net(cfg)
    for images in batches:
        forward(cfg, Ops(params, train=False, epsilon=cfg['bn_epsilon'], input_fn=record),
                images.to(torch.float32))
    return {path: max(m, 1e-8) / levels for path, m in absmax.items()}


def _site(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
          x_scale: float, stride: int, levels: int) -> torch.Tensor:
    """One int8 site: x quantized with its scale, the kernel's codes, their
    product in float32, rescaled, the bias added."""
    w_codes, w_scale = quant.symmetric_codes(kernel, levels)
    x_scale = torch.tensor(x_scale, dtype=torch.float32, device=x.device)
    xq = quant.symmetric_activation(x, x_scale, levels)
    if w_codes.dim() == 2:
        y = (xq @ w_codes) * (x_scale * w_scale)
    else:
        xq = pad_same(xq, w_codes.shape[0], stride)
        y = F.conv2d(xq, w_codes.permute(3, 2, 0, 1), stride=stride) \
            * (x_scale * w_scale)[:, None, None]
    if bias is not None:
        y = y + (bias if y.dim() == 2 else bias[:, None, None])
    return y


@torch.no_grad()
def site_forward(cfg: Dict, weights: Dict[str, torch.Tensor], x_scales: Dict[str, float],
                 path: str, x: torch.Tensor, levels: int = 127) -> torch.Tensor:
    """The int8 site `path` alone, on the input `x` (NCHW, or [N, C] for the
    dense layer)."""
    exact_float32()
    layer = next(entry for entry in cfg['layers'] if entry['p'] == path)
    key = path.replace('/', '.')
    kernel = weights[key + '.kernel'].to(x.device, torch.float32)
    bias = weights.get(key + '.bias')
    bias = None if bias is None else bias.to(x.device, torch.float32)
    return _site(x.to(torch.float32), kernel, bias, x_scales[path], layer.get('s', 1), levels)


@torch.no_grad()
def forward(cfg: Dict, weights: Dict[str, torch.Tensor], x_scales: Dict[str, float],
            images: torch.Tensor, levels: int = 127,
            on_site: Optional[Callable] = None) -> torch.Tensor:
    """float32 logits of the quantized net on NHWC images."""
    exact_float32()
    params = _params(weights, images.device)

    def contraction(path, x, w, stride, groups, bias):
        if groups > 1:
            return None  # depthwise: float
        y = _site(x, w, bias, x_scales[path], stride, levels)
        if on_site is not None:
            on_site(path, x, y)
        return y

    ops = Ops(params, train=False, epsilon=cfg['bn_epsilon'], contraction=contraction)
    return net(cfg)(cfg, ops, images.to(torch.float32))
