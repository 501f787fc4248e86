"""The quantizers of the learners and of int8 serving, as their formulas
read (PocketFlow's uniform quantization and TF's FakeQuantWithMinMaxVars),
in float32 with straight-through gradients."""

from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-10


def _ste(x: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """q in the forward, the identity's gradient to x."""
    return x + (q - x).detach()


def minmax_quantize(x: torch.Tensor, bits: int, per_channel: bool) -> torch.Tensor:
    """alpha = max - min + 1e-10, beta = min, k = 2^bits - 1,
    q = alpha round((x - beta) / alpha k) / k + beta, over the whole tensor
    or over each output channel (the last axis), with the identity's
    gradient."""
    k = torch.tensor(float(2 ** bits - 1), device=x.device)
    if per_channel:
        flat = x.detach().reshape(-1, x.shape[-1])
        hi, lo = flat.amax(dim=0), flat.amin(dim=0)
    else:
        hi, lo = x.detach().max(), x.detach().min()
    alpha = hi - lo + EPS
    q = alpha * (torch.round((x.detach() - lo) / alpha * k) / k) + lo
    return _ste(x, q)


def nudged_range(range_min: torch.Tensor, range_max: torch.Tensor,
                 bits: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FakeQuantWithMinMaxVars' zero-point nudge: (nudged min, nudged max,
    scale)."""
    k = torch.tensor(float(2 ** bits - 1), device=range_min.device)
    scale = (range_max - range_min) / k + EPS
    zero_point = torch.round(torch.clamp(-range_min / scale, min=0.0).minimum(k))
    return -zero_point * scale, (k - zero_point) * scale, scale


def range_quantize(x: torch.Tensor, range_min: torch.Tensor, range_max: torch.Tensor,
                   bits: int) -> torch.Tensor:
    """Clip to the nudged range and round on its grid (half to even); the
    gradient passes where nudged min <= x <= nudged max."""
    nmin, nmax, scale = nudged_range(range_min, range_max, bits)
    xd = x.detach()
    q = torch.round((torch.minimum(torch.maximum(xd, nmin), nmax) - nmin) / scale) * scale + nmin
    mask = ((xd >= nmin) & (xd <= nmax)).to(x.dtype)
    return q + (x - xd) * mask


def symmetric_codes(kernel: torch.Tensor, levels: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel codes of a kernel (last axis out):
    scale = max(|w|, 1e-8) / levels, codes = clamp(round(w / scale),
    -levels, levels), as float32 integers."""
    absmax = kernel.reshape(-1, kernel.shape[-1]).abs().amax(dim=0)
    scale = torch.clamp_min(absmax, 1e-8) / torch.tensor(float(levels), device=kernel.device)
    return torch.clamp(torch.round(kernel / scale), -levels, levels), scale


def symmetric_activation(x: torch.Tensor, x_scale: torch.Tensor, levels: int) -> torch.Tensor:
    """clamp(round(x / x_scale), -levels, levels) as float32 integers."""
    return torch.clamp(torch.round(x / x_scale), -levels, levels)
