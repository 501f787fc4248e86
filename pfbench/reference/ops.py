"""The layers of the reference nets, in float32 on NCHW tensors.

``Ops`` holds a run's parameters (the harness's weights, keyed by the
program's state-dict names) and how its layers compute:

* ``train``: BN normalizes with the batch's statistics (mean and biased
  variance over N, H, W), else with the running ones;
* ``weight_fn(path, kernel)``: a recipe's weight transform (fake-quant);
* ``act_fn(index, y)``: a recipe's transform of each activation site's
  output (relu / relu6 in call order, 'act/<index>' in the program);
* ``contraction(path, x, kernel, stride, groups, bias)``: takes over a
  conv or dense product (int8 serving), else F.conv2d / matmul;
* ``precision='fp8'``: the control, the net computed in float8 where the
  program computes in bf16: every tensor the program stores in bf16 is
  stored in float8 (``store``), each under a per-tensor scale: in the
  forward rounded to e4m3, its gradient in the backward to e5m2.  That
  is each product's operands (the kernel and the input) and its output,
  BN's output (so the gradient entering BN's backward), each activation
  site's output before and after the recipe's transform, each residual
  add and each pool; BN's statistics, the loss and the fp32 master
  weights stay in float32, as in the program.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # float8 e4m3's largest value
FP8_GRAD_MAX = 57344.0  # float8 e5m2's


def same_pads(size: int, kernel: int, stride: int):
    """'SAME' padding of one axis: the odd pixel goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, value: float = 0.0) -> torch.Tensor:
    top, bottom = same_pads(x.shape[2], kernel, stride)
    left, right = same_pads(x.shape[3], kernel, stride)
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


def _to_fp8(t: torch.Tensor, dtype, largest: float) -> torch.Tensor:
    """t rounded to float8 `dtype` under a per-tensor scale (amax to the
    format's largest value)."""
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


class _StoreFp8(torch.autograd.Function):
    """A tensor stored in float8 e4m3, its gradient rounded to float8 e5m2,
    as a float8 backward takes it."""

    @staticmethod
    def forward(ctx, t):
        return _to_fp8(t, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _to_fp8(g, torch.float8_e5m2, FP8_GRAD_MAX)


def store_fp8(t: torch.Tensor) -> torch.Tensor:
    return _StoreFp8.apply(t)


class Ops:
    def __init__(self, params: Dict[str, torch.Tensor], train: bool, epsilon: float = 1e-5,
                 weight_fn: Optional[Callable] = None, act_fn: Optional[Callable] = None,
                 contraction: Optional[Callable] = None, precision: str = 'fp32',
                 input_fn: Optional[Callable] = None):
        self.params = params
        self.train = train
        self.epsilon = epsilon
        self.weight_fn = weight_fn
        self.act_fn = act_fn
        self.contraction = contraction
        self.precision = precision
        self.input_fn = input_fn  # (path, x): sees each product's input (calibration)
        self.act_index = 0

    def _kernel(self, path: str) -> torch.Tensor:
        w = self.params[path.replace('/', '.') + '.kernel']
        return self.weight_fn(path, w) if self.weight_fn is not None else w

    def store(self, t: torch.Tensor) -> torch.Tensor:
        """`t` as the run's precision stores it between layers."""
        return store_fp8(t) if self.precision == 'fp8' else t

    def conv(self, path: str, x: torch.Tensor, stride: int,
             depthwise: bool = False) -> torch.Tensor:
        """'SAME' conv of NCHW x with the HWIO kernel at `path`."""
        if self.input_fn is not None:
            self.input_fn(path, x)
        w = self._kernel(path)
        groups = x.shape[1] if depthwise else 1
        if self.contraction is not None:
            y = self.contraction(path, x, w, stride, groups, None)
            if y is not None:
                return y
        x = pad_same(x, w.shape[0], stride)
        x, w = self.store(x), self.store(w)
        return self.store(F.conv2d(x, w.permute(3, 2, 0, 1), stride=stride, groups=groups))

    def dense(self, path: str, x: torch.Tensor) -> torch.Tensor:
        if self.input_fn is not None:
            self.input_fn(path, x)
        w = self._kernel(path)
        bias = self.params.get(path.replace('/', '.') + '.bias')
        if self.contraction is not None:
            y = self.contraction(path, x, w, 1, 1, bias)
            if y is not None:
                return y
        y = self.store(self.store(x) @ self.store(w))
        return y if bias is None else self.store(y + bias)

    def bn(self, path: str, x: torch.Tensor) -> torch.Tensor:
        name = path.replace('/', '.') + '.bn.'
        scale, bias = self.params[name + 'scale'], self.params[name + 'bias']
        if self.train:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
        else:
            mean, var = self.params[name + 'mean'], self.params[name + 'var']
        rstd = torch.rsqrt(var + self.epsilon)
        return self.store((x - mean[:, None, None]) * (rstd * scale)[:, None, None]
                          + bias[:, None, None])

    def act(self, y: torch.Tensor) -> torch.Tensor:
        """An activation site's output through the recipe's transform."""
        index = self.act_index
        self.act_index += 1
        y = self.store(y)
        return self.store(self.act_fn(index, y)) if self.act_fn is not None else y

    def add(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return self.store(a + b)

    def max_pool(self, x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
        """'SAME' max pooling."""
        return self.store(F.max_pool2d(pad_same(x, kernel, stride, float('-inf')), kernel,
                                       stride))

    def mean_pool(self, x: torch.Tensor) -> torch.Tensor:
        """The global average over H and W."""
        return self.store(x.mean(dim=(2, 3)))

    def relu(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(F.relu(x))

    def relu6(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(torch.minimum(F.relu(x), torch.tensor(6.0, device=x.device)))
