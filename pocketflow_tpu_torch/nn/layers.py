"""Layers with compression interception points (counterpart of
pocketflow_tpu/nn/layers.py).

Learners express themselves as a ``CompressionPolicy`` installed around a
forward pass with ``compression(policy)``: every PFConv/PFDense kernel passes
through ``process_weight`` and every relu output through ``process_act``.  The
policy receives the layer's path, which equals the Flax module path of the JAX
package (``stage1_block0/conv1``), so per-layer bits and masks resolve by the
same strings in both packages.

Layouts: conv kernels are HWIO parameters, dense kernels [in, out], as in the
JAX package.  A policy sees them in that layout (split buckets depend on the
HWIO flattening order); the conv permutes the processed kernel to OIHW for
cuDNN.  Activations are NCHW tensors in the channels-last memory format, which
is the NHWC layout of the JAX package with PyTorch's axis order.  Parameters
are fp32; the compute dtype is a constructor argument (bf16 on the card).
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from pocketflow_tpu_torch.config import FLAGS
from pocketflow_tpu_torch.core import mesh

# ---------------------------------------------------------------------------
# Compression policy context
# ---------------------------------------------------------------------------


class CompressionPolicy:
    """Base (identity) policy; learners subclass and override the hooks."""

    def _next_act_index(self) -> int:
        """Call-order counter for activation sites (reset per forward pass)."""
        idx = getattr(self, '_act_counter', 0)
        self._act_counter = idx + 1
        return idx

    def reset_trace(self):
        self._act_counter = 0

    def process_weight(self, path: str, kernel: torch.Tensor) -> torch.Tensor:
        """Transform a conv/dense kernel before it is used (quant/mask/prune)."""
        return kernel

    def process_act(self, path: str, act: torch.Tensor) -> torch.Tensor:
        """Transform a layer's output activation (activation fake-quant)."""
        return act

    def process_input(self, path: str, x: torch.Tensor) -> torch.Tensor:
        """Transform a layer's input (input-side channel masking)."""
        return x

    def run_contraction(self, path: str, x: torch.Tensor, kernel: torch.Tensor,
                        conv_fn: Callable) -> Optional[torch.Tensor]:
        """Optionally take over a conv/dense contraction (return the output),
        or return None to run the default path."""
        return None


_POLICY_STACK: List[Optional[CompressionPolicy]] = []


@contextlib.contextmanager
def compression(policy: Optional[CompressionPolicy]):
    """Install `policy` for the duration of a forward pass."""
    if policy is not None:
        policy.reset_trace()
    _POLICY_STACK.append(policy)
    try:
        yield policy
    finally:
        _POLICY_STACK.pop()


def current_policy() -> Optional[CompressionPolicy]:
    return _POLICY_STACK[-1] if _POLICY_STACK else None


def relu(x: torch.Tensor) -> torch.Tensor:
    """ReLU with a post-activation interception point; activation sites are
    'act/<idx>' in call order."""
    y = F.relu(x)
    policy = current_policy()
    if policy is not None:
        y = policy.process_act('act/%d' % policy._next_act_index(), y)
    return y


_SIX = torch.tensor(6.0)  # a CPU scalar: promotes like a Python number, on any device


def relu6(x: torch.Tensor) -> torch.Tensor:
    """min(relu(x), 6) as the JAX package computes it: at x = 6 the minimum
    passes half the gradient (a clamp would pass all of it)."""
    y = torch.minimum(F.relu(x), _SIX)
    policy = current_policy()
    if policy is not None:
        y = policy.process_act('act/%d' % policy._next_act_index(), y)
    return y


def set_paths(root: nn.Module):
    """Give every PF layer under `root` its Flax-style path ('a/b/c');
    PFDepthwiseConv is a PFConv."""
    for name, module in root.named_modules():
        if isinstance(module, (PFConv, PFDense)):
            module.path = name.replace('.', '/')


def reset_parameters(root: nn.Module, generator: Optional[torch.Generator] = None):
    """Draw every parameter under `root` anew, in module order, from `generator`."""
    for module in root.modules():
        if module is not root and hasattr(module, 'reset_parameters'):
            module.reset_parameters(generator)


# ---------------------------------------------------------------------------
# Initializers (flax.linen.initializers, drawn from an explicit generator)
# ---------------------------------------------------------------------------

def variance_scaling_(tensor: torch.Tensor, scale: float, mode: str, fan_in: int, fan_out: int,
                      generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """variance_scaling(scale, mode, 'truncated_normal'): a normal truncated
    at two standard deviations, rescaled to the target variance."""
    fan = fan_out if mode == 'fan_out' else fan_in
    std = math.sqrt(scale / max(1, fan)) / .87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def _same_pads(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """'SAME' padding of one spatial axis: the odd pixel goes at the end."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def same_pad(x: torch.Tensor, kernel: Sequence[int], strides: Sequence[int],
             value: float = 0.0) -> torch.Tensor:
    """Pad an NCHW tensor for a 'SAME' window (asymmetric where JAX is)."""
    (top, bottom) = _same_pads(x.shape[2], kernel[0], strides[0])
    (left, right) = _same_pads(x.shape[3], kernel[1], strides[1])
    if top == bottom == left == right == 0:
        return x
    return F.pad(x, (left, right, top, bottom), value=value)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


class PFConv(nn.Module):
    """2D convolution with weight/activation interception; 'SAME' or
    'VALID' padding.

    The kernel is an HWIO fp32 parameter; variance_scaling(2.0, 'fan_out')
    initialization as in the JAX package.
    """

    def __init__(self, in_features: int, features: int, kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16, padding: str = 'SAME'):
        super().__init__()
        if padding not in ('SAME', 'VALID'):
            raise ValueError('unknown padding %r' % (padding,))
        self.kernel_size = tuple(kernel_size)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype
        self.path = ''
        self.kernel = nn.Parameter(torch.empty(*self.kernel_size, in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        kh, kw, cin, cout = self.kernel.shape
        variance_scaling_(self.kernel, 2.0, 'fan_out', kh * kw * cin, kh * kw * cout, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    def conv_fn(self, x: torch.Tensor, kernel: torch.Tensor,
                acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The convolution of NCHW `x` with the HWIO `kernel`.  With
        `acc_dtype` (torch.int32), x and kernel hold int8 codes and the sums
        are exact int32 accumulators (ops/int8_ops.py), as JAX's
        ``preferred_element_type``."""
        if acc_dtype is not None:
            from pocketflow_tpu_torch.ops.int8_ops import int8_conv2d
            return int8_conv2d(x, kernel, self.strides, self.padding)
        if self.padding == 'SAME':
            x = same_pad(x, self.kernel_size, self.strides)
        return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=self.strides)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel
        policy = current_policy()
        y = None
        if policy is not None:
            x = policy.process_input(self.path, x)
            kernel = policy.process_weight(self.path, kernel)
            y = policy.run_contraction(self.path, x, kernel, self.conv_fn)
        if y is None:
            y = self.conv_fn(x.to(self.dtype), kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        if policy is not None:
            y = policy.process_act(self.path, y)
        return y.to(self.dtype)


class PFDepthwiseConv(PFConv):
    """Depthwise 2D convolution (channel multiplier 1), as in MobileNet.

    The kernel is an HWIO parameter of shape (kh, kw, 1, channels), the JAX
    package's layout, so the bridge and the channel-bucket view ([kh*kw,
    channels]) match; variance_scaling(2.0, 'fan_out') reads fan_out as
    kh*kw*channels, as Flax does for this shape.  The forward is a grouped
    cuDNN conv on the permuted kernel.
    """

    def __init__(self, channels: int, kernel_size: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1), use_bias: bool = False,
                 dtype: torch.dtype = torch.bfloat16, padding: str = 'SAME'):
        super().__init__(1, channels, kernel_size, strides, use_bias, dtype, padding)

    def conv_fn(self, x: torch.Tensor, kernel: torch.Tensor,
                acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        if acc_dtype is not None:
            from pocketflow_tpu_torch.ops.int8_ops import int8_conv2d
            return int8_conv2d(x, kernel, self.strides, self.padding, groups=x.shape[1])
        if self.padding == 'SAME':
            x = same_pad(x, self.kernel_size, self.strides)
        return F.conv2d(x, kernel.permute(3, 2, 0, 1), stride=self.strides,
                        groups=kernel.shape[-1])


class PFDense(nn.Module):
    """Dense layer with weight/activation interception; kernel [in, out],
    lecun_normal initialization."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.path = ''
        self.kernel = nn.Parameter(torch.empty(in_features, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        cin, cout = self.kernel.shape
        variance_scaling_(self.kernel, 1.0, 'fan_in', cin, cout, generator)
        if self.bias is not None:
            with torch.no_grad():
                self.bias.zero_()

    @staticmethod
    def dense_fn(x: torch.Tensor, kernel: torch.Tensor,
                 acc_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """x @ kernel; with `acc_dtype` as PFConv.conv_fn."""
        if acc_dtype is not None:
            from pocketflow_tpu_torch.ops.int8_ops import int8_matmul
            out = int8_matmul(x.reshape(-1, x.shape[-1]), kernel)
            return out.reshape(*x.shape[:-1], kernel.shape[-1])
        return x @ kernel

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel = self.kernel
        policy = current_policy()
        y = None
        if policy is not None:
            x = policy.process_input(self.path, x)
            kernel = policy.process_weight(self.path, kernel)
            y = policy.run_contraction(self.path, x, kernel, self.dense_fn)
        if y is None:
            y = self.dense_fn(x.to(self.dtype), kernel.to(self.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        if policy is not None:
            y = policy.process_act(self.path, y)
        return y.to(self.dtype)


class _BNVariables(nn.Module):
    """The variables of one BN (the Flax ``bn`` submodule): scale and bias
    parameters, running mean and variance buffers."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('mean', torch.zeros(features))
        self.register_buffer('var', torch.ones(features))

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        with torch.no_grad():
            self.scale.fill_(1.0)
            self.bias.zero_()
            self.mean.zero_()
            self.var.fill_(1.0)


def _channel_sums(*tensors: torch.Tensor) -> torch.Tensor:
    """Each NCHW tensor summed over all but the channel axis, concatenated."""
    return torch.cat([t.sum(dim=(0, 2, 3)) for t in tensors])


class _SyncBatchNorm(torch.autograd.Function):
    """Train-mode BN over the global batch of all ranks (exact sync-BN).

    Forward: the local fp32 (or wider) sums of x and x^2 and the count in
    one buffer, one all-reduce, then Flax's statistics (mean, biased variance
    max(0, E[x^2] - mean^2)) and y = (x - mean) * rstd * scale + bias in
    fp32, cast to the compute dtype.  Backward: one all-reduce of the sums of
    dy and dy * x_hat; the input's gradient takes the global sums, the scale's
    and bias's gradients the local ones (the gradient all-reduce of the step
    averages them).  ``torch.nn.SyncBatchNorm`` does not run on the CPU and
    moves the running variance with the unbiased estimate."""

    @staticmethod
    def forward(ctx, x, scale, bias, epsilon, dtype):
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        c = x.shape[1]
        packed = torch.cat([_channel_sums(x32, x32.square()),
                            x32.new_full((1,), x32.numel() // c)])
        mesh.all_reduce_sum_(packed)
        count = packed[2 * c:]
        mean = packed[:c] / count
        var = torch.clamp(packed[c:2 * c] / count - mean.square(), min=0.0)
        rstd = torch.rsqrt(var + epsilon)
        y = ((x32 - mean[:, None, None]) * (rstd * scale)[:, None, None]
             + bias[:, None, None]).to(dtype)
        ctx.save_for_backward(x, scale, mean, rstd, count)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, scale, mean, rstd, count = ctx.saved_tensors
        c = x.shape[1]
        dy32 = dy.to(mean.dtype)
        x_hat = (x.to(mean.dtype) - mean[:, None, None]) * rstd[:, None, None]
        local = _channel_sums(dy32, dy32 * x_hat)
        total = mesh.all_reduce_sum_(local.clone())
        dx = (dy32 - (total[:c] / count)[:, None, None]
              - x_hat * (total[c:] / count)[:, None, None]) * (scale * rstd)[:, None, None]
        return dx.to(x.dtype), local[c:], local[:c], None, None


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks, whose gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t):
        return mesh.all_reduce_sum_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return mesh.all_reduce_sum_(g.clone())


class BatchNorm(nn.Module):
    """Batch normalization over the channel axis of NCHW tensors.

    Train mode normalizes with the batch statistics, taken in fp32 whatever
    the compute dtype, and moves the running statistics as Flax does:
    ``ra = momentum * ra + (1 - momentum) * batch`` with the BIASED batch
    variance (``nn.BatchNorm2d`` would use the unbiased one).  Eval mode
    normalizes with the running statistics.  ``--bn_stats_subsample=S`` takes
    the statistics from the leading 1/S of the batch (ghost-BN).

    Under data parallelism the batch is the global one: the statistics are
    all-reduced (``_SyncBatchNorm``; ghost-BN takes the leading
    batch // S samples of each rank's rows, as the JAX package takes them of
    each data shard).  At world size 1 no collective runs.
    """

    def __init__(self, features: int, momentum: float = 0.997, epsilon: float = 1e-5,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        self.dtype = dtype
        self.bn = _BNVariables(features)

    def _update_running(self, mean: torch.Tensor, var: torch.Tensor):
        with torch.no_grad():
            self.bn.mean.mul_(self.momentum).add_((1.0 - self.momentum) * mean)
            self.bn.var.mul_(self.momentum).add_((1.0 - self.momentum) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.bn
        if not self.training:
            return torch.native_batch_norm(x.to(self.dtype), v.scale, v.bias, v.mean, v.var,
                                           False, 0.0, self.epsilon)[0]
        sub = int(FLAGS.get('bn_stats_subsample') or 1)
        world = mesh.num_workers()
        if sub <= 1 or x.shape[0] * world < 2 * sub:
            if world > 1:
                y, mean, var = _SyncBatchNorm.apply(x, v.scale, v.bias, self.epsilon,
                                                    self.dtype)
                self._update_running(mean, var)
                return y
            # one fused pass: output, batch mean and 1/sqrt(biased var + eps)
            y, mean, invstd = torch.native_batch_norm(
                x.to(self.dtype), v.scale, v.bias, None, None, True, 0.0, self.epsilon)
            self._update_running(mean, invstd.detach().double().pow(-2).sub(self.epsilon).float())
            return y
        return self._ghost(x, sub, world)

    def _ghost(self, x: torch.Tensor, sub: int, world: int) -> torch.Tensor:
        """Statistics from the leading batch // S samples of this rank's rows
        (at world size W, of each rank's, all-reduced), normalization in the
        compute dtype as in the JAX package."""
        v = self.bn
        if world == 1:
            xs = x[:x.shape[0] // sub].to(torch.float32)
            mean = xs.mean(dim=(0, 2, 3))
            var = xs.square().mean(dim=(0, 2, 3)) - mean.square()
        else:
            xs = x[:max(1, x.shape[0] // sub)].to(torch.float32)
            c = x.shape[1]
            packed = _AllReduceSum.apply(torch.cat([
                _channel_sums(xs, xs.square()), xs.new_full((1,), xs.numel() // c)]))
            mean = packed[:c] / packed[2 * c:]
            var = packed[c:2 * c] / packed[2 * c:] - mean.square()
        self._update_running(mean.detach(), var.detach())
        rstd = torch.rsqrt(var + self.epsilon)
        inv = (rstd * v.scale).to(self.dtype)
        shift = (v.bias - mean * rstd * v.scale).to(self.dtype)
        return x.to(self.dtype) * inv[:, None, None] + shift[:, None, None]


def max_pool(x: torch.Tensor, window: Tuple[int, int] = (2, 2),
             strides: Optional[Tuple[int, int]] = None, padding: str = 'VALID') -> torch.Tensor:
    strides = strides or window
    if padding == 'SAME':
        x = same_pad(x, window, strides, value=float('-inf'))
    elif padding != 'VALID':
        raise ValueError('unknown padding %r' % padding)
    return F.max_pool2d(x, window, strides)


def avg_pool(x: torch.Tensor, window: Tuple[int, int] = (2, 2),
             strides: Optional[Tuple[int, int]] = None, padding: str = 'VALID') -> torch.Tensor:
    """Average pooling; 'SAME' pads with zeros that count in the mean, as
    Flax's avg_pool does."""
    strides = strides or window
    if padding == 'SAME':
        x = same_pad(x, window, strides)
    elif padding != 'VALID':
        raise ValueError('unknown padding %r' % padding)
    return F.avg_pool2d(x, window, strides)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    return x.mean(dim=(2, 3))


def flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten NCHW activations to [B, H*W*C] in H, W, C order: the order in
    which the JAX package flattens its NHWC activations, so that a dense
    kernel's rows line up with it."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
