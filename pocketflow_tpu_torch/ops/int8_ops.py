"""Int8 serving: symmetric post-training quantization and int8 contractions
(counterpart of pocketflow_tpu/ops/int8_ops.py).

    xq = clip(round(x / sx), -127, 127)  int8,  wq = round(w / sw_c)  int8 (per out-channel)
    y  = float(contract(xq, wq -> int32)) * (sx * sw_c)

Weights quantize offline (symmetric per output channel, 127 levels);
activation scales come from a calibration pass that records each layer's
input absmax over a few batches.  `Int8ServingPolicy` plugs these into the
model through the layers' ``run_contraction`` hook: the same module serves
fp32, bf16 or int8.

The contraction is exact on both devices, so the int32 accumulators on the
card equal the CPU's (and JAX's) bit for bit:

* a product is ``torch._int_mm`` (cuBLASLt's int8 GEMM on the card).  On
  the card it takes M > 16 and K a multiple of 8; on an H100 cuBLASLt
  refuses (CUBLAS_STATUS_NOT_SUPPORTED) a row-major B at most shapes, and an
  N of 8 mod 16 from 40 up at K = 16, 32, 64 or 96 (probed over every N up
  to 1024).  ``int8_matmul`` pads with zero rows and columns to M > 16, K a
  multiple of 8 and N of 16 (zeros add nothing to an int32 sum), hands B
  over as the transpose of an [N, K] tensor, and slices the result back, on
  both devices, so the CPU tests cover the same path;
* a spatial conv is an im2col of the int8 codes: ``Tensor.unfold`` views the
  padded codes as windows (a view works for any dtype, where ``F.unfold``
  and cuDNN take no int8), one int8 copy lays them out as rows in the
  kernel's H, W, C order, and ``int8_matmul`` contracts them.  A 1x1
  stride-1 conv is a reshape only.  'SAME' padding goes in after the
  quantization, as code 0, with the asymmetric split of ``same_pad``;
* a depthwise conv (only when the policy does not skip it) sums its taps in
  float32, exact: every partial sum is an integer below 2^24.

Op order follows the reference: x / sx is a division by a tensor on x's
device (PyTorch's CUDA division by a CPU scalar multiplies by the
reciprocal, which moves .5 boundaries), round is half to even, and the
output scale is sx * sw_c, multiplied first.
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import torch
import torch.nn.functional as F

from pocketflow_tpu_torch.nn.layers import (
    CompressionPolicy, PFConv, PFDense, compression, same_pad)

_LEVELS = 127.0


def quantize_weights_symmetric(kernel: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: (codes int8, scale [c_out] float32)."""
    k32 = kernel.detach().to(torch.float32)
    absmax = k32.reshape(-1, k32.shape[-1]).abs().amax(dim=0)
    scale = torch.clamp_min(absmax, 1e-8) / torch.tensor(_LEVELS, device=absmax.device)
    codes = torch.clamp(torch.round(k32 / scale), -127, 127).to(torch.int8)
    return codes, scale


def int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, K] int8 @ b [K, N] int8 -> [M, N] int32 accumulators, padded to
    what ``torch._int_mm`` takes on the card (M > 16, K a multiple of 8, N
    of 16, B column-major)."""
    if a.dtype != torch.int8 or b.dtype != torch.int8:
        raise TypeError('int8_matmul takes int8 operands, got %s and %s' % (a.dtype, b.dtype))
    m, k = a.shape
    n = b.shape[1]
    k_pad, n_pad, m_pad = -k % 8, -n % 16, max(17 - m, 0)
    if k_pad or m_pad:
        a = F.pad(a, (0, k_pad, 0, m_pad))
    if k_pad or n_pad:
        b = F.pad(b, (0, n_pad, 0, k_pad))
    acc = torch._int_mm(a.contiguous(), b.t().contiguous().t())
    return acc[:m, :n] if (m_pad or n_pad) else acc


def int8_conv2d(xq: torch.Tensor, codes: torch.Tensor, strides=(1, 1), padding: str = 'SAME',
                groups: int = 1) -> torch.Tensor:
    """Exact int32 convolution of NCHW int8 codes `xq` with HWIO int8 `codes`
    (the layer's strides and padding); returns NCHW int32 (a channels-last
    view).  ``groups`` is 1 or, for a depthwise kernel (I == 1), the input's
    channel count."""
    kh, kw, cin, cout = codes.shape
    sh, sw = strides
    if padding == 'SAME':
        xq = same_pad(xq, (kh, kw), strides)
    elif padding != 'VALID':
        raise ValueError('unknown padding %r' % (padding,))
    n, c, h, w = xq.shape
    ho, wo = (h - kh) // sh + 1, (w - kw) // sw + 1
    if groups != 1:
        if cin != 1 or groups != c or cout % c:
            raise ValueError('int8_conv2d: groups=%d with a %s kernel on %d channels'
                             % (groups, tuple(codes.shape), c))
        return _depthwise(xq, codes, strides, ho, wo)
    if (kh, kw, sh, sw) == (1, 1, 1, 1):
        rows = xq.permute(0, 2, 3, 1).reshape(-1, c)
    else:
        windows = xq.unfold(2, kh, sh).unfold(3, kw, sw)  # [N, C, Ho, Wo, kh, kw], a view
        rows = windows.permute(0, 2, 3, 4, 5, 1).reshape(n * ho * wo, kh * kw * c)
    acc = int8_matmul(rows, codes.reshape(kh * kw * cin, cout))
    return acc.reshape(n, ho, wo, cout).permute(0, 3, 1, 2)


def _depthwise(xq, codes, strides, ho, wo):
    """Depthwise int8 conv, the taps summed in float32 (exact below 2^24)."""
    kh, kw, _, cout = codes.shape
    sh, sw = strides
    mult = cout // xq.shape[1]
    acc = None
    for i in range(kh):
        for j in range(kw):
            tap = xq[:, :, i:i + sh * (ho - 1) + 1:sh, j:j + sw * (wo - 1) + 1:sw].to(torch.float32)
            if mult > 1:
                tap = tap.repeat_interleave(mult, dim=1)
            term = tap * codes[i, j, 0].to(torch.float32)[:, None, None]
            acc = term if acc is None else acc + term
    return acc.to(torch.int32)


def int8_contract(x: torch.Tensor, codes: torch.Tensor, w_scale: torch.Tensor, x_scale,
                  contract_fn) -> torch.Tensor:
    """Quantize x, contract in int8 -> int32, rescale to float32.
    `contract_fn(xq, codes, torch.int32)` is the layer's conv or dense."""
    x_scale = torch.as_tensor(x_scale, dtype=torch.float32, device=x.device)
    xq = torch.clamp(torch.round(x.to(torch.float32) / x_scale), -127, 127).to(torch.int8)
    acc = contract_fn(xq, codes, torch.int32)
    scale = x_scale * w_scale
    if acc.dim() == 4:  # NCHW: the scale runs along the channel axis
        scale = scale[:, None, None]
    return acc.to(torch.float32) * scale


class CalibrationPolicy(CompressionPolicy):
    """Records each layer's input absmax (post-training calibration)."""

    def __init__(self):
        self.absmax: Dict[str, torch.Tensor] = {}

    def reset_trace(self):
        super().reset_trace()
        self.absmax = {}

    def process_input(self, path, x):
        m = x.detach().to(torch.float32).abs().amax()
        self.absmax[path] = torch.maximum(self.absmax[path], m) if path in self.absmax else m
        return x


def calibrate(model: torch.nn.Module, batches_images: Iterable[torch.Tensor]) -> Dict[str, float]:
    """Eval forwards of a few batches; per-layer input scales absmax / 127
    (host floats, the max over the batches)."""
    policy = CalibrationPolicy()
    was_training = model.training
    model.eval()
    absmax: Dict[str, float] = {}
    with torch.no_grad():
        for images in batches_images:
            with compression(policy):
                model(images)
            for path, m in policy.absmax.items():
                absmax[path] = max(absmax.get(path, 0.0), float(m))
    model.train(was_training)
    return {path: max(m, 1e-8) / _LEVELS for path, m in absmax.items()}


class Int8ServingPolicy(CompressionPolicy):
    """Runs every quantized conv/dense in int8.

    ``weight_q[path] = (codes, w_scale)``; ``act_scales[path]`` from
    calibrate().  Layers without both fall through to the float path.

    ``skip_depthwise`` (default True): a depthwise conv stays on the float
    path, since int8 buys it nothing and its quantize/dequantize pair is
    pure overhead.  A depthwise site is recognized by its kernel: HWIO with
    I == 1 and O a multiple of the input's channel count (x.shape[1], the
    channel axis of NCHW activations).  C > 1 keeps a dense conv on one
    input channel (a grayscale stem) in int8.
    """

    def __init__(self, weight_q, act_scales: Dict[str, float], skip_depthwise: bool = True):
        self.weight_q = weight_q
        self.act_scales = act_scales
        self.skip_depthwise = skip_depthwise

    def run_contraction(self, path, x, kernel, contract_fn):
        entry = self.weight_q.get(path)
        if entry is None or path not in self.act_scales:
            return None
        if (self.skip_depthwise and kernel.dim() == 4 and kernel.shape[-2] == 1
                and kernel.shape[-1] > 1 and x.shape[1] > 1
                and kernel.shape[-1] % x.shape[1] == 0):
            return None
        codes, w_scale = entry
        return int8_contract(x, codes, w_scale, self.act_scales[path], contract_fn)


class _SiteRecorder(CompressionPolicy):
    def __init__(self):
        self.sites = []

    def process_weight(self, path, kernel):
        self.sites.append(path)
        return kernel


def verify_quant_coverage(model: torch.nn.Module, sample_images: torch.Tensor, weight_q,
                          act_scales) -> Dict[str, list]:
    """Every conv/dense of an eval forward of `sample_images` must have int8
    weights and an activation scale.  Returns {'unquantized_weights': [...],
    'uncalibrated': [...]}, both empty when the deployment is all int8."""
    recorder = _SiteRecorder()
    was_training = model.training
    model.eval()
    with torch.no_grad(), compression(recorder):
        model(sample_images)
    model.train(was_training)
    return {'unquantized_weights': [p for p in recorder.sites if p not in weight_q],
            'uncalibrated': [p for p in recorder.sites if p not in act_scales]}


def quantize_model_weights(model: torch.nn.Module, skip_paths=()) -> Dict[str, tuple]:
    """{module path: (codes, w_scale)} for every conv/dense kernel of `model`
    outside skip_paths, on the kernel's device."""
    return {m.path: quantize_weights_symmetric(m.kernel) for m in model.modules()
            if isinstance(m, (PFConv, PFDense)) and m.path not in skip_paths}
