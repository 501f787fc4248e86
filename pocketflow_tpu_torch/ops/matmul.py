"""Tiled bf16 matrix products: the counterparts of the Pallas matmuls of the
JAX package's experiments.

    matmul_bf16(x, w)                          y = bf16(x @ w), fp32 accumulate
    bn_relu_matmul_stats(x, w, scale, shift)   z = bf16(relu(f32(x) * scale + shift))
                                               y32 = z @ w (fp32), y = bf16(y32)
                                               -> (y, sum_rows y32, sum_rows y32^2)

``matmul_bf16`` replaces the tiled matmul of experiments/conv1x1_ab.py and
experiments/mm_shape_sweep.py (``make_pallas`` in both);
``bn_relu_matmul_stats`` replaces experiments/fused_mm_proto.py's
``pallas_fused``, whose statistics come from the fp32 accumulator before the
bf16 cast.  Both run on one kernel body in ``csrc/matmul.cu`` (its header
says what bounds them and what the design does about it): a persistent,
warp-specialised kernel on Hopper's TMA loads and ``wgmma``.
``bn_relu_matmul_stats`` applies its prologue to x between shared memory and
the tensor cores (``wgmma`` with A from registers), takes each block's
column sums from the fp32 accumulators in a fixed order, and sums the
blocks' partials in a second, small launch.

x is a row-major [M, K] bf16 matrix, w [K, N] bf16, scale and shift K fp32
values ([K] or [1, K]); K and N are multiples of 8, 1 <= M < 2^31.  Dispatch is
by device, as in ops/fake_quant.py: a CPU tensor takes the plain PyTorch
version, a CUDA tensor launches the kernel, anything else raises; no call
falls back from one to the other.  Inputs the kernels do not take raise
``ValueError`` on every device.  The module-level counters count kernel
launches and plain calls.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

# launches of the CUDA kernels, and calls of the plain versions (CPU tensors)
matmul_kernel_launches = 0
stats_kernel_launches = 0
plain_calls = 0

_TILE_ROWS = 128  # kMmBM in matmul.cu: rows of y a tile; the last tile holds M % 128 rows


def reset_counters():
    global matmul_kernel_launches, stats_kernel_launches, plain_calls
    matmul_kernel_launches = stats_kernel_launches = plain_calls = 0


def counters() -> dict:
    return {'matmul_bf16': matmul_kernel_launches,
            'bn_relu_matmul_stats': stats_kernel_launches,
            'plain': plain_calls}


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------

def _matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return (x.float() @ w.float()).to(torch.bfloat16)


def _bn_relu_matmul_stats_plain(x, w, scale, shift):
    z = torch.relu(x.float() * scale.reshape(-1) + shift.reshape(-1)).to(torch.bfloat16)
    y32 = z.float() @ w.float()
    return y32.to(torch.bfloat16), y32.sum(0), y32.square().sum(0)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _library() -> ctypes.CDLL:
    from pocketflow_tpu_torch.ops import build
    lib, _, _ = build.load('matmul.cu')
    if not getattr(lib, '_pf_bound', False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pf_matmul_bf16.argtypes = [ptr, ptr, ptr, i64, i32, i32, ptr]
        lib.pf_matmul_bf16.restype = i32
        lib.pf_bn_relu_matmul_stats.argtypes = [ptr] * 8 + [i64, i32, i32, ptr]
        lib.pf_bn_relu_matmul_stats.restype = i32
        lib.pf_bn_relu_matmul_stats_grid.argtypes = [i64, i32]
        lib.pf_bn_relu_matmul_stats_grid.restype = i64
        lib._pf_bound = True
    return lib


def _check_launch(err: int, name: str):
    if err != 0:
        raise RuntimeError('%s: CUDA error %d at launch' % (name, err))


def _check_matmul(name: str, x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int, int]:
    """(M, K, N) of a product the kernels take; ValueError otherwise."""
    for arg, t in (('x', x), ('w', w)):
        if t.dtype != torch.bfloat16 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError('%s: %s must be a contiguous 2-D bf16 matrix, got %s %s'
                             % (name, arg, t.dtype, tuple(t.shape)))
    (m, k), (k2, n) = x.shape, w.shape
    if k != k2 or not 1 <= m < 2 ** 31 or k < 8 or k % 8 or n < 8 or n % 8:
        raise ValueError('%s takes [M, K] @ [K, N] with 1 <= M < 2^31 and K, N positive '
                         'multiples of 8, got %s @ %s' % (name, tuple(x.shape), tuple(w.shape)))
    if w.device != x.device:
        raise ValueError('%s: x on %s, w on %s' % (name, x.device, w.device))
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError('%s: no kernel for device %s' % (name, x.device))
    if x.device.type == 'cuda' and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError('%s: x and w must start on 16-byte boundaries' % name)
    return m, k, n


def matmul_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y = bf16(x @ w) with fp32 accumulation, [M, N].  Kernel on CUDA,
    plain version on the CPU."""
    global matmul_kernel_launches, plain_calls
    m, k, n = _check_matmul('matmul_bf16', x, w)
    if x.device.type == 'cpu':
        plain_calls += 1
        return _matmul_plain(x, w)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    err = _library().pf_matmul_bf16(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, n,
                                    torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, 'matmul_bf16')
    matmul_kernel_launches += 1
    return y


def bn_relu_matmul_stats(x: torch.Tensor, w: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(y [M, N] bf16, s [N] fp32, ss [N] fp32) with y = bf16(y32),
    y32 = bf16(relu(f32(x) * scale + shift)) @ w in fp32, and s, ss the
    column sums of y32 and y32^2 over the M rows.  Kernel on CUDA (two
    launches), plain version on the CPU."""
    global stats_kernel_launches, plain_calls
    m, k, n = _check_matmul('bn_relu_matmul_stats', x, w)
    for arg, t in (('scale', scale), ('shift', shift)):
        if t.dtype != torch.float32 or t.numel() != k or not t.is_contiguous() \
                or t.device != x.device:
            raise ValueError('bn_relu_matmul_stats: %s must be %d contiguous fp32 values on '
                             '%s, got %s %s on %s' % (arg, k, x.device, t.dtype,
                                                      tuple(t.shape), t.device))
    if x.device.type == 'cpu':
        plain_calls += 1
        return _bn_relu_matmul_stats_plain(x, w, scale, shift)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    stats = torch.empty((2, n), dtype=torch.float32, device=x.device)
    lib = _library()
    with torch.cuda.device(x.device):
        # a row of (sum, sum of squares) partials for each block of the kernel
        partials = torch.empty((lib.pf_bn_relu_matmul_stats_grid(m, n), 2, n),
                               dtype=torch.float64, device=x.device)
        err = lib.pf_bn_relu_matmul_stats(
            x.data_ptr(), w.data_ptr(), scale.data_ptr(), shift.data_ptr(), y.data_ptr(),
            partials.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(), m, k, n,
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, 'bn_relu_matmul_stats')
    stats_kernel_launches += 1
    return y, stats[0], stats[1]
