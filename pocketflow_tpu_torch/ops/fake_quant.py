"""Fake-quantization with straight-through-estimator gradients
(counterpart of pocketflow_tpu/ops/fake_quant.py).

    alpha = max(x) - min(x) + 1e-10          (no gradient)
    beta  = min(x)                           (no gradient)
    k     = 2^bits - 1
    q     = alpha * round((x - beta)/alpha * k)/k + beta

with three scaling granularities: per tensor, split buckets (flatten, pad with
the last element to a multiple of bucket_size, reshape [bucket_size,
nb_buckets], scale per column) and channel buckets (reshape [-1, c_out], scale
per output channel).  Each public op is a ``torch.autograd.Function`` whose
backward is the identity.

Two CUDA kernels carry the forward (``csrc/fake_quant.cu``; its header says
which TPU kernel each replaces, what bounds it and what its design does about
that): ``fake_quant_per_tensor`` and ``fake_quant_per_column``.  Dispatch is by
device: a CPU tensor takes the plain PyTorch version (``_quantize_math_torch``),
a CUDA tensor launches the kernel, anything else raises.  No call falls back
from one to the other.  The module-level counters count kernel launches and
plain calls, so a run can show which path it took.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

EPS = 1e-10

# launches of the CUDA kernels, and calls of the plain version (CPU tensors)
tensor_kernel_launches = 0
column_kernel_launches = 0
plain_calls = 0


def reset_counters():
    global tensor_kernel_launches, column_kernel_launches, plain_calls
    tensor_kernel_launches = column_kernel_launches = plain_calls = 0


def counters() -> dict:
    return {'fake_quant_per_tensor': tensor_kernel_launches,
            'fake_quant_per_column': column_kernel_launches,
            'plain': plain_calls}


# ---------------------------------------------------------------------------
# Plain PyTorch version (counterpart of _quantize_math)
# ---------------------------------------------------------------------------

def _levels(bits: torch.Tensor) -> torch.Tensor:
    return torch.exp2(bits.to(torch.float32)) - 1.0


def _quantize_math_torch(x: torch.Tensor, k: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    """min/max affine quantize along `axis` (None = whole tensor), in fp32."""
    x32 = x.to(torch.float32)
    if axis is None:
        w_max, w_min = x32.max(), x32.min()
    else:
        w_max = x32.amax(dim=axis, keepdim=True)
        w_min = x32.amin(dim=axis, keepdim=True)
    alpha = w_max - w_min + EPS
    beta = w_min
    normalized = (x32 - beta) / alpha
    q = torch.round(normalized * k) / k
    return alpha * q + beta


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_TENSOR_THREADS = 256  # kThreads in fake_quant.cu
_MAX_PARTIALS = 1024
_COL_TILE = 32          # kColTile in fake_quant.cu: columns per block
_MIN_CHUNK_ROWS = 64    # rows per block of the per-column kernels, at least
_BLOCKS_PER_SM = 4      # per-column grids aim at this many blocks per SM


def _library() -> ctypes.CDLL:
    from pocketflow_tpu_torch.ops import build
    lib, _, _ = build.load('fake_quant.cu')
    if not getattr(lib, '_pf_bound', False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pf_fake_quant_tensor.argtypes = [ptr, ptr, i64, i32, ptr, i32, ptr, ptr]
        lib.pf_fake_quant_tensor.restype = i32
        lib.pf_fake_quant_columns.argtypes = [ptr, ptr, i64, i64, i64, ptr, i32, ptr, ptr]
        lib.pf_fake_quant_columns.restype = i32
        lib._pf_bound = True
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _row_chunks(rows: int, cols: int, sm_count: int) -> Tuple[int, int]:
    """(rows per chunk, number of chunks) for the per-column kernels: enough
    blocks to give every SM a few, each with at least _MIN_CHUNK_ROWS rows."""
    col_tiles = -(-cols // _COL_TILE)
    wanted = -(-_BLOCKS_PER_SM * sm_count // col_tiles)
    nchunks = max(1, min(wanted, rows // _MIN_CHUNK_ROWS))
    chunk = -(-rows // nchunks)
    return chunk, -(-rows // chunk)


def _check_launch(err: int, name: str):
    if err != 0:
        raise RuntimeError('%s: CUDA error %d at launch' % (name, err))


def _check_bits(bits: torch.Tensor, x: torch.Tensor):
    if bits.device != x.device or bits.dtype != torch.float32 or bits.numel() != 1:
        raise ValueError('bits must be one float32 on the device of x, got %s %s %s'
                         % (bits.dtype, tuple(bits.shape), bits.device))


def _dense(x: torch.Tensor) -> bool:
    """Whether x's elements fill its memory block with no gaps, in row-major
    or channels-last order; a per-tensor op may then run over the block."""
    return x.is_contiguous() or (x.dim() == 4 and x.is_contiguous(
        memory_format=torch.channels_last))


def fake_quant_per_tensor(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-tensor fake-quant of fp32 or bf16 `x` at `bits` (0-d fp32 tensor);
    the result has x's dtype and memory layout.  Kernel K1' on CUDA, plain
    version on the CPU."""
    global tensor_kernel_launches, plain_calls
    if x.device.type == 'cpu':
        plain_calls += 1
        return _quantize_math_torch(x, _levels(bits), None).to(x.dtype)
    if x.device.type != 'cuda':
        raise ValueError('fake_quant_per_tensor: no kernel for device %s' % x.device)
    if x.dtype not in (torch.float32, torch.bfloat16) or not _dense(x) or x.numel() < 1:
        raise ValueError('fake_quant_per_tensor takes a non-empty dense fp32/bf16 '
                         'tensor, got %s %s' % (x.dtype, tuple(x.shape)))
    _check_bits(bits, x)
    n = x.numel()
    per_block = _TENSOR_THREADS * (16 // x.element_size()) * 4
    nparts = int(min(_MAX_PARTIALS, max(1, -(-n // per_block))))
    out = torch.empty_like(x)
    partials = torch.empty(2 * nparts, dtype=torch.float32, device=x.device)
    err = _library().pf_fake_quant_tensor(
        x.data_ptr(), out.data_ptr(), n, int(x.dtype == torch.bfloat16),
        partials.data_ptr(), nparts, bits.data_ptr(),
        torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, 'fake_quant_per_tensor')
    tensor_kernel_launches += 1
    return out


def fake_quant_per_column(x2d: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-column fake-quant of an fp32 [rows, cols] matrix: each column has
    its own (alpha, beta).  Kernel K2' on CUDA, plain version on the CPU."""
    global column_kernel_launches, plain_calls
    if x2d.device.type == 'cpu':
        plain_calls += 1
        return _quantize_math_torch(x2d, _levels(bits), 0).to(x2d.dtype)
    if x2d.device.type != 'cuda':
        raise ValueError('fake_quant_per_column: no kernel for device %s' % x2d.device)
    if x2d.dtype != torch.float32 or x2d.dim() != 2 or not x2d.is_contiguous() \
            or x2d.numel() < 1:
        raise ValueError('fake_quant_per_column takes a non-empty contiguous fp32 '
                         '[rows, cols] matrix, got %s %s' % (x2d.dtype, tuple(x2d.shape)))
    _check_bits(bits, x2d)
    rows, cols = x2d.shape
    chunk, nchunks = _row_chunks(rows, cols, _sm_count(x2d.device))
    out = torch.empty_like(x2d)
    partials = torch.empty(2 * nchunks * cols, dtype=torch.float32, device=x2d.device)
    err = _library().pf_fake_quant_columns(
        x2d.data_ptr(), out.data_ptr(), rows, cols, chunk, partials.data_ptr(), nchunks,
        bits.data_ptr(), torch.cuda.current_stream(x2d.device).cuda_stream)
    _check_launch(err, 'fake_quant_per_column')
    column_kernel_launches += 1
    return out


# ---------------------------------------------------------------------------
# Public ops (autograd.Function, STE backward)
# ---------------------------------------------------------------------------

class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        return fake_quant_per_tensor(x if _dense(x) else x.contiguous(), bits)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _FakeQuantSplitBucket(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, bucket_size):
        flat = x.reshape(-1)
        n = flat.shape[0]
        nb_buckets = -(-n // bucket_size)
        pad = nb_buckets * bucket_size - n
        if pad:
            flat = torch.cat([flat, flat[-1:].expand(pad)])
        # row-major [bucket_size, nb_buckets], as tf.reshape: bucket j
        # collects the elements with index % nb_buckets == j
        cols = flat.reshape(bucket_size, nb_buckets).contiguous()
        out = fake_quant_per_column(cols, bits).reshape(-1)
        if pad:
            out = out[:n]
        return out.reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FakeQuantChannelBucket(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        cols = x.reshape(-1, x.shape[-1]).contiguous()
        return fake_quant_per_column(cols, bits).reshape(x.shape).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None


def fake_quant(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-tensor fake-quantization with STE."""
    return _FakeQuant.apply(x, bits)


def fake_quant_split_bucket(x: torch.Tensor, bits: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Split-bucket fake-quantization with STE: flatten, pad with the LAST
    element to a multiple of bucket_size, scale per bucket."""
    return _FakeQuantSplitBucket.apply(x, bits, int(bucket_size))


def fake_quant_channel_bucket(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-output-channel fake-quantization with STE: reshape [-1, c_out] and
    scale per column.  For HWIO conv kernels and [c_in, c_out] dense kernels
    the last axis is c_out."""
    return _FakeQuantChannelBucket.apply(x, bits)


# ---------------------------------------------------------------------------
# Storage accounting
# ---------------------------------------------------------------------------

def bucket_storage_bits(shape: Tuple[int, ...], bucket_type: str, bucket_size: int) -> int:
    """Extra bits for per-bucket (alpha, beta) fp32 pairs."""
    n = int(np.prod(shape))
    if bucket_type == 'split':
        nb_buckets = -(-n // bucket_size)
    elif bucket_type == 'channel':
        nb_buckets = shape[-1]
    else:
        raise ValueError('unrecognized bucket type: ' + bucket_type)
    return nb_buckets * 32 * 2


def quantized_model_bits(shapes, w_bits, bucket_type: Optional[str], bucket_size: int) -> int:
    """Total storage bits for quantized weights incl. bucket overhead."""
    total = 0
    for shape, bits in zip(shapes, w_bits):
        total += int(np.prod(shape)) * int(bits)
        if bucket_type:
            total += bucket_storage_bits(shape, bucket_type, bucket_size)
    return total
