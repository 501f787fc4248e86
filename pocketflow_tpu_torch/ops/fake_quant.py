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

Three CUDA kernels carry the forward (``csrc/fake_quant.cu``; its header says
which TPU kernel each replaces, what bounds it and what its design does about
that): ``fake_quant_per_tensor`` (with ``select``, the quant policy's select
on bits < 32 too: the activations), ``fake_quant_per_tensor_group`` (many
fp32 tensors at their own bits in one launch pair: the train step's
weights) and ``fake_quant_per_column_group`` (the bucket routes' weights in
one launch pair; a group of one, without the select, is the per-site bucket
ops' route).  Under data parallelism an activation's range is the global
batch's: ``fake_quant_per_tensor_global`` runs K1''s pass 1 alone, all-reduces
the (min, max) across the ranks, then runs pass 2 from that range (the fused
``fake_quant_per_tensor`` stays the route at world size 1).  Under tensor
parallelism a sharded kernel's per-tensor range is the max over its shards:
``fake_quant_per_tensor_group_global`` runs the grouped kernel's pass 1 into
a [T, 2] buffer of (-min, max), all-reduces it (MAX) over the model group and
quantizes from it (the fused ``fake_quant_per_tensor_group`` stays the route
where no weight is sharded).  Dispatch is by device: a CPU
tensor takes the plain PyTorch version (``_quantize_math_torch``), a CUDA
tensor launches the kernel, anything else raises.  No call falls back from
one to the other.  The module-level counters count kernel launches and plain
calls, so a run can show which path it took.
"""

from __future__ import annotations

import collections
import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from pocketflow_tpu_torch.core import mesh
from pocketflow_tpu_torch.core.profiling import span

EPS = 1e-10

# launches of the CUDA kernels (select_launches: those of the per-tensor
# kernel with the select), and calls of the plain version (CPU tensors)
tensor_kernel_launches = 0
select_launches = 0
global_range_launches = 0
group_kernel_launches = 0
group_global_launches = 0
column_group_launches = 0
plain_calls = 0


def reset_counters():
    global tensor_kernel_launches, select_launches, group_kernel_launches
    global column_group_launches, plain_calls, global_range_launches, group_global_launches
    tensor_kernel_launches = select_launches = group_kernel_launches = 0
    column_group_launches = plain_calls = global_range_launches = 0
    group_global_launches = 0


def counters() -> dict:
    return {'fake_quant_per_tensor': tensor_kernel_launches,
            'fake_quant_per_tensor_select': select_launches,
            'fake_quant_per_tensor_global': global_range_launches,
            'fake_quant_per_tensor_group': group_kernel_launches,
            'fake_quant_per_tensor_group_global': group_global_launches,
            'fake_quant_per_column_group': column_group_launches,
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
    return _quantize_in_range(x32, k, w_min, w_max)


def _quantize_in_range(x32: torch.Tensor, k: torch.Tensor, w_min: torch.Tensor,
                       w_max: torch.Tensor) -> torch.Tensor:
    """The affine quantization of fp32 x32 against the range (w_min, w_max)."""
    alpha = w_max - w_min + EPS
    beta = w_min
    normalized = (x32 - beta) / alpha
    q = torch.round(normalized * k) / k
    return alpha * q + beta


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_COL_TILE = 32          # kColTile in fake_quant.cu: columns per block (one warp wide)
_GROUP_CHUNK = 16384    # kGroupChunk in fake_quant.cu: elements a block of a group
_COL_GROUP_ROWS = 512   # kColGroupRows in fake_quant.cu: rows a block of a column group
_COL_ENTRY_FIELDS = 7   # int64 fields of a ColumnEntry in fake_quant.cu
_GROUP_TABLES = 128     # device chunk tables kept: one per group (a route's weights, or one
                        # weight of a per-site bucket op: 2 x 52 for ResNet-50's)


def _library() -> ctypes.CDLL:
    from pocketflow_tpu_torch.ops import build
    lib, _, _ = build.load('fake_quant.cu')
    if not getattr(lib, '_pf_bound', False):
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.pf_fake_quant_tensor.argtypes = [ptr, ptr, i64, i32, ptr, ptr, i32, ptr]
        lib.pf_fake_quant_tensor.restype = i32
        lib.pf_fake_quant_tensor_minmax.argtypes = [ptr, i64, i32, ptr, ptr, i32, ptr, ptr]
        lib.pf_fake_quant_tensor_minmax.restype = i32
        lib.pf_fake_quant_tensor_from_range.argtypes = [ptr, ptr, i64, i32, ptr, ptr, i32, ptr]
        lib.pf_fake_quant_tensor_from_range.restype = i32
        lib.pf_fake_quant_tensor_group.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr]
        lib.pf_fake_quant_tensor_group.restype = i32
        lib.pf_fake_quant_tensor_group_minmax.argtypes = [ptr, ptr, i32, ptr, ptr, i32, ptr, ptr]
        lib.pf_fake_quant_tensor_group_minmax.restype = i32
        lib.pf_fake_quant_tensor_group_from_range.argtypes = [ptr, ptr, i32, ptr, ptr, ptr, ptr]
        lib.pf_fake_quant_tensor_group_from_range.restype = i32
        lib.pf_fake_quant_columns_group.argtypes = [ptr, ptr, i32, ptr, i32, ptr, ptr, ptr]
        lib.pf_fake_quant_columns_group.restype = i32
        layout = {'pf_fake_quant_group_chunk': _GROUP_CHUNK,
                  'pf_fake_quant_column_group_rows': _COL_GROUP_ROWS,
                  'pf_fake_quant_column_tile': _COL_TILE,
                  'pf_fake_quant_column_entry_bytes': 8 * _COL_ENTRY_FIELDS}
        for name, want in layout.items():
            getattr(lib, name).restype = i32
            if getattr(lib, name)() != want:
                raise RuntimeError('fake_quant.cu: %s() is %d, the wrapper lays its tables out '
                                   'for %d' % (name, getattr(lib, name)(), want))
        lib.pf_fake_quant_tensor_scratch_bytes.restype = i32
        lib._pf_bound = True
    return lib


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


# (device, stream) -> the per-tensor kernel's scratch on that stream, zeroed
# once: its pass 1 leaves it zeroed for the next call
_tensor_scratch = {}


def _scratch(device: torch.device, stream) -> torch.Tensor:
    key = (device, stream.cuda_stream)
    scratch = _tensor_scratch.get(key)
    if scratch is None:
        scratch = torch.zeros(_library().pf_fake_quant_tensor_scratch_bytes() // 4,
                              dtype=torch.int32, device=device)
        _tensor_scratch[key] = scratch
    return scratch


def fake_quant_per_tensor(x: torch.Tensor, bits: torch.Tensor,
                          select: bool = False) -> torch.Tensor:
    """Per-tensor fake-quant of fp32 or bf16 `x` at `bits` (0-d fp32 tensor)
    or, with `select`, x unchanged where bits >= 32 (the quant policy's
    select); the result has x's dtype and memory layout.  Kernel K1' on
    CUDA, plain version on the CPU."""
    global tensor_kernel_launches, select_launches, plain_calls
    if x.device.type == 'cpu':
        plain_calls += 1
        q = _quantize_math_torch(x, _levels(bits), None).to(x.dtype)
        return torch.where(bits < 32, q, x) if select else q
    if x.device.type != 'cuda':
        raise ValueError('fake_quant_per_tensor: no kernel for device %s' % x.device)
    if x.dtype not in (torch.float32, torch.bfloat16) or not _dense(x) or x.numel() < 1:
        raise ValueError('fake_quant_per_tensor takes a non-empty dense fp32/bf16 '
                         'tensor, got %s %s' % (x.dtype, tuple(x.shape)))
    _check_bits(bits, x)
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        err = _library().pf_fake_quant_tensor(
            x.data_ptr(), out.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
            _scratch(x.device, stream).data_ptr(), bits.data_ptr(), int(select),
            stream.cuda_stream)
    _check_launch(err, 'fake_quant_per_tensor')
    tensor_kernel_launches += 1
    select_launches += int(select)
    return out


def fake_quant_per_tensor_global(x: torch.Tensor, bits: torch.Tensor,
                                 select: bool = False) -> torch.Tensor:
    """fake_quant_per_tensor(x, bits, select) against the range of x over
    every rank's rows (core/mesh.py), x's own at world size 1: K1''s pass 1
    (``tensor_minmax``: (-min, max) into a device buffer), one MAX all-reduce
    of that pair, pass 2 from it (``tensor_from_range``), all on the current
    stream, with no wait on the host.  The plain version takes
    torch.aminmax, the same all-reduce and _quantize_in_range."""
    global global_range_launches, plain_calls
    if x.device.type == 'cpu':
        plain_calls += 1
        x32 = x.to(torch.float32)
        lo_hi = mesh.all_reduce_minmax_(torch.stack(torch.aminmax(x32)))
        q = _quantize_in_range(x32, _levels(bits), lo_hi[0], lo_hi[1]).to(x.dtype)
        return torch.where(bits < 32, q, x) if select else q
    neg_range = tensor_minmax(x, bits, select)
    mesh.all_reduce_max_(neg_range)
    out = tensor_from_range(x, bits, neg_range, select)
    global_range_launches += 1
    return out


def _check_tensor(name: str, x: torch.Tensor, bits: torch.Tensor):
    if x.device.type != 'cuda':
        raise ValueError('%s: no kernel for device %s' % (name, x.device))
    if x.dtype not in (torch.float32, torch.bfloat16) or not _dense(x) or x.numel() < 1:
        raise ValueError('%s takes a non-empty dense fp32/bf16 tensor, got %s %s'
                         % (name, x.dtype, tuple(x.shape)))
    _check_bits(bits, x)


def tensor_minmax(x: torch.Tensor, bits: torch.Tensor, select: bool = False) -> torch.Tensor:
    """K1''s pass 1 alone on CUDA `x`: a [2] fp32 device tensor holding
    (-min(x), max(x)) (unset where select and bits >= 32)."""
    _check_tensor('tensor_minmax', x, bits)
    neg_range = torch.empty(2, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    with torch.cuda.device(x.device):
        err = _library().pf_fake_quant_tensor_minmax(
            x.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
            _scratch(x.device, stream).data_ptr(), bits.data_ptr(), int(select),
            neg_range.data_ptr(), stream.cuda_stream)
    _check_launch(err, 'tensor_minmax')
    return neg_range


def tensor_from_range(x: torch.Tensor, bits: torch.Tensor, neg_range: torch.Tensor,
                      select: bool = False) -> torch.Tensor:
    """K1''s pass 2 alone on CUDA `x`: its fake-quant against the range
    (-neg_range[0], neg_range[1]) ([2] fp32 on x's device), which must hold
    every element of x (the global range does: the bf16 table covers only
    the values in it), or x itself where select and bits >= 32; x's dtype
    and memory layout."""
    _check_tensor('tensor_from_range', x, bits)
    if neg_range.device != x.device or neg_range.dtype != torch.float32 \
            or tuple(neg_range.shape) != (2,) or not neg_range.is_contiguous():
        raise ValueError('neg_range must be 2 contiguous float32 on %s' % x.device)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _library().pf_fake_quant_tensor_from_range(
            x.data_ptr(), out.data_ptr(), x.numel(), int(x.dtype == torch.bfloat16),
            neg_range.data_ptr(), bits.data_ptr(), int(select),
            torch.cuda.current_stream(x.device).cuda_stream)
    _check_launch(err, 'tensor_from_range')
    return out


def _group_plan(sizes: Sequence[int]) -> Tuple[List[int], List[int], List[int], int]:
    """The grouped kernel's layout of tensors of `sizes` elements: (offset of
    each output in the flat output, a multiple of 4 elements; first chunk of
    each tensor; the tensor of each chunk of _GROUP_CHUNK elements; size of
    the flat output)."""
    offsets, first_chunks, chunk_tensor, total = [], [], [], 0
    for t, n in enumerate(sizes):
        offsets.append(total)
        first_chunks.append(len(chunk_tensor))
        chunk_tensor += [t] * -(-n // _GROUP_CHUNK)
        total += -(-n // 4) * 4
    return offsets, first_chunks, chunk_tensor, total


# (kind, device, (address, shape) of each tensor) -> the device tables of that group
_group_tables: 'collections.OrderedDict' = collections.OrderedDict()


def _cached_table(key, build):
    """The tables of a group, built by build() at the group's first call and
    kept: a train step quantizes the same parameters (updated in place)
    every step, so a step copies nothing to the device."""
    table = _group_tables.get(key)
    if table is None:
        table = _group_tables[key] = build()
        if len(_group_tables) > _GROUP_TABLES:
            _group_tables.popitem(last=False)
    else:
        _group_tables.move_to_end(key)
    return table


def _group_key(kind, xs: Sequence[torch.Tensor]):
    return (kind, xs[0].device, tuple((x.data_ptr(), x.shape) for x in xs))


def _flat_layout(xs: Sequence[torch.Tensor], offsets: Sequence[int]):
    """(shape, strides, offset) of each output in the flat output."""
    return [(x.shape, x.stride(), o) for x, o in zip(xs, offsets)]


def _group_table(xs: Sequence[torch.Tensor]):
    """(entries [T, 4] int64, chunk_tensor [nchunks] int32, (shape, strides,
    offset) of each output in the flat output, flat output size) of a group,
    the tables on its device, built once per group."""
    def build():
        offsets, first_chunks, chunk_tensor, total = _group_plan([x.numel() for x in xs])
        entries = torch.tensor([[x.data_ptr(), o, x.numel(), f]
                                for x, o, f in zip(xs, offsets, first_chunks)], dtype=torch.int64)
        return (entries.to(xs[0].device),
                torch.tensor(chunk_tensor, dtype=torch.int32).to(xs[0].device),
                _flat_layout(xs, offsets), total)
    return _cached_table(_group_key('tensor', xs), build)


def _check_group(name: str, xs: Sequence[torch.Tensor], bits: torch.Tensor):
    """Raise unless xs are non-empty contiguous fp32 tensors on one device
    and bits one float32 each on it."""
    if not xs:
        raise ValueError('%s takes at least one tensor' % name)
    device = xs[0].device
    for x in xs:
        if x.device != device or x.dtype != torch.float32 or not x.is_contiguous() \
                or x.numel() < 1:
            raise ValueError('%s takes non-empty contiguous fp32 tensors on one device, got '
                             '%s %s on %s' % (name, x.dtype, tuple(x.shape), x.device))
    if bits.device != device or bits.dtype != torch.float32 or tuple(bits.shape) != (len(xs),):
        raise ValueError('bits must be %d float32 on %s, got %s %s on %s'
                         % (len(xs), device, bits.dtype, tuple(bits.shape), bits.device))


def fake_quant_per_tensor_group(xs: Sequence[torch.Tensor], bits: torch.Tensor) -> List[torch.Tensor]:
    """Per-tensor fake-quant of each fp32 tensor xs[t] at bits[t] (a [T] fp32
    tensor), or xs[t] unchanged where bits[t] >= 32: the list of results, in
    order.  The grouped route of kernel K1' (one launch pair for all T) on
    CUDA, where the results are views of one flat buffer; plain version on
    the CPU."""
    global group_kernel_launches, plain_calls
    xs = list(xs)
    _check_group('fake_quant_per_tensor_group', xs, bits)
    device = xs[0].device
    if device.type == 'cpu':
        plain_calls += 1
        return [torch.where(b < 32, _quantize_math_torch(x, _levels(b), None), x)
                for x, b in zip(xs, bits)]
    if device.type != 'cuda':
        raise ValueError('fake_quant_per_tensor_group: no kernel for device %s' % device)
    entries, chunk_tensor, layout, total = _group_table(xs)
    out = torch.empty(total, dtype=torch.float32, device=device)
    partials = torch.empty(2 * chunk_tensor.numel(), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _library().pf_fake_quant_tensor_group(
            entries.data_ptr(), chunk_tensor.data_ptr(), chunk_tensor.numel(), bits.data_ptr(),
            partials.data_ptr(), out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _check_launch(err, 'fake_quant_per_tensor_group')
    group_kernel_launches += 1
    return [out.as_strided(shape, strides, offset) for shape, strides, offset in layout]


def fake_quant_per_tensor_group_global(xs: Sequence[torch.Tensor],
                                       bits: torch.Tensor) -> List[torch.Tensor]:
    """fake_quant_per_tensor_group(xs, bits) with each tensor's range the
    max over the model group (core/mesh.py): a sharded kernel's range is
    its full kernel's, a replicated one's its own (equal on every model
    rank).  The grouped route's pass 1 into a [T, 2] device buffer of
    (-min, max) (``tensor_group_minmax``), one MAX all-reduce of it over the
    model group, pass 2 from it (``tensor_group_from_range``), all on the
    current stream, with no wait on the host.  The plain version takes each
    tensor's min and max, the same all-reduce and _quantize_in_range."""
    global group_global_launches, plain_calls
    xs = list(xs)
    _check_group('fake_quant_per_tensor_group_global', xs, bits)
    device = xs[0].device
    if device.type == 'cpu':
        plain_calls += 1
        neg_ranges = torch.stack([torch.stack([-x.min(), x.max()]) for x in xs])
        mesh.all_reduce_max_model_(neg_ranges)
        return [torch.where(b < 32, _quantize_in_range(x, _levels(b), -r[0], r[1]), x)
                for x, b, r in zip(xs, bits, neg_ranges)]
    if device.type != 'cuda':
        raise ValueError('fake_quant_per_tensor_group_global: no kernel for device %s' % device)
    table = _group_table(xs)
    neg_ranges = _launch_group_minmax(xs, bits, table)
    mesh.all_reduce_max_model_(neg_ranges)
    out = _launch_group_from_range(xs, bits, neg_ranges, table)
    group_global_launches += 1
    return out


def _launch_group_minmax(xs, bits, table) -> torch.Tensor:
    entries, chunk_tensor, _, _ = table
    device = xs[0].device
    partials = torch.empty(2 * chunk_tensor.numel(), dtype=torch.float32, device=device)
    neg_ranges = torch.empty((len(xs), 2), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _library().pf_fake_quant_tensor_group_minmax(
            entries.data_ptr(), chunk_tensor.data_ptr(), chunk_tensor.numel(), bits.data_ptr(),
            partials.data_ptr(), len(xs), neg_ranges.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _check_launch(err, 'tensor_group_minmax')
    return neg_ranges


def _launch_group_from_range(xs, bits, neg_ranges, table) -> List[torch.Tensor]:
    entries, chunk_tensor, layout, total = table
    device = xs[0].device
    out = torch.empty(total, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = _library().pf_fake_quant_tensor_group_from_range(
            entries.data_ptr(), chunk_tensor.data_ptr(), chunk_tensor.numel(), bits.data_ptr(),
            neg_ranges.data_ptr(), out.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    _check_launch(err, 'tensor_group_from_range')
    return [out.as_strided(shape, strides, offset) for shape, strides, offset in layout]


def tensor_group_minmax(xs: Sequence[torch.Tensor], bits: torch.Tensor) -> torch.Tensor:
    """The grouped route's pass 1 alone on CUDA fp32 `xs`: a [T, 2] fp32
    device tensor of each tensor's (-min, max) ((-FLT_MAX, -FLT_MAX) where
    bits >= 32)."""
    xs = list(xs)
    _check_group('tensor_group_minmax', xs, bits)
    if xs[0].device.type != 'cuda':
        raise ValueError('tensor_group_minmax: no kernel for device %s' % xs[0].device)
    return _launch_group_minmax(xs, bits, _group_table(xs))


def tensor_group_from_range(xs: Sequence[torch.Tensor], bits: torch.Tensor,
                            neg_ranges: torch.Tensor) -> List[torch.Tensor]:
    """The grouped route's pass 2 alone on CUDA fp32 `xs`: each tensor's
    fake-quant against (-neg_ranges[t, 0], neg_ranges[t, 1]) ([T, 2] fp32
    on their device), or the tensor itself where bits[t] >= 32; views of one
    flat buffer, as fake_quant_per_tensor_group's."""
    xs = list(xs)
    _check_group('tensor_group_from_range', xs, bits)
    device = xs[0].device
    if device.type != 'cuda':
        raise ValueError('tensor_group_from_range: no kernel for device %s' % device)
    if neg_ranges.device != device or neg_ranges.dtype != torch.float32 \
            or tuple(neg_ranges.shape) != (len(xs), 2) or not neg_ranges.is_contiguous():
        raise ValueError('neg_ranges must be [%d, 2] contiguous float32 on %s'
                         % (len(xs), device))
    return _launch_group_from_range(xs, bits, neg_ranges, _group_table(xs))


def _column_view(shape: Sequence[int], bucket_size: Optional[int]) -> Tuple[int, int]:
    """(rows, cols) of a tensor's column view: channel buckets (bucket_size
    None) [n / c_out, c_out]; split buckets the flattened tensor as row-major
    [bucket_size, ceil(n / bucket_size)], as tf.reshape (bucket j collects
    the elements with index % cols == j), the missing elements reading as the
    last one."""
    n = int(np.prod(shape))
    if bucket_size is None:
        return n // shape[-1], shape[-1]
    return bucket_size, -(-n // bucket_size)


def _column_matrix(x: torch.Tensor, bucket_size: Optional[int]) -> torch.Tensor:
    """x's column view as a [rows, cols] tensor (split buckets padded with
    the last element)."""
    rows, cols = _column_view(x.shape, bucket_size)
    flat = x.reshape(-1)
    pad = rows * cols - flat.numel()
    if pad:
        flat = torch.cat([flat, flat[-1:].expand(pad)])
    return flat.reshape(rows, cols)


def _from_columns(out2d: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The inverse of _column_matrix: out2d's first x.numel() elements in x's shape."""
    return out2d.reshape(-1)[:x.numel()].reshape(x.shape)


def _column_plain(x: torch.Tensor, k: torch.Tensor, bucket_size: Optional[int]) -> torch.Tensor:
    """The plain per-column fake-quant of x in its column view (fp32), of x's shape."""
    return _from_columns(_quantize_math_torch(_column_matrix(x, bucket_size), k, 0), x)


def _column_group_plan(views: Sequence[Tuple[int, int, int]]):
    """The grouped per-column kernel's layout of tensors of (n, rows, cols):
    (offset of each output in the flat output, a multiple of 4 elements;
    first chunk of each tensor; row chunks of each of its column tiles; the
    tensor of each chunk, a tensor's chunks tile by tile, each tile's row
    chunks consecutive; size of the flat output)."""
    offsets, first_chunks, row_chunks, chunk_tensor, total = [], [], [], [], 0
    for t, (n, rows, cols) in enumerate(views):
        offsets.append(total)
        first_chunks.append(len(chunk_tensor))
        row_chunks.append(-(-rows // _COL_GROUP_ROWS))
        chunk_tensor += [t] * (-(-cols // _COL_TILE) * row_chunks[-1])
        total += -(-n // 4) * 4
    return offsets, first_chunks, row_chunks, chunk_tensor, total


def _column_group_table(xs: Sequence[torch.Tensor], bucket_size: Optional[int]):
    """(entries [T, 7] int64, chunk_tensor [nchunks] int32, (shape, strides,
    offset) of each output in the flat output, flat output size) of a column
    group, the tables on its device, built once per group."""
    def build():
        views = [(x.numel(), *_column_view(x.shape, bucket_size)) for x in xs]
        offsets, first_chunks, row_chunks, chunk_tensor, total = _column_group_plan(views)
        entries = torch.tensor([[x.data_ptr(), o, n, rows, cols, f, rc]
                                for x, o, (n, rows, cols), f, rc
                                in zip(xs, offsets, views, first_chunks, row_chunks)],
                               dtype=torch.int64)
        return (entries.to(xs[0].device),
                torch.tensor(chunk_tensor, dtype=torch.int32).to(xs[0].device),
                _flat_layout(xs, offsets), total)
    return _cached_table(_group_key(('columns', bucket_size), xs), build)


def fake_quant_per_column_group(xs: Sequence[torch.Tensor], bits: torch.Tensor,
                                bucket_size: Optional[int] = None,
                                select: bool = True) -> List[torch.Tensor]:
    """Per-column fake-quant of each fp32 tensor xs[t] at bits[t] (a [T] fp32
    tensor) in its column view, or, with `select`, xs[t] unchanged where
    bits[t] >= 32 (the quant policy's select; without it every tensor is
    quantized, 32 bits included): the list of results, in order, each of its
    tensor's shape.  Channel buckets (bucket_size None: [-1, c_out]) or split
    buckets of bucket_size (see _column_view).  Kernel K2' (one launch pair
    for all T) on CUDA, where the results are views of one flat buffer; plain
    version on the CPU."""
    global column_group_launches, plain_calls
    xs = list(xs)
    _check_group('fake_quant_per_column_group', xs, bits)
    if bucket_size is None:
        if any(x.dim() < 1 for x in xs):
            raise ValueError('channel buckets need a last axis; got a 0-d tensor')
    elif bucket_size < 1:
        raise ValueError('bucket_size must be at least 1, got %d' % bucket_size)
    device = xs[0].device
    if device.type == 'cpu':
        plain_calls += 1
        quantized = [_column_plain(x, _levels(b), bucket_size) for x, b in zip(xs, bits)]
        if not select:
            return quantized
        return [torch.where(b < 32, q, x) for x, b, q in zip(xs, bits, quantized)]
    if device.type != 'cuda':
        raise ValueError('fake_quant_per_column_group: no kernel for device %s' % device)
    entries, chunk_tensor, layout, total = _column_group_table(xs, bucket_size)
    out = torch.empty(total, dtype=torch.float32, device=device)
    partials = torch.empty(2 * _COL_TILE * chunk_tensor.numel(), dtype=torch.float32,
                           device=device)
    with torch.cuda.device(device):
        err = _library().pf_fake_quant_columns_group(
            entries.data_ptr(), chunk_tensor.data_ptr(), chunk_tensor.numel(), bits.data_ptr(),
            int(select), partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream)
    _check_launch(err, 'fake_quant_per_column_group')
    column_group_launches += 1
    return [out.as_strided(shape, strides, offset) for shape, strides, offset in layout]


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


class _FakeQuantSelect(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        return fake_quant_per_tensor(x if _dense(x) else x.contiguous(), bits, select=True)

    @staticmethod
    def backward(ctx, g):
        with span('quant.act_backward'):
            return g, None


class _FakeQuantSelectGlobal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits):
        return fake_quant_per_tensor_global(x if _dense(x) else x.contiguous(), bits,
                                            select=True)

    @staticmethod
    def backward(ctx, g):
        with span('quant.act_backward'):
            return g, None


class _FakeQuantGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bits, *xs):
        return tuple(fake_quant_per_tensor_group([x.contiguous() for x in xs], bits))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _FakeQuantGroupGlobal(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bits, *xs):
        return tuple(fake_quant_per_tensor_group_global([x.contiguous() for x in xs], bits))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *grads)


class _FakeQuantColumnGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, bits, bucket_size, select, *xs):
        return tuple(fake_quant_per_column_group([x.contiguous() for x in xs], bits,
                                                 bucket_size, select))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, None, *grads)


class _FakeQuantBucket(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bits, bucket_size):
        # a group of one, quantized at any bits (the reference's per-site ops
        # have no select), in fp32
        q = fake_quant_per_column_group([x.float().contiguous()], bits.reshape(1), bucket_size,
                                        select=False)[0]
        return q.to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def fake_quant(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-tensor fake-quantization with STE."""
    return _FakeQuant.apply(x, bits)


def fake_quant_select(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """fake_quant(x, bits) where bits < 32, else x, with STE: the quant
    policy's activation route, where the reference takes
    jnp.where(bits < 32, fake_quant(x, bits), x), in one kernel launch pair
    with the select inside.  The gradient is the identity on both sides of
    32, as both branches of the reference's where pass it through."""
    return _FakeQuantSelect.apply(x, bits)


def fake_quant_select_global(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """fake_quant_select against the range of x over every rank's rows:
    the activation route under data parallelism, where the JAX package
    takes the min and max of a batch-sharded tensor."""
    return _FakeQuantSelectGlobal.apply(x, bits)


def fake_quant_act_select(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """The quant policies' activation op: fake_quant_select at world size 1,
    fake_quant_select_global under data parallelism."""
    if mesh.num_workers() > 1:
        return fake_quant_select_global(x, bits)
    return fake_quant_select(x, bits)


def fake_quant_group(xs: Sequence[torch.Tensor], bits: torch.Tensor) -> List[torch.Tensor]:
    """Per-tensor fake-quantization of each xs[t] at bits[t] with STE, xs[t]
    itself where bits[t] >= 32 (the select of the per-site route, whose
    gradient is the identity too), all tensors in one kernel launch pair."""
    return list(_FakeQuantGroup.apply(bits, *xs))


def fake_quant_group_global(xs: Sequence[torch.Tensor], bits: torch.Tensor) -> List[torch.Tensor]:
    """fake_quant_group with each tensor's range over the model group: the
    weights' route under tensor parallelism, where the JAX package takes the
    min and max of a kernel sharded along its output axis."""
    return list(_FakeQuantGroupGlobal.apply(bits, *xs))


def fake_quant_bucket_group(xs: Sequence[torch.Tensor], bits: torch.Tensor, bucket_type: str,
                            bucket_size: int, select: bool = True) -> List[torch.Tensor]:
    """Bucketed fake-quantization of each xs[t] at bits[t] with STE, all
    tensors in one kernel launch pair: 'channel' buckets (per output
    channel, the last axis) or 'split' buckets of bucket_size, each tensor's
    result equal to fake_quant_channel_bucket's or fake_quant_split_bucket's.
    With `select`, xs[t] itself where bits[t] >= 32 (the select of the
    per-site route); without it every tensor is quantized, as the per-site
    ops quantize.  Under tensor parallelism a sharded kernel's channel
    buckets are its own columns; its split buckets are taken over the full
    kernel, gathered over the model group, of which it keeps its columns."""
    if bucket_type == 'channel':
        size = None
    elif bucket_type == 'split':
        size = int(bucket_size)
    else:
        raise ValueError('unrecognized bucket type: ' + bucket_type)
    # split buckets cross the shards of a kernel split along its last axis:
    # quantize the full kernel and keep this rank's columns
    sharded = [size is not None and isinstance(x, mesh.ModelShard) for x in xs]
    full = [mesh.gather_model(x) if cut else x for x, cut in zip(xs, sharded)]
    out = _FakeQuantColumnGroup.apply(bits, size, select, *full)
    return [mesh.shard_tensor(q, mesh.shard(-1)) if cut else q for q, cut in zip(out, sharded)]


def fake_quant_split_bucket(x: torch.Tensor, bits: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Split-bucket fake-quantization with STE: flatten, pad with the LAST
    element to a multiple of bucket_size, scale per bucket."""
    return _FakeQuantBucket.apply(x, bits, int(bucket_size))


def fake_quant_channel_bucket(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """Per-output-channel fake-quantization with STE: reshape [-1, c_out] and
    scale per column.  For HWIO conv kernels and [c_in, c_out] dense kernels
    the last axis is c_out."""
    return _FakeQuantBucket.apply(x, bits, None)


def _nudged_range(range_min: torch.Tensor, range_max: torch.Tensor, bits: torch.Tensor):
    """TF FakeQuantWithMinMaxVars' zero-point nudge: (min, max) shifted so
    that the zero point lands on the integer grid, and the scale.  Returns
    fp32 (nudged_min, nudged_max, scale)."""
    k = _levels(bits)
    scale = (range_max - range_min).to(torch.float32) / k + EPS
    zero_point = torch.round(torch.clamp(-range_min.to(torch.float32) / scale, min=0.0).minimum(k))
    return -zero_point * scale, (k - zero_point) * scale, scale


class _FakeQuantWithRange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, range_min, range_max, bits):
        nmin, nmax, scale = _nudged_range(range_min, range_max, bits)
        x32 = x.to(torch.float32)
        q = torch.round((torch.minimum(torch.maximum(x32, nmin), nmax) - nmin) / scale)
        # the gradient's mask: the x of the input dtype against the fp32
        # bounds, compared in fp32
        ctx.save_for_backward((x32 >= nmin) & (x32 <= nmax))
        return (q * scale + nmin).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        with span('quant.act_backward'):
            in_range, = ctx.saved_tensors
            return g * in_range.to(g.dtype), None, None, None


def fake_quant_with_range(x: torch.Tensor, range_min: torch.Tensor, range_max: torch.Tensor,
                          bits: torch.Tensor) -> torch.Tensor:
    """Fake-quantize against an externally tracked range (the moving-average
    (min, max) of the uniform-tf learner), with the zero-point nudge of
    FakeQuantWithMinMaxVars: clip to the nudged range, round half to even on
    its grid.  The STE passes the gradient only where nudged_min <= x <=
    nudged_max.  Plain PyTorch on every device: the reference leaves this op
    to XLA and has no kernel for it."""
    return _FakeQuantWithRange.apply(x, range_min, range_max, bits)


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
