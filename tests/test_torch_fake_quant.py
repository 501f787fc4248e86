"""Parity of the port's fake-quant ops (pocketflow_tpu_torch/ops/fake_quant.py)
with the JAX package: its XLA formula `_quantize_math`, the numpy oracle of
tests/test_fake_quant.py, and the Pallas kernel bodies run in interpret mode
with the package's own BlockSpecs.  On the CPU the port runs its plain
PyTorch version; the CUDA kernels are compared with it on the card in
tests/test_torch_cuda.py.  Tolerance everywhere: rtol=1e-5, atol=1e-6 (fp32 formula,
different compilers)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pocketflow_tpu.ops import fake_quant as jfq
from pocketflow_tpu_torch.ops import fake_quant as tfq
from test_fake_quant import _np_fake_quant

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)


def _bits(b):
    return torch.tensor(float(b))


def _pallas_per_tensor(x2d, k):
    """_fq_pallas_2d's pallas_call, in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    return pl.pallas_call(
        jfq._fq_tensor_kernel,
        out_shape=jax.ShapeDtypeStruct(x2d.shape, x2d.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(x2d, k.reshape(1))


def _pallas_per_column(x2d, k):
    """_fq_pallas_cols_grid's pallas_call, in interpret mode."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    rows, cols = x2d.shape
    return pl.pallas_call(
        jfq._fq_axis0_kernel,
        grid=(pl.cdiv(cols, jfq._COL_TILE),),
        out_shape=jax.ShapeDtypeStruct(x2d.shape, x2d.dtype),
        in_specs=[pl.BlockSpec((rows, jfq._COL_TILE), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.SMEM)],
        out_specs=pl.BlockSpec((rows, jfq._COL_TILE), lambda i: (0, i),
                               memory_space=pltpu.VMEM),
        interpret=True)(x2d, k.reshape(1))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bits', [2, 4, 8, 32])
def test_select_matches_jax_where(bits, dtype):
    """fake_quant_select against the JAX policy's activation route,
    jnp.where(bits < 32, fake_quant(act, bits).astype(dtype), act), on a
    channels-last activation: bit for bit, layout kept."""
    x = np.maximum(np.random.default_rng(10).normal(size=(2, 6, 5, 3)), 0).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)  # NHWC, the layout of the JAX package
    jbits = jnp.asarray(float(bits))
    want = jnp.where(jbits < 32, jfq.fake_quant(jx, jbits).astype(jx.dtype), jx)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)  # NCHW, channels last
    assert tx.is_contiguous(memory_format=torch.channels_last)
    got = tfq.fake_quant_select(tx, _bits(bits))
    assert got.dtype == tx.dtype and got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize('bits', [2, 4, 8])
def test_per_tensor_matches_numpy_oracle(bits):
    x = np.random.default_rng(0).normal(size=(37, 19)).astype(np.float32)
    got = tfq.fake_quant(torch.from_numpy(x), _bits(bits)).numpy()
    np.testing.assert_allclose(got, _np_fake_quant(x, bits), **TOL)


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_per_tensor_matches_quantize_math(dtype):
    x = np.random.default_rng(1).normal(size=(3, 3, 16, 8)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jfq.fake_quant(jx, jnp.asarray(4.0)).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = tfq.fake_quant(tx, _bits(4))
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, **TOL)


@pytest.mark.parametrize('bits', [2, 4, 8])
def test_per_tensor_matches_pallas_kernel_body(bits):
    """K1 (_fq_pallas_2d) in interpret mode, on the package's [rows, 128]
    layout padded with x[0]."""
    x = np.random.default_rng(2).normal(size=(3, 3, 64, 24)).astype(np.float32)
    k = jnp.exp2(jnp.float32(bits)) - 1.0
    x2d, (n, _) = jfq._pad_to_2d(jnp.asarray(x))
    want = np.asarray(_pallas_per_tensor(x2d, k)).reshape(-1)[:n].reshape(x.shape)
    np.testing.assert_allclose(want, np.asarray(jfq._quantize_math(jnp.asarray(x), k, None)),
                               **TOL)
    got = tfq.fake_quant_per_tensor(torch.from_numpy(x), _bits(bits)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('shape', [(256, 384), (72, 128), (8, 256)])
def test_per_column_matches_pallas_kernel_body(shape):
    """K2 (_fq_pallas_cols_grid) in interpret mode, 128-column stripes,
    against the grouped per-column op on one matrix (channel buckets of a
    [rows, cols] matrix are its columns) without the select."""
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    k = jnp.exp2(jnp.float32(4)) - 1.0
    want = np.asarray(_pallas_per_column(jnp.asarray(x), k))
    np.testing.assert_allclose(want, np.asarray(jfq._quantize_math(jnp.asarray(x), k, 0)), **TOL)
    got = tfq.fake_quant_per_column_group([torch.from_numpy(x)], torch.tensor([4.0]), None,
                                          select=False)[0].numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize('shape', [(3, 3, 8, 16), (25, 11), (1, 1, 64, 256)])
@pytest.mark.parametrize('op', ['channel', 'split-7', 'split-256'])
def test_per_site_bucket_ops_quantize_at_32_bits(shape, op):
    """The per-site bucket ops have no select, as the JAX package's: at 32
    bits they quantize (k = 2^32 - 1), and equal JAX's ops bit for bit."""
    x = np.random.default_rng(12).normal(size=shape).astype(np.float32)
    bits = jnp.asarray(32.0)
    if op == 'channel':
        got = tfq.fake_quant_channel_bucket(torch.from_numpy(x), _bits(32))
        want = jfq.fake_quant_channel_bucket(jnp.asarray(x), bits)
    else:
        size = int(op.split('-')[1])
        got = tfq.fake_quant_split_bucket(torch.from_numpy(x), _bits(32), size)
        want = jfq.fake_quant_split_bucket(jnp.asarray(x), bits, size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != x).any()  # quantized, not copied


@pytest.mark.parametrize('bucket_size', [None, 7, 256])
def test_column_group_without_select_quantizes_at_32_bits(bucket_size):
    """The grouped per-column op without the select quantizes a tensor at
    32 bits as JAX's _quantize_math does on its column view; with the select
    it copies it."""
    rng = np.random.default_rng(13)
    xs = [rng.normal(size=s).astype(np.float32) for s in ((3, 3, 8, 16), (25, 11), (300,))]
    if bucket_size is None:
        xs = xs[:2]
    bits = torch.full((len(xs),), 32.0)
    got = tfq.fake_quant_per_column_group([torch.from_numpy(x) for x in xs], bits, bucket_size,
                                          select=False)
    copied = tfq.fake_quant_per_column_group([torch.from_numpy(x) for x in xs], bits, bucket_size)
    k = jnp.exp2(jnp.float32(32)) - 1.0
    for x, g, c in zip(xs, got, copied):
        rows, cols = tfq._column_view(x.shape, bucket_size)
        flat = np.concatenate([x.reshape(-1), np.full(rows * cols - x.size, x.reshape(-1)[-1],
                                                      np.float32)])
        want = np.asarray(jfq._quantize_math(jnp.asarray(flat.reshape(rows, cols)), k, 0))
        np.testing.assert_array_equal(g.numpy(), want.reshape(-1)[:x.size].reshape(x.shape))
        np.testing.assert_array_equal(c.numpy(), x)


@pytest.mark.parametrize('shape,bucket_size', [((25, 11), 64), ((3, 3, 8, 16), 256),
                                                ((1, 1, 64, 256), 256)])
def test_split_bucket_matches_numpy_and_jax(shape, bucket_size):
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    flat = x.reshape(-1)
    nb_buckets = -(-flat.size // bucket_size)
    pad = nb_buckets * bucket_size - flat.size
    padded = np.concatenate([flat, np.full(pad, flat[-1], np.float32)]) if pad else flat
    want = _np_fake_quant(padded.reshape(bucket_size, nb_buckets), 4, axis=0)
    want = want.reshape(-1)[:flat.size].reshape(shape)
    got = tfq.fake_quant_split_bucket(torch.from_numpy(x), _bits(4), bucket_size).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    jgot = np.asarray(jfq.fake_quant_split_bucket(jnp.asarray(x), jnp.asarray(4.0), bucket_size))
    np.testing.assert_allclose(got, jgot, **TOL)


@pytest.mark.parametrize('shape', [(3, 3, 8, 16), (1, 1, 32, 64), (2048, 1001)])
def test_channel_bucket_matches_numpy_and_jax(shape):
    x = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    got = tfq.fake_quant_channel_bucket(torch.from_numpy(x), _bits(4)).numpy()
    want = _np_fake_quant(x.reshape(-1, shape[-1]), 4, axis=0).reshape(shape)
    np.testing.assert_allclose(got, want, **TOL)
    jgot = np.asarray(jfq.fake_quant_channel_bucket(jnp.asarray(x), jnp.asarray(4.0)))
    np.testing.assert_allclose(got, jgot, **TOL)


def test_per_tensor_levels():
    x = torch.linspace(-1, 1, 1000)
    assert len(torch.unique(tfq.fake_quant(x, _bits(3)))) <= 8


def test_ste_gradient_is_identity():
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(64,)).astype(np.float32))
    x.requires_grad_(True)
    q = tfq.fake_quant(x, _bits(4))
    (q ** 2).sum().backward()
    # STE: d/dx sum(q(x)^2) = 2*q(x) * 1, as jax.grad of the JAX op gives
    want = np.asarray(jax.grad(lambda v: jnp.sum(jfq.fake_quant(v, jnp.asarray(4.0)) ** 2))(
        jnp.asarray(x.detach().numpy())))
    np.testing.assert_allclose(x.grad.numpy(), 2 * q.detach().numpy(), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want, **TOL)


@pytest.mark.parametrize('op', ['split', 'channel', 'select-4', 'select-32', 'channel-group',
                                'split-group'])
def test_ste_gradient_split_and_channel(op):
    """The STE gradient is the identity: of the bucket ops, of their grouped
    route (bits 4 and 32 in one group) and of fake_quant_select on both
    sides of 32."""
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 16)).astype(np.float32))
    x.requires_grad_(True)
    if op == 'split':
        out = tfq.fake_quant_split_bucket(x, _bits(4), 32)
    elif op == 'channel':
        out = tfq.fake_quant_channel_bucket(x, _bits(4))
    elif op.startswith('select'):
        out = tfq.fake_quant_select(x, _bits(int(op.split('-')[1])))
    else:
        outs = tfq.fake_quant_bucket_group([x, x * 2], torch.tensor([4.0, 32.0]),
                                           op.split('-')[0], 32)
        out = outs[0] + outs[1] / 2
    out.sum().backward()
    want = np.full((8, 16), 2.0 if op.endswith('group') else 1.0, np.float32)
    np.testing.assert_array_equal(x.grad.numpy(), want)


@pytest.mark.parametrize('shape,bucket_type,bucket_size', [
    ((25, 11), 'split', 64), ((3, 3, 8, 16), 'channel', 0),
    ((3, 3, 512, 512), 'split', 256), ((2048, 1001), 'channel', 256)])
def test_bucket_storage_accounting_matches_jax(shape, bucket_type, bucket_size):
    assert (tfq.bucket_storage_bits(shape, bucket_type, bucket_size)
            == jfq.bucket_storage_bits(shape, bucket_type, bucket_size))


def test_quantized_model_bits_matches_jax():
    shapes = [(10, 10), (3, 3, 4, 8), (1, 1, 8, 32)]
    bits = [8, 4, 2]
    for bucket_type in (None, 'split', 'channel'):
        assert (tfq.quantized_model_bits(shapes, bits, bucket_type, 50)
                == jfq.quantized_model_bits(shapes, bits, bucket_type, 50))
    with pytest.raises(ValueError):
        tfq.bucket_storage_bits((4, 4), 'rows', 4)


@pytest.mark.parametrize('rows,cols', [(576, 64), (4608, 512), (256, 9216), (2048, 1001),
                                       (1, 1), (63, 7), (100000, 3)])
def test_per_column_row_chunks_cover_the_rows(rows, cols):
    """The grouped per-column kernel's chunks of one [rows, cols] matrix
    (the per-site bucket ops' group of one): each column tile's row chunks
    tile the rows exactly, in order, and the grid (one block a chunk) stays
    within CUDA's 2^31 - 1."""
    offsets, first_chunks, row_chunks, chunk_tensor, total = tfq._column_group_plan(
        [(rows * cols, rows, cols)])
    assert offsets == [0] and first_chunks == [0] and total == -(-rows * cols // 4) * 4
    per_tile = row_chunks[0]
    assert (per_tile - 1) * tfq._COL_GROUP_ROWS < rows <= per_tile * tfq._COL_GROUP_ROWS
    assert chunk_tensor == [0] * (-(-cols // tfq._COL_TILE) * per_tile)
    starts = [(c % per_tile) * tfq._COL_GROUP_ROWS for c in range(len(chunk_tensor))]
    ends = [min(r0 + tfq._COL_GROUP_ROWS, rows) for r0 in starts]
    for tile in range(-(-cols // tfq._COL_TILE)):  # consecutive, no gap, no overlap
        tile_starts = starts[tile * per_tile:(tile + 1) * per_tile]
        tile_ends = ends[tile * per_tile:(tile + 1) * per_tile]
        assert tile_starts[0] == 0 and tile_ends[-1] == rows
        assert tile_starts[1:] == tile_ends[:-1]
    assert len(chunk_tensor) < 2 ** 31


def test_cpu_tensors_take_the_plain_version():
    tfq.reset_counters()
    x = torch.randn(4, 8)
    tfq.fake_quant(x, _bits(4))
    tfq.fake_quant_select(x, _bits(4))
    tfq.fake_quant_channel_bucket(x, _bits(4))
    tfq.fake_quant_group([x, x], torch.tensor([4.0, 32.0]))
    tfq.fake_quant_bucket_group([x, x], torch.tensor([4.0, 32.0]), 'split', 4)
    tfq.fake_quant_select_global(x, _bits(4))
    tfq.fake_quant_group_global([x, x], torch.tensor([4.0, 32.0]))
    assert tfq.counters() == {'fake_quant_per_tensor': 0, 'fake_quant_per_tensor_select': 0,
                              'fake_quant_per_tensor_global': 0,
                              'fake_quant_per_tensor_group': 0,
                              'fake_quant_per_tensor_group_global': 0,
                              'fake_quant_per_column_group': 0, 'plain': 7}


# a few weight shapes of ResNet-50 (HWIO) and odd sizes, for the grouped op
GROUP_SHAPES = [(1, 1, 64, 64), (3, 3, 64, 64), (1, 1, 64, 256), (1, 1, 256, 64), (7,),
                (1, 1, 512, 128), (3, 3, 16, 8), (5, 3)]


@pytest.mark.parametrize('bits', [[2, 4, 8, 32, 3, 32, 8, 4], [32] * 8, [4] * 8,
                                  [8, 2, 32, 4, 8, 2, 32, 4]])
def test_group_matches_jax_fake_quant_per_tensor(bits):
    """The grouped op's plain version, tensor by tensor, against the JAX
    package's per-site route: jnp.where(bits < 32, fake_quant(x, bits), x).
    Bit-equal (fp32)."""
    rng = np.random.default_rng(8)
    xs = [(0.05 * rng.normal(size=s)).astype(np.float32) for s in GROUP_SHAPES]
    bits = np.asarray(bits, np.float32)
    got = tfq.fake_quant_per_tensor_group([torch.from_numpy(x) for x in xs],
                                          torch.from_numpy(bits))
    assert len(got) == len(xs)
    for x, b, g in zip(xs, bits, got):
        want = jnp.where(b < 32, jfq.fake_quant(jnp.asarray(x), jnp.asarray(b)), jnp.asarray(x))
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


def test_group_ste_gradient_is_identity():
    rng = np.random.default_rng(9)
    xs = [torch.from_numpy(rng.normal(size=s).astype(np.float32)).requires_grad_(True)
          for s in GROUP_SHAPES]
    qs = tfq.fake_quant_group(xs, torch.tensor([4.0, 32.0, 2.0, 8.0, 4.0, 32.0, 3.0, 4.0]))
    weights = [torch.from_numpy(rng.normal(size=s).astype(np.float32)) for s in GROUP_SHAPES]
    sum((q * w).sum() for q, w in zip(qs, weights)).backward()
    for x, w in zip(xs, weights):
        np.testing.assert_array_equal(x.grad.numpy(), w.numpy())


@pytest.mark.parametrize('sizes', [[4096, 36864, 16384, 7, 1], [2359296, 16385, 3, 5, 16384],
                                   [1]])
def test_group_plan_covers_every_element_once(sizes):
    """The grouped kernel's chunk table: each tensor's chunks are consecutive
    and cover it, and each output starts on a 16-byte boundary of its own
    span of the flat output."""
    offsets, first_chunks, chunk_tensor, total = tfq._group_plan(sizes)
    chunk = tfq._GROUP_CHUNK
    assert len(chunk_tensor) == sum(-(-n // chunk) for n in sizes)
    for t, n in enumerate(sizes):
        assert offsets[t] % 4 == 0
        assert offsets[t] + n <= (offsets[t + 1] if t + 1 < len(sizes) else total)
        nchunks = chunk_tensor.count(t)
        assert chunk_tensor[first_chunks[t]:first_chunks[t] + nchunks] == [t] * nchunks
        assert (nchunks - 1) * chunk < n <= nchunks * chunk
    assert total == sum(-(-n // 4) * 4 for n in sizes)


def test_group_table_is_built_once_per_group():
    """The device tables of a group are kept by (address, shape) of its
    tensors: the same parameters give the same tables (no copy to the
    device), a reshaped view or a new tensor new ones, and at most
    _GROUP_TABLES groups are kept."""
    tfq._group_tables.clear()
    xs = [torch.randn(s) for s in GROUP_SHAPES]
    entries, chunk_tensor, layout, total = tfq._group_table(xs)
    assert tfq._group_table(xs)[0] is entries
    offsets, first_chunks, chunks, want_total = tfq._group_plan([x.numel() for x in xs])
    assert total == want_total and chunk_tensor.tolist() == chunks
    assert entries.tolist() == [[x.data_ptr(), o, x.numel(), f]
                                for x, o, f in zip(xs, offsets, first_chunks)]
    flat = torch.arange(total, dtype=torch.float32)
    for x, o, (shape, strides, offset) in zip(xs, offsets, layout):
        view = flat.as_strided(shape, strides, offset)
        assert view.shape == x.shape and view.is_contiguous() and float(view.reshape(-1)[0]) == o
    assert tfq._group_table([xs[0].reshape(-1)] + xs[1:])[0] is not entries
    others = [torch.randn(3) for _ in range(tfq._GROUP_TABLES)]  # alive: distinct addresses
    for other in others:
        tfq._group_table([other])
    assert len(tfq._group_tables) == tfq._GROUP_TABLES
    assert tfq._group_table(xs)[0] is not entries
    tfq._group_tables.clear()


def test_group_rejects_what_the_kernel_does_not_take():
    x = torch.randn(4, 8)
    for xs, bits in (([], torch.ones(0)),
                     ([x.to(torch.bfloat16)], torch.ones(1)),
                     ([x.t()], torch.ones(1)),
                     ([x, x], torch.ones(1)),
                     ([x], torch.ones((), dtype=torch.float32)),
                     ([x], torch.ones(1, dtype=torch.float64))):
        with pytest.raises(ValueError):
            tfq.fake_quant_per_tensor_group(xs, bits)


# weight shapes of ResNet-50 (HWIO) and odd sizes, for the grouped per-column
# op: split buckets of 256 pad all but the multiples of 256
COLUMN_GROUP_SHAPES = [(1, 1, 64, 64), (3, 3, 64, 64), (1, 1, 64, 256), (7, 3), (300,),
                       (3, 3, 16, 8), (1, 1, 512, 128), (2, 2, 5, 33)]


@pytest.mark.parametrize('bucket_type,bucket_size', [('channel', 0), ('split', 256),
                                                     ('split', 7), ('split', 1)])
@pytest.mark.parametrize('bits', [[2, 4, 8, 32, 3, 32, 8, 4], [4] * 8])
def test_column_group_matches_jax_buckets(bucket_type, bucket_size, bits):
    """The grouped per-column op's plain version, tensor by tensor, against
    the JAX policy's bucket route: jnp.where(bits < 32,
    fake_quant_{channel,split}_bucket(x, bits), x).  Bit-equal (fp32)."""
    rng = np.random.default_rng(11)
    xs = [(0.05 * rng.normal(size=s)).astype(np.float32) for s in COLUMN_GROUP_SHAPES]
    bits = np.asarray(bits, np.float32)
    got = tfq.fake_quant_bucket_group([torch.from_numpy(x) for x in xs], torch.from_numpy(bits),
                                      bucket_type, bucket_size)
    assert len(got) == len(xs)
    for x, b, g in zip(xs, bits, got):
        jb = jnp.asarray(b)
        if bucket_type == 'channel':
            q = jfq.fake_quant_channel_bucket(jnp.asarray(x), jb)
        else:
            q = jfq.fake_quant_split_bucket(jnp.asarray(x), jb, bucket_size)
        want = jnp.where(jb < 32, q, jnp.asarray(x))
        assert g.shape == x.shape and g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))


@pytest.mark.parametrize('bucket_size', [None, 256, 7, 1])
def test_column_group_plan_covers_every_element_once(bucket_size):
    """The grouped per-column kernel's chunk table, walked as the kernel
    walks it (chunk -> tensor, column tile, row range; element (r, c) at
    r * cols + c): every element of every tensor is written by exactly one
    chunk, each tile's row chunks are consecutive, the elements past n (the
    split pad) are read as x[n - 1] and never written, and each output
    starts on a 16-byte boundary of its own span of the flat output."""
    shapes = COLUMN_GROUP_SHAPES + [(3, 3, 512, 512), (1, 1, 2048, 3)]
    if bucket_size is None:
        shapes = [s for s in shapes if len(s) > 1]
    views = [(int(np.prod(s)), *tfq._column_view(s, bucket_size)) for s in shapes]
    offsets, first_chunks, row_chunks, chunk_tensor, total = tfq._column_group_plan(views)
    written = [np.zeros(n, np.int64) for n, _, _ in views]
    padded_reads = [0] * len(views)
    for c, t in enumerate(chunk_tensor):
        n, rows, cols = views[t]
        local = c - first_chunks[t]
        tile, rchunk = divmod(local, row_chunks[t])
        r = np.arange(rchunk * tfq._COL_GROUP_ROWS, min((rchunk + 1) * tfq._COL_GROUP_ROWS, rows))
        col = tile * tfq._COL_TILE + np.arange(tfq._COL_TILE)
        index = (r[:, None] * cols + col[None, col < cols]).reshape(-1)
        np.add.at(written[t], index[index < n], 1)
        padded_reads[t] += int((index >= n).sum())
    for t, (n, rows, cols) in enumerate(views):
        assert rows * cols >= n and (written[t] == 1).all()
        assert padded_reads[t] == rows * cols - n
        assert chunk_tensor.count(t) == -(-cols // tfq._COL_TILE) * row_chunks[t]
        assert offsets[t] % 4 == 0
        assert offsets[t] + n <= (offsets[t + 1] if t + 1 < len(views) else total)
    assert sorted(chunk_tensor) == chunk_tensor


def test_column_group_rejects_what_the_kernel_does_not_take():
    x = torch.randn(4, 8)
    for xs, bits, bucket_size in (([], torch.ones(0), None),
                                  ([x.to(torch.bfloat16)], torch.ones(1), None),
                                  ([x.t()], torch.ones(1), None),
                                  ([x, x], torch.ones(1), None),
                                  ([x], torch.ones(1, dtype=torch.float64), 4),
                                  ([torch.ones(())], torch.ones(1), None),
                                  ([x], torch.ones(1), 0)):
        with pytest.raises(ValueError):
            tfq.fake_quant_per_column_group(xs, bits, bucket_size)
    with pytest.raises(ValueError, match='bucket type'):
        tfq.fake_quant_bucket_group([x], torch.ones(1), 'rows', 4)
