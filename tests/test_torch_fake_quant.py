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
    """K2 (_fq_pallas_cols_grid) in interpret mode, 128-column stripes."""
    x = np.random.default_rng(3).normal(size=shape).astype(np.float32)
    k = jnp.exp2(jnp.float32(4)) - 1.0
    want = np.asarray(_pallas_per_column(jnp.asarray(x), k))
    np.testing.assert_allclose(want, np.asarray(jfq._quantize_math(jnp.asarray(x), k, 0)), **TOL)
    got = tfq.fake_quant_per_column(torch.from_numpy(x), _bits(4)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


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


@pytest.mark.parametrize('op', ['split', 'channel'])
def test_ste_gradient_split_and_channel(op):
    x = torch.from_numpy(np.random.default_rng(7).normal(size=(8, 16)).astype(np.float32))
    x.requires_grad_(True)
    if op == 'split':
        out = tfq.fake_quant_split_bucket(x, _bits(4), 32)
    else:
        out = tfq.fake_quant_channel_bucket(x, _bits(4))
    out.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones((8, 16), np.float32))


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
    """The per-column kernels' grid (132 SMs, as on an H100): the chunks
    tile the rows exactly, each holds at least 64 rows unless the matrix has
    fewer, and the grid's second axis stays within CUDA's 65535."""
    chunk, nchunks = tfq._row_chunks(rows, cols, 132)
    assert (nchunks - 1) * chunk < rows <= nchunks * chunk
    assert chunk >= min(rows, tfq._MIN_CHUNK_ROWS) and 1 <= nchunks <= 65535
    if rows >= 64 * 4 * 132:  # a narrow, tall matrix still gives every SM a block
        assert nchunks * -(-cols // tfq._COL_TILE) >= 132


def test_cpu_tensors_take_the_plain_version():
    tfq.reset_counters()
    x = torch.randn(4, 8)
    tfq.fake_quant(x, _bits(4))
    tfq.fake_quant_channel_bucket(x, _bits(4))
    assert tfq.counters() == {'fake_quant_per_tensor': 0, 'fake_quant_per_column': 0,
                              'plain': 2}
