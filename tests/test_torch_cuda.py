"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc`: without a card they skip.  They
import no jax, so on the card they run without tests/conftest.py (which pins
the JAX package to a CPU mesh):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerance: none.  The kernels round every step of the fp32 formula as the
plain version does, so the two agree bit for bit.
"""

import pytest
import torch

from pocketflow_tpu_torch.ops import fake_quant as tfq


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    return torch.device('cuda')


def _inputs(device, shape, dtype, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device).to(dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('bits', [2, 4, 8])
@pytest.mark.parametrize('shape,dtype', [((3, 3, 64, 64), torch.float32),
                                         ((1, 1, 1024, 2048), torch.float32),
                                         ((7,), torch.float32),
                                         ((1025,), torch.bfloat16),
                                         ((8, 64, 56, 56), torch.bfloat16)])
def test_per_tensor_kernel_equals_plain(cuda, bits, shape, dtype):
    x = _inputs(cuda, shape, dtype)
    bits = torch.tensor(float(bits), device=cuda)
    want = tfq._quantize_math_torch(x, tfq._levels(bits), None).to(dtype)
    got = tfq.fake_quant_per_tensor(x, bits)
    torch.cuda.synchronize()
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.gpu
def test_per_tensor_kernel_keeps_channels_last(cuda):
    x = _inputs(cuda, (4, 32, 9, 9), torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bits = torch.tensor(8.0, device=cuda)
    got = tfq.fake_quant_per_tensor(x, bits)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, tfq._quantize_math_torch(x, tfq._levels(bits), None).to(x.dtype))


@pytest.mark.gpu
@pytest.mark.parametrize('bits', [2, 4, 8])
@pytest.mark.parametrize('shape', [(4608, 512), (256, 9216), (1, 1), (300, 33), (2048, 1001),
                                   (576, 64), (100000, 3)])
def test_per_column_kernel_equals_plain(cuda, bits, shape):
    x = _inputs(cuda, shape, torch.float32, seed=1)
    bits = torch.tensor(float(bits), device=cuda)
    want = tfq._quantize_math_torch(x, tfq._levels(bits), 0)
    got = tfq.fake_quant_per_column(x, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_inputs(cuda):
    tfq.reset_counters()
    bits = torch.tensor(4.0, device=cuda)
    tfq.fake_quant(_inputs(cuda, (64, 64), torch.float32), bits)
    tfq.fake_quant_split_bucket(_inputs(cuda, (3, 3, 8, 16), torch.float32), bits, 256)
    assert tfq.counters() == {'fake_quant_per_tensor': 1, 'fake_quant_per_column': 1,
                              'plain': 0}
    with pytest.raises(ValueError):
        tfq.fake_quant_per_column(_inputs(cuda, (8, 8), torch.bfloat16), bits)
    with pytest.raises(ValueError):
        tfq.fake_quant_per_tensor(_inputs(cuda, (8, 8), torch.float32), bits.cpu())
