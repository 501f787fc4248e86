"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and `nvcc`: without a card they skip.  They
import no jax, so on the card they run without tests/conftest.py (which pins
the JAX package to a CPU mesh):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: none for the fake-quant kernels, which round every step of the
fp32 formula as the plain version does (K1' reads its outputs from tables
built with the same steps).  The matmul kernels sum the fp32
products on the tensor cores, in another order and rounding than the plain
version's fp32 matmul, so y may differ where the two fp32 sums round to
different bf16 values: by one bf16 ulp, or, where the sum cancels, by up to
2^-20 of the sum of the products' magnitudes, in at most 2e-3 of the
elements (measured on an H100: 1.15e-3 at K=2048, exactly as many as
cuBLAS's own bf16 GEMM shows against the same plain version; integer inputs,
whose sums are exact, give equal results: y, s and ss alike).  The column
sums s are held within 3e-6 of each column's sum of |y32|, ss within 5e-6
relative: on an H100 the kernel reads at most 3.8e-7 and 4.6e-7 at
M=802,816, while counting rows past M or summing bf16 y reads 2.6e-5 (s) or
1.8e-5 (ss) even at M=801,816.
"""

import pytest
import torch

from pocketflow_tpu_torch.ops import fake_quant as tfq
from pocketflow_tpu_torch.ops import matmul as tmm


# bn_relu_matmul_stats' column sums against float64 sums of the bf16 z and w:
# about five times the kernel's readings on an H100 (s 2.1e-7, ss 3.9e-7)
K3_S_TOL64, K3_SS_TOL64 = 1e-6, 2e-6


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


def _activation(device, case):
    """An input of K1' on the 8-bit activation route, or one of its edges:
    bf16 channels-last relu outputs, fp32, ragged sizes and views that start
    off a 16-byte boundary."""
    if case == 'bf16 channels-last':
        x = torch.relu(_inputs(device, (16, 256, 56, 56), torch.bfloat16))
        return x.contiguous(memory_format=torch.channels_last)
    if case == 'bf16 channels-last 7x7':
        x = torch.relu(_inputs(device, (32, 2048, 7, 7), torch.bfloat16))
        return x.contiguous(memory_format=torch.channels_last)
    if case == 'fp32 channels-last':
        return _inputs(device, (8, 64, 28, 28), torch.float32).contiguous(
            memory_format=torch.channels_last)
    if case == 'bf16 odd n':
        return _inputs(device, (1_000_003,), torch.bfloat16)
    if case == 'fp32 odd n':
        return _inputs(device, (3, 5, 7, 11, 13), torch.float32)
    if case == 'bf16 unaligned view':
        return _inputs(device, (70_005,), torch.bfloat16)[3:]
    return _inputs(device, (70_005,), torch.float32)[1:]  # fp32 unaligned view


ACTIVATION_CASES = ['bf16 channels-last', 'bf16 channels-last 7x7', 'fp32 channels-last',
                    'bf16 odd n', 'fp32 odd n', 'bf16 unaligned view', 'fp32 unaligned view']


@pytest.mark.gpu
@pytest.mark.parametrize('bits', [2, 4, 8, 16, 32])
@pytest.mark.parametrize('case', ACTIVATION_CASES)
def test_per_tensor_kernel_with_select_equals_plain(cuda, bits, case):
    """K1' with and without the select equals the plain version (and its
    select) bit for bit; the output keeps the input's layout; at 32 bits the
    select copies."""
    x = _activation(cuda, case)
    bits = torch.tensor(float(bits), device=cuda)
    want = tfq._quantize_math_torch(x, tfq._levels(bits), None).to(x.dtype)
    got = tfq.fake_quant_per_tensor(x, bits)
    selected = tfq.fake_quant_per_tensor(x, bits, select=True)
    torch.cuda.synchronize()
    assert got.dtype == x.dtype and got.stride() == x.stride() and torch.equal(got, want)
    assert torch.equal(selected, torch.where(bits < 32, want, x))


@pytest.mark.gpu
def test_select_ste_and_scratch_reuse(cuda):
    """fake_quant_select's gradient is the identity on both sides of 32, and
    the kernel's scratch is zeroed again after each call, whatever grid the
    previous call ran (large, tiny, 32 bits skipping pass 1)."""
    xs = [_activation(cuda, case) for case in ('bf16 channels-last', 'fp32 odd n')]
    for x in xs + [x.reshape(-1)[:7] for x in xs] + xs:
        for bits_value in (8.0, 32.0, 4.0):
            bits = torch.tensor(bits_value, device=cuda)
            leaf = x.clone().requires_grad_(True)
            out = tfq.fake_quant_select(leaf, bits)
            weight = torch.ones_like(out) * 0.5
            (out * weight).sum().backward()
            want = torch.where(bits < 32, tfq._quantize_math_torch(x, tfq._levels(bits), None)
                               .to(x.dtype), x)
            assert torch.equal(out.detach(), want) and torch.equal(leaf.grad, weight)


@pytest.mark.gpu
@pytest.mark.parametrize('bits', [2, 4, 8, 32])
@pytest.mark.parametrize('shape', [(4608, 512), (256, 9216), (1, 1), (300, 33), (2048, 1001),
                                   (576, 64), (100000, 3)])
def test_per_column_kernel_equals_plain(cuda, bits, shape):
    """The per-column kernel on one [rows, cols] matrix without the select
    (the per-site channel-bucket op's route) equals the plain version, 32
    bits quantized."""
    x = _inputs(cuda, shape, torch.float32, seed=1)
    bits = torch.tensor(float(bits), device=cuda)
    want = tfq._quantize_math_torch(x, tfq._levels(bits), 0)
    got = tfq.fake_quant_per_column_group([x], bits.reshape(1), None, select=False)[0]
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(tfq.fake_quant_channel_bucket(x, bits), want)


@pytest.mark.gpu
def test_wrappers_count_launches_and_reject_bad_inputs(cuda):
    tfq.reset_counters()
    bits = torch.tensor(4.0, device=cuda)
    tfq.fake_quant(_inputs(cuda, (64, 64), torch.float32), bits)
    tfq.fake_quant_select(_inputs(cuda, (64, 64), torch.bfloat16), bits)
    tfq.fake_quant_split_bucket(_inputs(cuda, (3, 3, 8, 16), torch.float32), bits, 256)
    tfq.fake_quant_group([_inputs(cuda, (64, 64), torch.float32)] * 2,
                         torch.tensor([4.0, 32.0], device=cuda))
    tfq.fake_quant_bucket_group([_inputs(cuda, (64, 64), torch.float32)] * 2,
                                torch.tensor([4.0, 32.0], device=cuda), 'channel', 256)
    assert tfq.counters() == {'fake_quant_per_tensor': 2, 'fake_quant_per_tensor_select': 1,
                              'fake_quant_per_tensor_global': 0,
                              'fake_quant_per_tensor_group': 1,
                              'fake_quant_per_column_group': 2, 'plain': 0}
    with pytest.raises(ValueError):
        tfq.fake_quant_per_tensor(_inputs(cuda, (8, 8), torch.float32), bits.cpu())
    with pytest.raises(ValueError):
        tfq.fake_quant_per_tensor(_inputs(cuda, (8, 8), torch.float16), bits, select=True)
    with pytest.raises(ValueError):
        tfq.fake_quant_per_tensor(_inputs(cuda, (8, 8), torch.float32).t()[:, :4], bits)
    x = _inputs(cuda, (8, 8), torch.float32)
    for xs, group_bits in (([x.to(torch.bfloat16)], bits.reshape(1)),
                           ([x.t()], bits.reshape(1)),
                           ([x, x.cpu()], torch.ones(2, device=cuda)),
                           ([x], bits.reshape(1).cpu()),
                           ([x, x], bits.reshape(1))):
        for group in (tfq.fake_quant_per_tensor_group, tfq.fake_quant_per_column_group):
            with pytest.raises(ValueError):
                group(xs, group_bits)
    assert tfq.counters()['fake_quant_per_column_group'] == 2


def resnet50_weight_shapes():
    """The HWIO shapes of the 52 weights a QAT ResNet-50 step quantizes
    (every conv but the stem): per bottleneck 1x1, 3x3 and 1x1 convs, and a
    1x1 projection in the first block of each stage."""
    shapes, cin = [], 64
    for blocks, width in zip((3, 4, 6, 3), (64, 128, 256, 512)):
        for block in range(blocks):
            if block == 0:
                shapes.append((1, 1, cin, 4 * width))
            shapes += [(1, 1, cin, width), (3, 3, width, width), (1, 1, width, 4 * width)]
            cin = 4 * width
    return shapes


@pytest.mark.gpu
@pytest.mark.parametrize('bits_cycle', [(2, 4, 8, 32), (4,), (32,), (8, 3)])
def test_group_kernel_equals_plain_and_per_tensor_kernel(cuda, bits_cycle):
    """At the 52 weight shapes of ResNet-50, with mixed bits (32: copied):
    the grouped kernel equals the plain version and, tensor by tensor, the
    per-tensor kernel, bit for bit."""
    shapes = resnet50_weight_shapes()
    assert len(shapes) == 52
    xs = [0.05 * _inputs(cuda, s, torch.float32, seed=i) for i, s in enumerate(shapes)]
    bits = torch.tensor([float(bits_cycle[i % len(bits_cycle)]) for i in range(52)], device=cuda)
    got = tfq.fake_quant_per_tensor_group(xs, bits)
    again = tfq.fake_quant_per_tensor_group(xs, bits)
    torch.cuda.synchronize()
    for x, b, g, g2 in zip(xs, bits, got, again):
        want = torch.where(b < 32, tfq._quantize_math_torch(x, tfq._levels(b), None), x)
        assert g.shape == x.shape and torch.equal(g, want) and torch.equal(g, g2)
        if b < 32:
            assert torch.equal(g, tfq.fake_quant_per_tensor(x, b))


@pytest.mark.gpu
def test_group_kernel_ste_and_unaligned_inputs(cuda):
    """The STE gradient is the identity, and inputs that start off a 16-byte
    boundary (views) or have a ragged tail take the scalar path."""
    base = _inputs(cuda, (70001,), torch.float32)
    xs = [base[1:50001], base[3:3 + 16385].reshape(5, 29, 113), base[:7]]
    bits = torch.tensor([4.0, 8.0, 2.0], device=cuda)
    got = tfq.fake_quant_per_tensor_group(xs, bits)
    for x, b, g in zip(xs, bits, got):
        assert torch.equal(g, tfq._quantize_math_torch(x, tfq._levels(b), None))
    leaves = [x.clone().requires_grad_(True) for x in xs]
    outs = tfq.fake_quant_group(leaves, bits)
    sum((o * o.detach()).sum() for o in outs).backward()
    for leaf, o in zip(leaves, outs):
        assert torch.equal(leaf.grad, o.detach())


@pytest.mark.gpu
@pytest.mark.parametrize('bucket_size', [None, 256, 7])
@pytest.mark.parametrize('bits_cycle', [(2, 4, 8, 32), (4,), (32,)])
def test_column_group_kernel_equals_plain_and_per_column_kernel(cuda, bucket_size, bits_cycle):
    """At the 52 weight shapes of ResNet-50, channel or split buckets, mixed
    bits (32: copied): the grouped per-column kernel equals the plain version
    and, tensor by tensor, the per-site bucket ops (a group of one without
    the select) below 32 bits, bit for bit, and two runs agree."""
    shapes = resnet50_weight_shapes()
    xs = [0.05 * _inputs(cuda, s, torch.float32, seed=i) for i, s in enumerate(shapes)]
    bits = torch.tensor([float(bits_cycle[i % len(bits_cycle)]) for i in range(52)], device=cuda)
    got = tfq.fake_quant_per_column_group(xs, bits, bucket_size)
    again = tfq.fake_quant_per_column_group(xs, bits, bucket_size)
    torch.cuda.synchronize()
    for x, b, g, g2 in zip(xs, bits, got, again):
        want = torch.where(b < 32, tfq._column_plain(x, tfq._levels(b), bucket_size), x)
        assert g.shape == x.shape and torch.equal(g, want) and torch.equal(g, g2)
        if b < 32:
            per_site = (tfq.fake_quant_channel_bucket(x, b) if bucket_size is None
                        else tfq.fake_quant_split_bucket(x, b, bucket_size))
            assert torch.equal(g, per_site)


@pytest.mark.gpu
@pytest.mark.parametrize('bucket_type', ['channel', 'split'])
def test_column_group_kernel_ste_and_odd_shapes(cuda, bucket_type):
    """The grouped per-column op's STE gradient is the identity, on shapes
    with ragged column tiles and row chunks, split pads of every length, and
    a tensor of one element."""
    shapes = [(7,), (1, 1), (1, 1, 3, 33), (600, 65), (3, 3, 100, 70), (1025, 31)]
    xs = [_inputs(cuda, s, torch.float32, seed=i) for i, s in enumerate(shapes)]
    bits = torch.tensor([4.0, 8.0, 2.0, 32.0, 3.0, 8.0], device=cuda)
    size = None if bucket_type == 'channel' else 64
    leaves = [x.clone().requires_grad_(True) for x in xs]
    outs = tfq.fake_quant_bucket_group(leaves, bits, bucket_type, 64)
    sum((o * o.detach()).sum() for o in outs).backward()
    for x, b, leaf, o in zip(xs, bits, leaves, outs):
        want = torch.where(b < 32, tfq._column_plain(x, tfq._levels(b), size), x)
        assert torch.equal(o.detach(), want) and torch.equal(leaf.grad, o.detach())


def _bf16_ulp(v):
    """The spacing of bf16 values at |v| (fp32 tensor)."""
    _, exponent = torch.frexp(v)
    return torch.ldexp(torch.ones_like(v), exponent - 8)


def _assert_bf16_close(got, want, abs_terms):
    """The bound of the module docstring; abs_terms = |a| @ |b| in fp32."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    bound = torch.maximum(_bf16_ulp(got), _bf16_ulp(want)) + abs_terms * 2.0 ** -20
    assert bool((diff <= bound).all()), float((diff - bound).max())
    assert int((diff > 0).sum()) <= max(1, got.numel() // 500), int((diff > 0).sum())


def _matmul_inputs(device, m, k, n, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=device) * 0.05).to(torch.bfloat16)
    return x, w


# the 8 ResNet-50 1x1 shapes of experiments/mm_shape_sweep.py, the 3 square
# trunk shapes of experiments/conv1x1_ab.py, and ragged edges: M past a
# 128-row tile, K past a 64-deep stage, N past a 64/128/256-column tile
EXPERIMENT_SHAPES = [(802816, 64, 256), (802816, 256, 64), (200704, 128, 512),
                     (200704, 512, 128), (50176, 256, 1024), (50176, 1024, 256),
                     (12544, 512, 2048), (12544, 2048, 512),
                     (802816, 256, 256), (200704, 512, 512), (50176, 1024, 1024)]
RAGGED_SHAPES = [(1, 8, 8), (129, 8, 8), (1000, 8, 8), (129, 40, 24), (1000, 72, 136),
                 (2048, 64, 256), (1000, 200, 264), (1, 520, 264), (777, 520, 72),
                 (30000, 72, 264)]


@pytest.mark.gpu
@pytest.mark.parametrize('m,k,n', EXPERIMENT_SHAPES + RAGGED_SHAPES)
def test_matmul_kernel_equals_plain(cuda, m, k, n):
    x, w = _matmul_inputs(cuda, m, k, n)
    got = tmm.matmul_bf16(x, w)
    torch.cuda.synchronize()
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    _assert_bf16_close(got, tmm._matmul_plain(x, w), x.float().abs() @ w.float().abs())


@pytest.mark.gpu
@pytest.mark.parametrize('m,k,n', [(12544, 2048, 512), (200704, 128, 512), (802816, 64, 256),
                                   (802816, 256, 64), (1, 2048, 512)] + RAGGED_SHAPES)
def test_matmul_kernel_is_exact_on_exact_sums(cuda, m, k, n):
    """Small integers: every partial sum is exact in fp32, so the kernel and
    the plain version round the same value and agree bit for bit."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randint(-3, 4, (m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randint(-3, 4, (k, n), generator=gen, device=cuda).to(torch.bfloat16)
    got = tmm.matmul_bf16(x, w)
    torch.cuda.synchronize()
    assert torch.equal(got, tmm._matmul_plain(x, w))


@pytest.mark.gpu
@pytest.mark.parametrize('m,k,n,scale,shift', [(2048, 64, 32, 1.1, 0.1), (2048, 64, 32, 2.0, 0.0),
                                               (5000, 256, 64, 1.1, 0.1), (129, 40, 24, 0.7, -0.2),
                                               (1, 8, 8, 1.1, 0.1), (1000, 40, 64, 1.1, 0.1),
                                               (3000, 72, 64, 0.9, 0.05), (777, 200, 72, 1.1, 0.1),
                                               (1000, 72, 136, 1.1, 0.1),
                                               (2048, 200, 264, 1.0, -0.1)])
def test_bn_relu_matmul_stats_kernel_equals_plain(cuda, m, k, n, scale, shift):
    """Rows past M (the last tile holds m % 128 of its 128) add nothing to
    the statistics, K past a 64-deep stage (40, 72, 200) and N past a column
    tile (72, 136, 264) are right, and two runs give the same bits."""
    x, w = _matmul_inputs(cuda, m, k, n, seed=1)
    gen = torch.Generator(device=cuda).manual_seed(2)
    scale_v = scale * (1 + 0.1 * torch.rand(k, generator=gen, device=cuda))
    shift_v = shift + 0.1 * torch.rand(k, generator=gen, device=cuda)
    y, s, ss = tmm.bn_relu_matmul_stats(x, w, scale_v, shift_v)
    y2, s2, ss2 = tmm.bn_relu_matmul_stats(x, w, scale_v, shift_v)
    torch.cuda.synchronize()
    assert torch.equal(y, y2) and torch.equal(s, s2) and torch.equal(ss, ss2)
    want_y, want_s, want_ss = tmm._bn_relu_matmul_stats_plain(x, w, scale_v, shift_v)
    z = torch.relu(x.float() * scale_v + shift_v).to(torch.bfloat16).float()
    _assert_bf16_close(y, want_y, z @ w.float().abs())
    abs_sum = (z @ w.float()).abs().sum(0)
    assert bool(((s - want_s).abs() <= 3e-6 * abs_sum).all())
    assert bool(((ss - want_ss).abs() <= 5e-6 * want_ss).all())


@pytest.mark.gpu
@pytest.mark.parametrize('m,k,n', [(2048, 64, 64), (129, 40, 24), (1000, 72, 136),
                                   (300, 200, 264), (1, 8, 8), (16, 8200, 16)])
def test_bn_relu_matmul_stats_kernel_is_exact_on_exact_sums(cuda, m, k, n):
    """Integers in [-3, 3], scale 2, shift 0: z, every product and every
    partial sum of y32, s and ss is an integer below 2^24, exact in fp32 in
    any order, so y, s and ss equal the plain version's bit for bit; K
    bounded by no shared memory (8200)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    x = torch.randint(-3, 4, (m, k), generator=gen, device=cuda).to(torch.bfloat16)
    w = torch.randint(-3, 4, (k, n), generator=gen, device=cuda).to(torch.bfloat16)
    scale, shift = torch.full((k,), 2.0, device=cuda), torch.zeros(k, device=cuda)
    got = tmm.bn_relu_matmul_stats(x, w, scale, shift)
    want = tmm._bn_relu_matmul_stats_plain(x, w, scale, shift)
    torch.cuda.synchronize()
    assert float(want[2].max()) < 2 ** 24
    for g, v in zip(got, want):
        assert torch.equal(g, v)


@pytest.mark.gpu
@pytest.mark.parametrize('m', [802816, 801816])
def test_bn_relu_matmul_stats_against_float64_sums(cuda, m):
    """s and ss against the column sums of y and y^2 taken in float64 from
    the bf16 z and w (each product exact in float64), at fused_mm_proto's
    shape and a ragged M: the kernel's and the fp32 plain version's errors
    (printed), the kernel's within K3_S_TOL64 of the column's sum of |y| and
    K3_SS_TOL64 relative."""
    k, n = 256, 64
    x, w = _matmul_inputs(cuda, m, k, n)
    scale, shift = torch.full((k,), 1.1, device=cuda), torch.full((k,), 0.1, device=cuda)
    _, s, ss = tmm.bn_relu_matmul_stats(x, w, scale, shift)
    _, plain_s, plain_ss = tmm._bn_relu_matmul_stats_plain(x, w, scale, shift)
    z = torch.relu(x.float() * scale + shift).to(torch.bfloat16)
    y64 = z.double() @ w.double()
    s64, ss64, abs64 = y64.sum(0), y64.square().sum(0), y64.abs().sum(0)
    errors = {name: (float(((a.double() - s64).abs() / abs64).max()),
                     float(((b.double() - ss64).abs() / ss64).max()))
              for name, (a, b) in (('kernel', (s, ss)), ('plain', (plain_s, plain_ss)))}
    print('M=%d against float64 sums: %s' % (m, errors))
    assert errors['kernel'][0] <= K3_S_TOL64 and errors['kernel'][1] <= K3_SS_TOL64


@pytest.mark.gpu
def test_matmul_wrappers_count_launches_and_reject_bad_inputs(cuda):
    tmm.reset_counters()
    x, w = _matmul_inputs(cuda, 256, 64, 64)
    scale = torch.ones(64, device=cuda)
    tmm.matmul_bf16(x, w)
    tmm.bn_relu_matmul_stats(x, w, scale, torch.zeros(64, device=cuda))
    assert tmm.counters() == {'matmul_bf16': 1, 'bn_relu_matmul_stats': 1, 'plain': 0}
    with pytest.raises(ValueError):
        tmm.matmul_bf16(x.float(), w)
    with pytest.raises(ValueError):
        tmm.matmul_bf16(x.reshape(-1)[4:4 + 6400].reshape(100, 64), w)  # 8-byte aligned
    with pytest.raises(ValueError):
        tmm.bn_relu_matmul_stats(x, w, scale.cpu(), scale)


@pytest.mark.gpu
@pytest.mark.parametrize('bits', [2, 4, 8, 16, 32])
@pytest.mark.parametrize('select', [False, True])
@pytest.mark.parametrize('shape,dtype', [((8, 64, 56, 56), torch.bfloat16),
                                         ((1025,), torch.float32),
                                         ((3, 3, 64, 64), torch.float32),
                                         ((2049,), torch.bfloat16)])
def test_global_range_route_equals_fused_kernel_and_plain(cuda, bits, select, shape, dtype):
    """K1''s global-range route (pass 1 alone, the pair all-reduced, pass 2
    from it) at world size 1 equals the fused kernel bit for bit; pass 1
    gives (-min, max); pass 2 from a given range that holds every element
    equals the plain version from that range."""
    x = _inputs(cuda, shape, dtype)
    b = torch.tensor(float(bits), device=cuda)
    tfq.reset_counters()
    got = tfq.fake_quant_per_tensor_global(x, b, select)
    assert tfq.counters()['fake_quant_per_tensor_global'] == 1
    assert torch.equal(got, tfq.fake_quant_per_tensor(x, b, select))
    lo, hi = torch.aminmax(x.float())
    if not (select and bits >= 32):
        assert torch.equal(tfq.tensor_minmax(x, b, select), torch.stack([-lo, hi]))
    # a range wider than x's on both sides (pass 2 takes a range that holds
    # every element, as the global one does)
    neg_range = torch.stack([-(lo - 0.5), hi + 0.25])
    want = tfq._quantize_in_range(x.float(), tfq._levels(b), -neg_range[0],
                                  neg_range[1]).to(dtype)
    if select:
        want = torch.where(b < 32, want, x)
    assert torch.equal(tfq.tensor_from_range(x, b, neg_range, select), want)
